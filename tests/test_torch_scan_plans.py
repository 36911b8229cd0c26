"""The launch plans of the scan rounding's training kernels, on the CPU: the
scan backward's (``ops.lstm.scan_bwd_plan``, ``csrc/lstm_scan_bwd.cu``) and
the scan dW's (``ops.lstm.scan_dw_plan``, ``csrc/lstm_scan_dw.cu``). The
kernels run only on the card (``tests/test_torch_gpu.py``); their plans are
plain Python, checked here at every shape the port runs them at: the
Generator's training sequences (B=7, T=128, H = 32, 512, 1024), the frozen
d-vector's (T=128, H = 768 and 256 at B = 1, 7, 8) and the card tests'
shapes."""

from __future__ import annotations

import pytest
import torch

from autovc_tpu_torch.ops import lstm as lstm_ops
from test_torch_gpu import SCAN_DW_SHAPES, SCAN_SHAPES

torch.set_num_threads(1)

GENERATOR = [(7, 128, h) for h in (32, 512, 1024)]
DVECTOR = [(b, 128, h) for h in (768, 256) for b in (1, 7, 8)]
SMS = lstm_ops.SMS


@pytest.mark.parametrize("b, t, hidden", sorted(set(GENERATOR + DVECTOR + SCAN_SHAPES)))
def test_scan_bwd_plan_fits_every_shape(b, t, hidden):
    """A plan at every shape, in the shared memory a block may use, laid out
    as the kernel lays it out; regime (a) up to H=32 (8 batch rows a block),
    regime (b) 8 units a block, at most one block an SM, batch tiles of 8
    rows up to B=8, else 16."""
    plan = lstm_ops.scan_bwd_plan(b, hidden, SMS)
    assert plan is not None and plan.smem <= lstm_ops.SMEM_MAX
    assert plan.smem == lstm_ops._scan_bwd_smem(plan.regime, b, hidden, plan.rows)
    if hidden <= 32:
        assert (plan.regime, plan.blocks, plan.units, plan.rows) == ("a", -(-b // 8), hidden, 8)
    else:
        assert (plan.regime, plan.units, plan.rows) == ("b", 8, 8 if b <= 8 else 16)
        assert plan.blocks == hidden // 8 <= SMS


def test_scan_bwd_plan_regime_b_one_block_an_sm():
    """Regime (b) stays at one persistent block an SM: H / 8 blocks, none
    where they would outnumber the SMs or where a warp's eighth of K would
    hold more than 32 k16 steps' fragments (H > 1024): there regime (c)
    takes 16 units a block (H=1032 padded to 1040: 65 blocks); H % 8 != 0
    is planned at the padded width (36 -> 40). The Generator's H=1024 at
    B=7: 128 blocks of 71,056 bytes."""
    assert lstm_ops.scan_bwd_plan(7, 1024, SMS) == lstm_ops.ScanBwdPlan("b", 128, 8, 8, 71_056)
    assert lstm_ops.scan_bwd_plan(7, 1024, 127).regime == "c"
    assert lstm_ops.scan_bwd_plan(7, 512, 64).blocks == 64
    wide = lstm_ops.scan_bwd_plan(7, 1032, SMS)
    assert (wide.regime, wide.blocks, wide.units, wide.rows) == ("c", 65, 16, 8)
    assert lstm_ops.scan_bwd_plan(7, 36, SMS) == lstm_ops.scan_bwd_plan(7, 40, SMS)
    assert lstm_ops.scan_bwd_plan(0, 64, SMS) is None


def test_scan_bwd_plan_absent_where_the_forward_takes_16_units():
    """On a card of fewer SMs than H / 8 the forward plans 16 units a block
    and so does the backward, in regime (c) (its regime (b) takes 8):
    ``lstm_scan_forward_cuda`` checks it with ``with_residuals``;
    ``tests/test_torch_gpu.py`` runs both on the card. Where even H / 16
    blocks outnumber the SMs, neither has a plan."""
    assert lstm_ops.scan_plan(7, 1024, 100).units == 16
    assert lstm_ops.scan_bwd_plan(7, 1024, 100).units == 16
    assert lstm_ops.scan_bwd_plan(7, 512, 100) is not None
    assert lstm_ops.scan_plan(7, 1024, 60) is None and lstm_ops.scan_bwd_plan(7, 1024, 60) is None


@pytest.mark.parametrize("b, t, hidden", sorted(set(GENERATOR + DVECTOR + SCAN_DW_SHAPES)))
def test_scan_dw_plan_fits_every_shape(b, t, hidden):
    """A plan at every shape, in SCAN_DW_SMEM (two blocks an SM) and so in
    the shared memory a block may use, laid out as the kernel lays it out; a
    grid of the patch's tiles over (H, 4H); a step's batch in slabs of at
    most SCAN_DW_MAX_ROWS rows that cover B, more than one only in tiles of
    at most 128 columns; the slots a buffer at most the sequence's and
    SCAN_DW_MAX_SLOTS."""
    plan = lstm_ops.scan_dw_plan(b, t, hidden, SMS)
    assert plan is not None and plan.smem <= lstm_ops.SCAN_DW_SMEM <= lstm_ops.SMEM_MAX // 2
    assert plan.smem == lstm_ops._scan_dw_smem(plan.rows, plan.mi, plan.nj, plan.slots)
    assert (plan.mi, plan.nj) in lstm_ops.SCAN_DW_PATCHES
    tiles = -(-hidden // (8 * plan.mi)) * -(-4 * hidden // (32 * plan.nj))
    assert plan.blocks == tiles and plan.warps == tiles * lstm_ops.SCAN_DW_WARPS
    assert plan.rows <= lstm_ops.SCAN_DW_MAX_ROWS and plan.slabs == -(-b // plan.rows)
    assert plan.slabs == 1 or plan.nj <= 4
    assert 1 <= plan.slots <= min(t * plan.slabs, lstm_ops.SCAN_DW_MAX_SLOTS)


def test_scan_dw_plan_fills_the_card():
    """At the Generator's H=32, B=7 the outputs spread over 16 blocks of 4
    warps, an 8 x 32 tile a block, two outputs a thread (the replaced
    kernel: 2 blocks of 64 x 64); at 512 and 1024 the largest tile that
    still gives each of the card's 4 x 132 sub-partitions a warp."""
    assert lstm_ops.scan_dw_plan(7, 128, 32, SMS) == lstm_ops.ScanDwPlan(1, 1, 7, 1, 16, 64, 32, 41_104)
    assert lstm_ops.scan_dw_plan(7, 128, 32, SMS).blocks > 2
    for hidden, want in ((1024, (8, 8, 256, 1024)), (512, (4, 4, 256, 1024))):
        plan = lstm_ops.scan_dw_plan(7, 128, hidden, SMS)
        assert (plan.mi, plan.nj, plan.blocks, plan.warps) == want
    # 64 x 256 tiles at H=512 would leave sub-partitions without a warp
    assert -(-512 // 64) * -(-2048 // 256) * lstm_ops.SCAN_DW_WARPS < 4 * SMS


def test_scan_dw_plan_refusals():
    """No plan for an empty batch or sequence; H % 8 != 0 is planned at the
    padded width (36 -> 40); a card of fewer SMs takes a tile no smaller."""
    assert lstm_ops.scan_dw_plan(7, 128, 36, SMS) == lstm_ops.scan_dw_plan(7, 128, 40, SMS)
    assert lstm_ops.scan_dw_plan(0, 128, 64, SMS) is None
    assert lstm_ops.scan_dw_plan(7, 0, 64, SMS) is None
    assert lstm_ops.scan_dw_plan(7, 128, 512, 32).mi >= lstm_ops.scan_dw_plan(7, 128, 512, SMS).mi


@pytest.mark.parametrize("hidden", [8, 32, 256, 512, 768, 1024])
def test_scan_dw_plan_takes_every_batch(hidden):
    """Every batch the kernel it replaced took has a plan (that kernel
    staged any B in chunks of rows): a step's batch as one box where it
    fits a box and two buffers' bytes, in the widest tile that holds it;
    else as slabs."""
    for b in list(range(1, 400)) + [511, 640, 1000, 1500, 4096]:
        plan = lstm_ops.scan_dw_plan(b, 16, hidden, SMS)
        assert plan is not None and plan.smem <= lstm_ops.SCAN_DW_SMEM
        assert plan.rows * plan.slabs >= b > plan.rows * (plan.slabs - 1)
        assert plan.slabs == 1 or plan.nj <= 4
        if b <= lstm_ops.SCAN_DW_MAX_ROWS and lstm_ops._scan_dw_smem(b, plan.mi, plan.nj, 1) <= lstm_ops.SCAN_DW_SMEM:
            assert plan.slabs == 1


@pytest.mark.parametrize("b, want", [(79, (8, 8, 79, 1)), (80, (4, 4, 80, 1)), (96, (4, 4, 96, 1)),
                                     (300, (4, 4, 150, 2)), (640, (4, 4, 128, 5))])
def test_scan_dw_plan_large_batches_at_h1024(b, want):
    """At H=1024 one box a step fits the 64 x 256 tile up to B=79 and the 32
    x 128 tile from B=80; past a box's 256 rows or two buffers' bytes the
    step's batch is split into the fewest slabs of equal rows."""
    plan = lstm_ops.scan_dw_plan(b, 128, 1024, SMS)
    assert (plan.mi, plan.nj, plan.rows, plan.slabs) == want
