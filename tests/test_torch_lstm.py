"""The port's LSTM recurrence (autovc_tpu_torch.ops.lstm) against the JAX
package's: the Pallas sequence kernel in interpret mode and the lax.scan of
models.layers. The CUDA kernel is held against the plain version on a card
in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from autovc_tpu.models.layers import _lstm_scan
from autovc_tpu.ops.pallas_lstm import lstm_sequence as jax_lstm_sequence
from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import lstm as lstm_ops

torch.set_num_threads(1)

ATOL = 1e-5  # f32 on both sides, as tests/test_ops.py holds the Pallas kernel


def _inputs(seed, b, t, hidden):
    rng = np.random.RandomState(seed)
    xproj = (rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)
    bound = 1.0 / np.sqrt(hidden)
    w_hh = rng.uniform(-bound, bound, (hidden, 4 * hidden)).astype(np.float32)
    return xproj, w_hh


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [32, 128])
def test_ref_matches_jax_pallas_interpret(hidden, reverse):
    """T=140 with chunk=128: the JAX kernel carries (h, c) across a chunk
    boundary; the port has no chunks."""
    xproj, w_hh = _inputs(0, 4, 140, hidden)
    want = jax_lstm_sequence(jnp.asarray(xproj), jnp.asarray(w_hh), reverse=reverse,
                             interpret=True, chunk=128)
    got = lstm_ops.lstm_sequence_ref(torch.from_numpy(xproj), torch.from_numpy(w_hh), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [32, 128])
def test_ref_matches_jax_scan(hidden, reverse):
    xproj, w_hh = _inputs(1, 4, 140, hidden)
    zeros = jnp.zeros((4, hidden), jnp.float32)
    want = _lstm_scan(jnp.asarray(xproj), jnp.asarray(w_hh), zeros, zeros, reverse=reverse)
    got = lstm_ops.lstm_sequence_ref(torch.from_numpy(xproj), torch.from_numpy(w_hh), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_reverse_is_forward_on_flipped_time():
    xproj, w_hh = _inputs(2, 3, 17, 8)
    x, w = torch.from_numpy(xproj), torch.from_numpy(w_hh)
    rev = lstm_ops.lstm_sequence_ref(x, w, reverse=True)
    fwd_flipped = lstm_ops.lstm_sequence_ref(x.flip(1), w).flip(1)
    torch.testing.assert_close(rev, fwd_flipped, atol=0, rtol=0)


def test_cpu_tensor_takes_plain_version_without_counting():
    xproj, w_hh = _inputs(3, 2, 9, 16)
    x, w = torch.from_numpy(xproj), torch.from_numpy(w_hh)
    before = lstm_ops.launches
    got = lstm_ops.lstm_sequence(x, w, reverse=True)
    torch.testing.assert_close(got, lstm_ops.lstm_sequence_ref(x, w, reverse=True), atol=0, rtol=0)
    assert lstm_ops.launches == before


def test_other_device_raises():
    x = torch.empty((2, 3, 32), device="meta")
    w = torch.empty((8, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lstm_ops.lstm_sequence(x, w)


@pytest.mark.parametrize(
    "xshape, wshape, dtype, error",
    [
        ((2, 3, 32), (8, 32), torch.float64, TypeError),  # kernel is float32 only
        ((2, 3, 32), (8, 16), torch.float32, ValueError),  # w_hh is not (H, 4H)
        ((2, 3, 24), (6, 24), torch.float32, ValueError),  # H % 8 != 0: padded, then CPU tensors
        # w_hh beyond the card's shared memory is regime (c)'s, so only the
        # device check (these are CPU tensors) refuses it
        ((2, 3, 8192), (2048, 8192), torch.float32, (ValueError, "one CUDA device")),
    ],
)
def test_kernel_wrapper_rejects_before_building(xshape, wshape, dtype, error):
    """The wrapper validates its inputs before it builds or launches."""
    error, match = error if isinstance(error, tuple) else (error, None)
    with pytest.raises(error, match=match):
        lstm_ops.lstm_sequence_cuda(torch.zeros(xshape, dtype=dtype), torch.zeros(wshape, dtype=dtype))


@pytest.mark.parametrize("batch", [1, 7, 32, 37])
@pytest.mark.parametrize("hidden", [8, 32, 64, 256, 512, 768, 1024])
def test_launch_plan(hidden, batch):
    """Regime (a), one block per batch tile with all of w_hh, up to H=64 of
    the package's widths; (b), at most one block per SM with a slice of
    w_hh each, from H=256. Each plan fits a block's shared memory and
    covers every batch row and unit, in tiles that follow B."""
    for kind in ("fwd", "bwd"):
        plan = lstm_ops.launch_plan(batch, hidden, kind)
        assert plan.kind == kind and plan.regime == ("a" if hidden <= 64 else "b")
        assert plan.smem <= 232_448 and plan.smem == lstm_ops._smem(kind, plan.regime, hidden, plan.units,
                                                                    plan.rows, plan.kc)
        assert plan.rows % 4 == 0 and plan.rows <= -(-batch // 4) * 4
        if plan.regime == "a":
            assert plan.units == hidden and plan.blocks * plan.rows >= batch and plan.kc == 0
        else:
            assert plan.blocks <= 132 and plan.blocks * plan.units == hidden and plan.rows <= 32
            assert plan.kc % 32 == 0 and 0 < plan.kc < (hidden if kind == "fwd" else 4 * hidden) + 32
        # the threads hold every product task and every (row, unit) pair, 4 a thread
        assert plan.rows // 4 * plan.units <= lstm_ops.THREADS


def test_launch_plan_follows_batch_and_card():
    """B=7 takes 8-row tiles, not 32; regime (a) spreads the batch over the
    SMs, 4 rows a block; a card with fewer SMs gets more units a block; one
    step past the widest H whose slices fit shared memory, regime (c)
    streams what does not, with the same blocks."""
    assert lstm_ops.launch_plan(7, 1024).rows == 8 and lstm_ops.launch_plan(32, 1024).rows == 32
    assert lstm_ops.launch_plan(7, 32).blocks == 2 and lstm_ops.launch_plan(64, 64).blocks == 16
    assert lstm_ops.launch_plan(600, 32).rows == 8 and lstm_ops.launch_plan(600, 32, sms=150).rows == 4
    assert lstm_ops.launch_plan(7, 512, sms=114).units == 8 and lstm_ops.launch_plan(7, 512).units == 4
    slim = lstm_ops.launch_plan(7, 1024, sms=114)  # 16 units a block: 256 KB of w_hh
    assert (slim.regime, slim.blocks, slim.units) == ("c", 64, 16) and 0 < slim.kres < 1024
    widest = max(h for h in range(8, 1400, 8) if lstm_ops.launch_plan(7, h, "bwd").regime != "c")
    assert lstm_ops.launch_plan(7, widest, "fwd").regime == "b"
    beyond = lstm_ops.launch_plan(7, widest + 8, "bwd")
    assert beyond.regime == "c" and beyond.kres % beyond.kc == 0 and beyond.kres < 4 * (widest + 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_ops._check(torch.zeros(7, 2, 4 * (widest + 8)), torch.zeros(widest + 8, 4 * (widest + 8)))


def test_gates_ref_is_the_forward_cell():
    """The gate activations the backward takes (i, f, g, o after sigmoid and
    tanh) rebuild the plain forward's c and h step by step."""
    xproj, w_hh = _inputs(6, 3, 11, 16)
    x, w = torch.from_numpy(xproj), torch.from_numpy(w_hh)
    h0, c0 = torch.randn(3, 16), torch.randn(3, 16)
    for reverse in (False, True):
        h_seq, c_seq, _, _ = lstm_ops.lstm_sequence_train_ref(x, w, h0, c0, reverse)
        si, sf, tg, so = lstm_ops.lstm_gates_ref(x, w, h0, h_seq, reverse).split(16, dim=-1)
        c_prev = lstm_ops._hprev(c_seq, c0, reverse)
        torch.testing.assert_close(sf * c_prev + si * tg, c_seq, atol=1e-6, rtol=0)
        torch.testing.assert_close(so * torch.tanh(c_seq), h_seq, atol=1e-6, rtol=0)


def test_library_path_keyed_by_source_and_flags():
    path = _build.library_path("lstm_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("lstm_fwd-") and path.suffix == ".so"
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS and "-shared" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("lstm_fwd")
    assert not (tmp_path / "kernels").exists()


def test_build_starts_one_compiler_per_source(monkeypatch, tmp_path):
    """build() runs every missing source's compiler at once and installs each
    library under its keyed name; a second call compiles nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" >> "%s"\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\necho "ptxas info : Used 40 registers"\n' % log)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    _build.build(["lstm_fwd", "wavenet_gen", "lstm_fwd"])
    assert len(log.read_text().splitlines()) == 2
    for name in ("lstm_fwd", "wavenet_gen"):
        assert _build.library_path(name).read_text() == "built\n"
        assert "registers" in _build.build_log[name]
    _build.build(["lstm_fwd", "wavenet_gen"])
    assert len(log.read_text().splitlines()) == 2
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == sorted(
        _build.library_path(n).name for n in ("lstm_fwd", "wavenet_gen"))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch, time", [(1, 1), (1, 5), (7, 128), (3, 37), (32, 512), (1, 8192)])
@pytest.mark.parametrize("hidden", [8, 32, 64, 256, 512, 768, 1024])
def test_dw_plan_covers_k_once(hidden, batch, time, sms):
    """The dW plan's chunks are whole K tiles and cover the B*T rows exactly
    once, none empty; K is split only where the output tiles leave resident
    blocks idle, and then at most DW_MAX_SPLITS ways, each chunk at least
    DW_MIN_K_TILES tiles unless K is shorter; the workspace holds one
    partial dW a split."""
    plan = lstm_ops.dw_plan(batch, time, hidden, sms)
    k = batch * time
    tiles = plan.tiles_m * plan.tiles_n
    assert (plan.tiles_m, plan.tiles_n) == (-(-hidden // 128), -(-4 * hidden // 128))
    assert plan.chunk % lstm_ops.DW_K_TILE == 0 and plan.chunk > 0
    assert (plan.splits - 1) * plan.chunk < k <= plan.splits * plan.chunk
    assert 1 <= plan.splits <= lstm_ops.DW_MAX_SPLITS
    if plan.splits > 1:
        assert tiles * plan.splits <= lstm_ops.DW_BLOCKS_PER_SM * sms
        assert plan.chunk >= lstm_ops.DW_MIN_K_TILES * lstm_ops.DW_K_TILE
        assert plan.workspace == plan.splits * hidden * 4 * hidden
    else:
        assert plan.workspace == 0
    assert plan.blocks == tiles * plan.splits


def test_dw_plan_at_the_training_shapes():
    """B=7, T=128 (K = 896): H=32 one tile, K in 14 chunks of 64 rows;
    H=512 64 tiles, 4 chunks; H=1024 256 tiles, no split."""
    got = [(p.splits, p.chunk) for p in (lstm_ops.dw_plan(7, 128, h) for h in (32, 512, 1024))]
    assert got == [(14, 64), (4, 224), (1, 896)]


def test_dw_wrapper_refuses_before_building(monkeypatch):
    """lstm_weight_grad_cuda checks its inputs (CPU tensors here) before it
    builds or plans on a card."""
    monkeypatch.setattr(lstm_ops._build, "load", lambda name: pytest.fail("built the kernel"))
    h_seq, dx = torch.zeros(2, 3, 32), torch.zeros(2, 3, 128)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_ops.lstm_weight_grad_cuda(h_seq, None, dx)
    with pytest.raises(ValueError, match="h_seq is"):
        lstm_ops.lstm_weight_grad_cuda(torch.zeros(2, 4, 32), None, dx)


@pytest.mark.parametrize("batch, time", [(1, 1), (7, 128), (1, 200), (7, 127), (64, 512)])
@pytest.mark.parametrize("hidden", [8, 32, 256, 512, 768, 1024])
def test_gates_plan_tiles_cover_the_product(hidden, batch, time):
    """The gates kernel's blocks: one a (batch row, 128 steps, 128 x nsub
    columns) tile, every (b, t) and column of 4H covered once; 128 x 256
    tiles only where they still make GATES_WIDE_BLOCKS blocks."""
    plan = lstm_ops.gates_plan(batch, time, hidden)
    rows = batch * -(-time // lstm_ops.GATES_ROWS)
    cols = -(-4 * hidden // (plan.nsub * lstm_ops.GATES_COLS))
    assert plan.nsub in (1, 2) and plan.blocks == rows * cols
    assert (plan.nsub == 2) == (rows * -(-4 * hidden // (2 * lstm_ops.GATES_COLS)) >= lstm_ops.GATES_WIDE_BLOCKS)


def test_gates_plan_at_the_training_shapes():
    """B=7, T=128: H=32 seven 128 x 128 tiles; H=512 112; H=1024 112 of
    128 x 256."""
    got = [lstm_ops.gates_plan(7, 128, h) for h in (32, 512, 1024)]
    assert [(p.nsub, p.blocks) for p in got] == [(1, 7), (1, 112), (2, 112)]


def test_scan_wrappers_refuse_before_building(monkeypatch):
    """The scan forms' wrappers check their inputs (CPU tensors here, a
    float32 form, a float32 state) before they build anything; the
    autograd Function refuses the scan rounding in float32."""
    monkeypatch.setattr(lstm_ops._build, "load", lambda name: pytest.fail("built the kernel"))
    bf = torch.bfloat16
    x, w = torch.zeros(2, 3, 128, dtype=bf), torch.zeros(32, 128, dtype=bf)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_ops.lstm_scan_forward_cuda(x, w)
    with pytest.raises(TypeError, match="bfloat16 xproj"):
        lstm_ops.lstm_scan_forward_cuda(x.float(), w.float())
    with pytest.raises(TypeError, match="h0 is bfloat16"):
        lstm_ops.lstm_scan_forward_cuda(x, w, h0=torch.zeros(2, 32))
    act, c_seq, dy = torch.zeros(2, 3, 128), torch.zeros(2, 3, 32), torch.zeros(2, 3, 32, dtype=bf)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_ops.lstm_scan_backward_cuda(w, act, c_seq, None, dy)
    with pytest.raises(TypeError, match="residuals"):
        lstm_ops.lstm_scan_backward_cuda(w, act.to(bf), c_seq, None, dy)
    with pytest.raises(TypeError, match="bfloat16 form"):
        lstm_ops.LSTMSequenceFn.apply(x.float(), w.float(), None, None, False, True)


def test_scan_function_on_the_cpu_is_the_plain_pair():
    """``LSTMSequenceFn`` with ``scan`` on CPU tensors runs the scan
    rounding's plain forward and backward: its outputs and gradients equal
    ``lstm_scan_bf16_train_ref`` and ``lstm_scan_bf16_backward_ref`` bit for
    bit, bfloat16, with a bfloat16 h0 and c0; a w_hh that requires grad
    gets ``lstm_scan_bf16_weight_grad_ref`` on them, bit for bit."""
    bf = torch.bfloat16
    rng = np.random.RandomState(7)
    x, h0, c0 = (torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).to(bf)
                 for s in [(3, 9, 64), (3, 16), (3, 16)])
    w = torch.from_numpy(rng.uniform(-0.25, 0.25, (16, 64)).astype(np.float32)).to(bf)
    dy = torch.from_numpy(rng.randn(3, 9, 16).astype(np.float32)).to(bf)
    for reverse in (False, True):
        leaves = [v.clone().requires_grad_() for v in (x, h0, c0)]
        h_seq, hn, cn = lstm_ops.LSTMSequenceFn.apply(leaves[0], w, leaves[1], leaves[2], reverse, True)
        h_seq.backward(dy)
        fwd = lstm_ops.lstm_scan_bf16_train_ref(x, w, h0, c0, reverse)
        bwd = lstm_ops.lstm_scan_bf16_backward_ref(w, fwd[2], fwd[1], c0, dy, torch.zeros_like(h0),
                                                   torch.zeros_like(c0), reverse)
        for got, want in zip([h_seq, hn, cn] + [v.grad for v in leaves], [fwd[0], fwd[3], fwd[4], *bwd]):
            assert got.dtype == want.dtype == bf and torch.equal(got, want)
    trained = w.clone().requires_grad_()
    lstm_ops.LSTMSequenceFn.apply(x, trained, h0, c0, False, True)[0].backward(dy)
    fwd = lstm_ops.lstm_scan_bf16_train_ref(x, w, h0, c0)
    dx = lstm_ops.lstm_scan_bf16_backward_ref(w, fwd[2], fwd[1], c0, dy)[0]
    want = lstm_ops.lstm_scan_bf16_weight_grad_ref(fwd[0], h0, dx)
    assert trained.grad.dtype == bf and torch.equal(trained.grad, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_refs_stack_problems_as_each_alone(reverse):
    """The scan rounding's plain forward and backward on stacked problems
    (leading dims on every argument, h0 and c0 too) give each problem's
    outputs bit for bit as the unstacked call does."""
    bf = torch.bfloat16
    rng = np.random.RandomState(8)
    x, dy = (torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).to(bf) for s in [(3, 2, 9, 64), (3, 2, 9, 16)])
    w = torch.from_numpy(rng.uniform(-0.25, 0.25, (3, 16, 64)).astype(np.float32)).to(bf)
    h0, c0 = (torch.from_numpy((rng.randn(3, 2, 16) * 0.5).astype(np.float32)).to(bf) for _ in range(2))
    fwd = lstm_ops.lstm_scan_bf16_train_ref(x, w, h0, c0, reverse)
    bwd = lstm_ops.lstm_scan_bf16_backward_ref(w, fwd[2], fwd[1], c0, dy, reverse=reverse)
    for r in range(3):
        alone = lstm_ops.lstm_scan_bf16_train_ref(x[r], w[r], h0[r], c0[r], reverse)
        alone_bwd = lstm_ops.lstm_scan_bf16_backward_ref(w[r], alone[2], alone[1], c0[r], dy[r], reverse=reverse)
        for got, want in zip([o[r] for o in fwd + bwd], alone + alone_bwd):
            assert got.dtype == want.dtype == bf and torch.equal(got, want)
