"""Autoregressive WaveNet generation: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``autovc_tpu/ops/pallas_wavenet.py::generate_pallas`` (both
ring variants) and of the eager scan ``_generate_scan`` in
``autovc_tpu/vocoder/wavenet.py``. For each output sample t and each layer
with dilation d, the layer input h and the ring of the layer's last 2d inputs
give

    gates = [x(t-2d), x(t-d), h] @ w3 + cond_t @ wcond + bias      (B, G)
    z     = tanh(gates[:, :G/2]) * sigmoid(gates[:, G/2:])
    skip  = (skip + z @ wskip + b_skip) * sqrt(0.5)
    h     = (h + z @ wout + b_out) * sqrt(0.5)

where ring slot ``t mod 2d`` holds x(t-2d), slot ``(t+d) mod 2d`` holds
x(t-d), and the layer input is stored into slot ``t mod 2d`` after both reads.
The first layer's input is ``x_prev * fk + fb``; after the last layer the MoL
head (relu -> last1 -> relu -> last2) gives the logits and
``sample_from_mol_uniforms`` draws x_t from the caller's uniforms. Rings start
at zero and x_prev at t=0 is 0.

``generate`` launches the kernel in ``csrc/wavenet_gen.cu`` for a CUDA tensor
and runs ``generate_ref`` for a CPU tensor; there is no fallback from one to
the other. The kernel is one persistent cooperative launch per call;
``generate_plan`` chooses, in plain Python, its blocks, the columns each block
owns and the depth of its weight ring.

bfloat16 weights (``pack_weights(..., dtype=torch.bfloat16)``) run in one of
the JAX package's two bfloat16 roundings, by its engine names:

- ``scan=False``, the Pallas engine's (what ``pallas_wavenet.pack_weights``
  makes by default and ``engine="pallas"`` runs): w3, wcond, wout and wskip
  in bfloat16, the biases, the first conv and the head in float32, and the
  rounding points of ``pallas_wavenet.py:74-127``: the layer input h is
  rounded to bfloat16 for the gate and the ring, cond is rounded, z is
  rounded; the products are exact products of bfloat16 values summed in
  float32; the (h, skip) accumulators stay float32 (h unrounded).
- ``scan=True``, the scan engine's (``_generate_scan(dtype=bfloat16)``,
  ``autovc_tpu/vocoder/wavenet.py:244-310``, what ``engine="scan"``, the
  default, runs): every weight, bias and the first conv in bfloat16, h and
  the skip sum bfloat16 values, every op rounded as XLA:CPU rounds it under
  ``jit`` (read from the compiled HLO: each dot of two bfloat16 operands is
  a float32 dot converted to bfloat16, each elementwise op converted back
  to bfloat16, ``sqrt(0.5)`` a bfloat16 constant, 0.70703125):

      h_0   = rb(rb(rb(x_prev) * fk) + fb)
      gates = rb(rb(rb(rb(d(x(t-2d), w_prev2) + d(x(t-d), w_prev1)) + d(h, w_cur)) + bg) + d(cond_t, w_cond))
      z     = rb(rb(tanh(a)) * sigmoid(b))      sigmoid(x) = rb(1 / rb(1 + rb(exp(-x))))
      skip  = rb(rb(skip + rb(d(z, wskip) + bs)) * c)
      h     = rb(rb(h + rb(d(z, wout) + bo)) * c)       c = 0.70703125

  with d(x, w) = rb(x @ w) and rb rounding to bfloat16; the ring takes h
  (already bfloat16), cond is rounded, and the head is float32 on
  relu(skip), as JAX casts the skip sum to float32 before it.

The kernel's bfloat16 form and scan form, and ``generate_ref``, follow them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Mapping, Sequence

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops.lstm import _rb, _sigmoid_scan  # the scan rounding's ops, as the LSTM's

SQRT_HALF = math.sqrt(0.5)
LOG_SCALE_MIN = -32.23619130191664
U_MIN, U_MAX = 1e-5, 1.0 - 1e-5

# Calls of generate that launched the CUDA kernel (one call = one utterance
# batch); those with bfloat16 weights count in bf16_launches too, or, in the
# scan rounding, in scan_launches. Callers reset them to 0 and read them back.
launches = 0
bf16_launches = 0
scan_launches = 0
# CUDA kernel launches made by the last call of generate_cuda: the plan's
# (one, for all T samples).
last_cuda_launches = 0
# The last launch: (plan, resident blocks per SM, SMs), for chip_smoke.py.
last_launch: tuple | None = None

PACKED_KEYS = ("w3", "wcond", "wout", "wskip", "bg", "bo", "bs", "fk", "fb", "l1k", "l1b", "l2k", "l2b")


def pack_weights(state: Mapping[str, torch.Tensor], n_layers: int,
                 dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """The WaveNet state dict (JAX names, ``layers.<i>.w_prev2`` ...) ->
    the kernel's layout, counterpart of ``pallas_wavenet.pack_weights``:
    w3 (L, 3R, G) = [w_prev2; w_prev1; w_cur], wcond (L, C, G), wout (L, G/2, R),
    wskip (L, G/2, S) in ``dtype`` (float32 here by default; the JAX
    function's default is bfloat16), biases bg (L, G), bo (L, R), bs (L, S),
    first conv fk, fb (R,), head l1k (S, S), l1b (S,), l2k (S, 3K), l2b (3K,)
    in float32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wavenet weights are float32 or bfloat16, not {dtype}")
    f32 = lambda key: state[key].detach().float()
    layer = lambda i, name: f32(f"layers.{i}.{name}")
    stack = lambda name: torch.stack([layer(i, name) for i in range(n_layers)]).contiguous()
    return {
        "w3": torch.stack([
            torch.cat([layer(i, "w_prev2"), layer(i, "w_prev1"), layer(i, "w_cur")]) for i in range(n_layers)
        ]).to(dtype).contiguous(),
        "wcond": stack("w_cond").to(dtype),
        "wout": stack("w_out").to(dtype),
        "wskip": stack("w_skip").to(dtype),
        "bg": stack("bias"),
        "bo": stack("b_out"),
        "bs": stack("b_skip"),
        "fk": f32("first_conv.kernel")[0].contiguous(),
        "fb": f32("first_conv.bias").contiguous(),
        "l1k": f32("last1.kernel").contiguous(),
        "l1b": f32("last1.bias").contiguous(),
        "l2k": f32("last2.kernel").contiguous(),
        "l2b": f32("last2.bias").contiguous(),
    }


def sample_from_mol_uniforms(logits: torch.Tensor, uniforms: torch.Tensor, log_scale_min: float) -> torch.Tensor:
    """Sample from MoL logits (..., 3K) given uniforms (..., K+1): Gumbel-max
    mixture choice (ties to the first index), then a logistic sample from the
    chosen mixture, clipped to [-1, 1]."""
    k = logits.shape[-1] // 3
    logit_probs, means = logits[..., :k], logits[..., k:2 * k]
    log_scales = torch.clamp(logits[..., 2 * k:], min=log_scale_min)
    u_sel = torch.clamp(uniforms[..., :k], U_MIN, U_MAX)
    u_x = torch.clamp(uniforms[..., k], U_MIN, U_MAX)
    sel = torch.argmax(logit_probs - torch.log(-torch.log(u_sel)), dim=-1, keepdim=True)
    mu = torch.gather(means, -1, sel)[..., 0]
    log_s = torch.gather(log_scales, -1, sel)[..., 0]
    x = mu + torch.exp(log_s) * (torch.log(u_x) - torch.log1p(-u_x))
    return torch.clamp(x, -1.0, 1.0)


SQRT_HALF_BF16 = 0.70703125  # bf16(sqrt(0.5)): the constant of the scan rounding


def scan_weights(packed: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """bfloat16 packed weights for the scan rounding: the biases and the
    first conv rounded to bfloat16 values (still float32 tensors, where the
    kernel reads them); the head stays float32."""
    if packed["w3"].dtype != torch.bfloat16:
        raise ValueError(f"the scan rounding takes bfloat16 packed weights, got {packed['w3'].dtype}")
    return {k: _rb(v).contiguous() if k in ("bg", "bo", "bs", "fk", "fb") else v for k, v in packed.items()}


def generate_ref(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
                 uniforms: torch.Tensor, log_scale_min: float = LOG_SCALE_MIN,
                 scan: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a Python loop over samples and layers in float32,
    with the bfloat16 rounding points where the packed weights are bfloat16
    (the layer input, cond and z rounded; products of the bfloat16 values
    summed in float32), or with ``scan`` (bfloat16 weights) those of the
    scan rounding (the module's notes). cond (B, T, C), uniforms (B, T, K+1)
    -> samples (B, T), logits (B, T, 3K)."""
    if scan:
        return _generate_scan_ref(scan_weights(packed), dilations, cond, uniforms, log_scale_min)
    b, t, _ = cond.shape
    dt = packed["w3"].dtype
    cond, uniforms = cond.float().to(dt).float(), uniforms.float()
    w3, wcond, wout, wskip = (packed[k].float() for k in ("w3", "wcond", "wout", "wskip"))
    r, g2, s = packed["fk"].shape[0], wout.shape[1], wskip.shape[-1]
    rings = [cond.new_zeros((b, 2 * d, r), dtype=dt) for d in dilations]
    x_prev = cond.new_zeros(b)
    ys, all_logits = [], []
    for step in range(t):
        h = x_prev[:, None] * packed["fk"] + packed["fb"]
        skip = cond.new_zeros((b, s))
        c_t = cond[:, step]
        for i, d in enumerate(dilations):
            slot, slot_d = step % (2 * d), (step + d) % (2 * d)
            h_in = h.to(dt)
            x_all = torch.cat([rings[i][:, slot], rings[i][:, slot_d], h_in], dim=-1).float()
            gates = x_all @ w3[i] + c_t @ wcond[i] + packed["bg"][i]
            z = (torch.tanh(gates[:, :g2]) * torch.sigmoid(gates[:, g2:])).to(dt).float()
            skip = (skip + (z @ wskip[i] + packed["bs"][i])) * SQRT_HALF
            new_h = (h + (z @ wout[i] + packed["bo"][i])) * SQRT_HALF
            rings[i][:, slot] = h_in
            h = new_h
        out = torch.relu(torch.relu(skip) @ packed["l1k"] + packed["l1b"])
        logits = out @ packed["l2k"] + packed["l2b"]
        x_prev = sample_from_mol_uniforms(logits, uniforms[:, step], log_scale_min)
        ys.append(x_prev)
        all_logits.append(logits)
    return torch.stack(ys, dim=1), torch.stack(all_logits, dim=1)


def _generate_scan_ref(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
                       uniforms: torch.Tensor, log_scale_min: float) -> tuple[torch.Tensor, torch.Tensor]:
    """generate_ref in the scan rounding, on ``scan_weights``' packing."""
    b, t, _ = cond.shape
    cond, uniforms = _rb(cond.float()), uniforms.float()
    w3, wcond, wout, wskip = (packed[k].float() for k in ("w3", "wcond", "wout", "wskip"))
    r, s = packed["fk"].shape[0], wskip.shape[-1]
    g2 = wout.shape[1]
    rings = [cond.new_zeros((b, 2 * d, r)) for d in dilations]
    x_prev = cond.new_zeros(b)
    ys, all_logits = [], []
    for step in range(t):
        h = _rb(_rb(_rb(x_prev)[:, None] * packed["fk"]) + packed["fb"])
        skip = cond.new_zeros((b, s))
        c_t = cond[:, step]
        for i, d in enumerate(dilations):
            slot, slot_d = step % (2 * d), (step + d) % (2 * d)
            w = w3[i]
            gates = _rb(rings[i][:, slot] @ w[:r]) + _rb(rings[i][:, slot_d] @ w[r:2 * r])
            gates = _rb(_rb(_rb(_rb(gates) + _rb(h @ w[2 * r:])) + packed["bg"][i]) + _rb(c_t @ wcond[i]))
            z = _rb(_rb(torch.tanh(gates[:, :g2])) * _sigmoid_scan(gates[:, g2:]))
            skip = _rb(_rb(skip + _rb(_rb(z @ wskip[i]) + packed["bs"][i])) * SQRT_HALF_BF16)
            new_h = _rb(_rb(h + _rb(_rb(z @ wout[i]) + packed["bo"][i])) * SQRT_HALF_BF16)
            rings[i][:, slot] = h
            h = new_h
        out = torch.relu(torch.relu(skip) @ packed["l1k"] + packed["l1b"])
        logits = out @ packed["l2k"] + packed["l2b"]
        x_prev = sample_from_mol_uniforms(logits, uniforms[:, step], log_scale_min)
        ys.append(x_prev)
        all_logits.append(logits)
    return torch.stack(ys, dim=1), torch.stack(all_logits, dim=1)


# ------------------------------------------------------------- launch plan

SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90
SMS = 132  # SMs of an H100 SXM: the default where no card is asked
THREADS = 256  # as in csrc/wavenet_gen.cu
TILE_ROWS = THREADS // 32  # batch rows a tile: one per warp
MAX_COLS = 8  # columns a block owns in a phase (a pair is two)
MAX_DEPTH = 4  # phase slots of the weight ring
MAX_LAYERS = 64
# The bfloat16 forms (csrc/wavenet_gen.cu:wavenet_kernel_bf16): a block owns a
# tile of 16 columns a phase (mma.sync's M: 8 gate pairs, or 16 residual
# columns), the batch runs in passes of 8, 16 or 32 rows (n8 tiles), each
# weight ring has at most 2 slots, and a phase's sums take a slot a warp, one
# more a segment boundary and one a segment's total, each 512 bytes an n8
# tile.
BF16_TILE = 16
BF16_PASS_ROWS = (32, 16, 8)
BF16_MAX_DEPTH = 2
BF16_SUM_SLOTS = THREADS // 32 + 7
BF16_STATIC = 1024  # bytes left for the kernel's static shared memory (its mbarriers)


@dataclasses.dataclass(frozen=True)
class GeneratePlan:
    """How one call is launched (see the notes of csrc/wavenet_gen.cu):
    ``blocks`` persistent blocks, at most one an SM, block i owning gate
    column pairs [i*pairs, (i+1)*pairs) of G/2, residual columns
    [i*cols, (i+1)*cols) of [wout | wskip] (R + S) and head columns
    [i*head_cols, (i+1)*head_cols) of last1 (S), each range cut at its
    width (a block past it owns none); a ring of ``depth`` phase slots of
    its weight slices (``kernel_weights``; in the bfloat16 forms a ring of
    each kind, gate and residual, ``kernel_weights_bf16``); ``smem`` dynamic
    shared bytes a block; ``launches`` CUDA launches a call; ``rows`` the
    bfloat16 forms' batch rows a pass (0 in float32)."""

    blocks: int
    pairs: int
    cols: int
    head_cols: int
    depth: int
    smem: int
    launches: int = 1
    rows: int = 0


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _r8(n: int) -> int:
    return -(-n // 8) * 8


def _r64(n: int) -> int:
    return -(-n // 64) * 64


def _r128(n: int) -> int:
    return -(-n // 128) * 128


def _r1024(n: int) -> int:
    return -(-n // 1024) * 1024


def _smem(batch: int, widths: Sequence[int], pairs: int, cols: int, head_cols: int, depth: int) -> int:
    """Shared bytes of a block of the float32 kernel, laid out as it lays
    them out: the weight ring, the staged rows of a tile, last1's slice and
    last2, the tile's logits, x_prev, two buffers of the warps' sums."""
    r, g, s, c, nout = widths
    k = 3 * r + g // 2 + c
    slot = (k + 1) * _r4(2 * pairs) + (g // 2 + 3) * _r4(cols)
    floats = (depth * slot + TILE_ROWS * _r4(max(k, s)) + s * _r4(head_cols) + _r4((s + 1) * nout)
              + TILE_ROWS * _r4(nout) + _r4(batch) + 2 * (THREADS // 32) * TILE_ROWS * MAX_COLS)
    return 4 * floats


def bf16_widths(widths: Sequence[int]) -> tuple[int, int, int, int, int]:
    """(Rq, Cq, Gq, gate k16 steps, residual k16 steps) of the bfloat16
    forms: R, C and G/2 padded to 64 (a staged row is whole 128-byte
    atoms), the gate's K = 3 Rq + Cq and the residual's Gq in steps of 16."""
    r, g, s, c, nout = widths
    rq, cq, gq = _r64(r), _r64(c), _r64(g // 2)
    return rq, cq, gq, (3 * rq + cq) // 16, gq // 16


def bf16_slice_bytes(widths: Sequence[int]) -> tuple[int, int]:
    """Bytes of one block's (gate, residual) slice of a layer in the
    bfloat16 forms: 512 bytes a k16 step (32 lanes' A fragments of 16
    bytes), then the tile's 16 float32 biases."""
    _, _, _, kg, kr = bf16_widths(widths)
    return kg * 512 + 4 * BF16_TILE, kr * 512 + 4 * BF16_TILE


def bf16_smem(batch: int, widths: Sequence[int], rows: int, head_cols: int, depth: int) -> int:
    """Shared bytes of a block of the bfloat16 forms, as the kernel lays them
    out (csrc/wavenet_gen.cu:LayoutBF): the gate and residual weight rings,
    the staged rows of a pass (the gate's warp sums and the head's staged
    rows reuse them), cond of a pass, z of a pass (the residual's warp sums
    and the head's reuse it), the block's residual columns of h and skip
    where the batch is one pass (in device memory else), last1's slice,
    last2, the tile's logits, x_prev; the staged buffers at 1024 bytes
    (TMA's swizzle), the rest at 128, and 1024 bytes to raise the base to
    1024. Only x_prev grows with B past one pass."""
    r, g, s, c, nout = widths
    rq, cq, gq, _, _ = bf16_widths(widths)
    gate, res = bf16_slice_bytes(widths)
    passes, warps = -(-batch // rows), THREADS // 32
    staged = (_r1024(depth * (_r128(gate) + _r128(res)))
              + _r1024(max(6 * rq * rows, BF16_SUM_SLOTS * (rows // 8) * 512, 4 * TILE_ROWS * s))
              + 2 * cq * rows + _r1024(max(2 * gq * rows, warps * (rows // 8) * 512, 4 * warps * TILE_ROWS * MAX_COLS)))
    kept = _r128(4 * _r8(batch) * BF16_TILE) if passes == 1 else 0
    return (staged + kept + _r128(4 * s * _r4(head_cols)) + _r128(4 * (s + 1) * nout)
            + _r128(4 * TILE_ROWS * _r4(nout)) + _r128(4 * _r4(batch)) + 1024)


@functools.lru_cache(maxsize=None)
def generate_plan(batch: int, widths: tuple[int, int, int, int, int], sms: int = SMS,
                  esize: int = 4) -> GeneratePlan:
    """The plan at B = ``batch`` for ``widths`` = (R, G, S, C, 3K) on a card
    of ``sms`` SMs with weights of ``esize`` bytes (4 float32, 2 the
    bfloat16 forms). float32: the fewest columns a block that ``sms``
    blocks cover, as many blocks as the widest phase needs, and the deepest
    weight ring (at most MAX_DEPTH phases) that fits SMEM_MAX; at full width
    (512, 512, 256, 80, 30) on 132 SMs 128 blocks of 2 pairs, 6 columns and
    2 head columns, 3 phases deep. bfloat16 (``_plan_bf16``): tiles of 16
    columns, 48 blocks at full width. Raises where the widths need more SMs
    or more shared memory than there is."""
    r, g, s, c, nout = widths
    if esize not in (2, 4):
        raise ValueError(f"wavenet weights are 4 or 2 bytes, not {esize}")
    if esize == 2:
        return _plan_bf16(batch, widths, sms)
    g2 = g // 2
    k = 3 * r + g // 2 + c  # a staged row, in 16-byte units of 4 floats
    if max(k * esize, 4 * s) > 32 * THREADS:
        raise ValueError(f"wavenet kernel stages rows of at most {32 * THREADS} bytes: {k} weights of {esize} "
                         f"bytes (3R + C + G/2), S = {s}")
    pairs, cols, head_cols = -(-g2 // sms), -(-(r + s) // sms), -(-s // sms)
    if 2 * pairs > MAX_COLS or cols > MAX_COLS or head_cols > MAX_COLS:
        raise ValueError(f"wavenet kernel needs at least {-(-max(2 * g2, r + s) // MAX_COLS)} SMs for G={g}, "
                         f"R+S={r + s} ({MAX_COLS} columns a block), the card has {sms}")
    blocks = max(-(-g2 // pairs), -(-(r + s) // cols), -(-s // head_cols))
    for depth in range(MAX_DEPTH, 0, -1):
        smem = _smem(batch, widths, pairs, cols, head_cols, depth)
        if smem <= SMEM_MAX:
            return GeneratePlan(blocks, pairs, cols, head_cols, depth, smem)
    raise ValueError(f"wavenet kernel: one layer's weight slices and the staged rows take "
                     f"{_smem(batch, widths, pairs, cols, head_cols, 1)} bytes of shared memory, more than "
                     f"{SMEM_MAX}")


def _plan_bf16(batch: int, widths: tuple[int, int, int, int, int], sms: int) -> GeneratePlan:
    """The bfloat16 forms' plan: block i owns gate tile i (pairs 8i ..
    8i + 7) and residual tile i (columns 16i .. 16i + 15 of R + S), so as
    many blocks as the wider phase has tiles (the head's S columns at most
    MAX_COLS a block); the batch in one pass where it fits (8, 16 or 32
    rows: a batch up to 32 is one pass), then the deeper weight rings. At
    full width on 132 SMs: 48 blocks, 6 head columns; B=8 one pass of 8
    rows, rings of 2; B=32 one pass of 32 rows, rings of 1; B=64 two
    passes of 32. Past one pass only x_prev grows with B (``bf16_smem``):
    at full width a plan up to B=24288."""
    r, g, s, c, nout = widths
    if 4 * s > 32 * THREADS:
        raise ValueError(f"wavenet kernel stages head rows of at most {32 * THREADS} bytes, S = {s}")
    blocks = max(-(-(g // 2) // (BF16_TILE // 2)), -(-(r + s) // BF16_TILE), -(-s // MAX_COLS))
    if blocks > sms:
        raise ValueError(f"wavenet kernel needs at least {blocks} SMs for G={g}, R+S={r + s} (tiles of "
                         f"{BF16_TILE} columns), the card has {sms}")
    head_cols = -(-s // blocks)
    one_pass = min([rows for rows in BF16_PASS_ROWS if rows >= batch] or [max(BF16_PASS_ROWS)])
    for rows in (rows for rows in BF16_PASS_ROWS if rows <= one_pass):
        for depth in range(BF16_MAX_DEPTH, 0, -1):
            smem = bf16_smem(batch, widths, rows, head_cols, depth)
            if smem <= SMEM_MAX - BF16_STATIC:
                return GeneratePlan(blocks, BF16_TILE // 2, BF16_TILE, head_cols, depth, smem, rows=rows)
    raise ValueError(f"wavenet kernel: one layer's weight slices and the staged rows take "
                     f"{bf16_smem(batch, widths, 8, head_cols, 1)} bytes of shared memory, more than "
                     f"{SMEM_MAX - BF16_STATIC}")


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_on_card(batch: int, widths: tuple[int, int, int, int, int], device: torch.device,
                  esize: int = 4) -> GeneratePlan:
    """The plan at the SM count of the card ``device`` names (an H100's,
    ``SMS``, for a device that is no card, which generate_cuda refuses
    after this)."""
    if device.type != "cuda":
        return generate_plan(batch, widths, SMS, esize)
    return generate_plan(batch, widths, _card_sms(device.index if device.index is not None
                                                 else torch.cuda.current_device()), esize)


def kernel_weights(packed: Mapping[str, torch.Tensor], plan: GeneratePlan) -> torch.Tensor:
    """The weights in the kernel's layout for ``plan``: (L + 1, blocks, slot)
    floats, block i's slot of phase p holding what it keeps in shared memory
    for that phase, as it lays it out there.

    Phase p runs the residual update of layer p - 1 and the gate of layer p
    from one staged row [x(t-2d), x(t-d), h_{p-1}, z_{p-1}, cond_t]: the
    gate's h_p @ w3_p[2R:3R] is taken as sqrt(.5) (h_{p-1} @ w3_p[2R:3R] +
    z_{p-1} @ (wout_{p-1} @ w3_p[2R:3R]) + bo_{p-1} @ w3_p[2R:3R]), the
    products of weights formed here in float64 and rounded once, so that
    one grid barrier a layer serves both (layer 0 takes h_0 = x_prev * fk +
    fb as it is). The slot is the gate slice ((K + 1) x CG: the K = 3R +
    G/2 + C rows [w3_p[:2R]; the h rows; the z rows; wcond_p] and the bias
    row, columns [tanh j, sigmoid j] for each of the block's pairs j, zeros
    to CG = 2*pairs rounded up to 4; zeros at p = L) then the residual slice
    ((G/2 + 3) x CR: the G/2 rows of [wout_{p-1} | wskip_{p-1}], the bias
    row [bo | bs]_{p-1}, the first conv's fk and fb (zero for skip columns),
    the block's columns, zeros to CR; zeros at p = 0). Made on the weights'
    device, once a call."""
    w3, wcond, wout, wskip = (packed[k] for k in ("w3", "wcond", "wout", "wskip"))
    n_layers, g = w3.shape[0], w3.shape[-1]
    g2, r, s = g // 2, wout.shape[-1], wskip.shape[-1]
    dev, f64 = w3.device, torch.float64
    blk = torch.arange(plan.blocks, device=dev)[:, None]

    # the gate rows of layers 0 .. L-1, then none for phase L
    w_h = w3[:, 2 * r:].to(f64)
    h_rows, z_rows, bias = w_h.clone(), torch.zeros((n_layers, g2, g), dtype=f64, device=dev), packed["bg"].to(f64)
    h_rows[1:] *= SQRT_HALF
    z_rows[1:] = SQRT_HALF * (wout[:-1].to(f64) @ w_h[1:])
    bias[1:] += SQRT_HALF * (packed["bo"][:-1].to(f64)[:, None] @ w_h[1:])[:, 0]
    gate = torch.cat([w3[:, :2 * r].to(f64), h_rows, z_rows, wcond.to(f64), bias[:, None]], dim=1).float()
    gate = torch.cat([gate, torch.zeros_like(gate[:1])])
    # the residual rows of phase 0 (none), then of layers 0 .. L-1
    first = torch.zeros((2, r + s), device=dev)
    first[:, :r] = torch.stack([packed["fk"], packed["fb"]])
    res = torch.cat([torch.cat([wout, wskip], dim=2), torch.cat([packed["bo"], packed["bs"]], dim=1)[:, None],
                     first.expand(n_layers, 2, r + s)], dim=1)
    res = torch.cat([torch.zeros_like(res[:1]), res])

    def columns(n_cols: int, pad: int, col_of) -> tuple[torch.Tensor, torch.Tensor]:
        """(blocks, pad) source column of each slot column and whether it is one."""
        col, owned = col_of(torch.arange(pad, device=dev)[None, :])
        ok = owned & (col < n_cols)
        return torch.where(ok, col, 0), ok

    gate_cols, gate_ok = columns(g, _r4(2 * plan.pairs),
                                 lambda c: ((blk * plan.pairs + c // 2) + (c % 2) * g2,
                                            (c < 2 * plan.pairs) & (blk * plan.pairs + c // 2 < g2)))
    res_cols, res_ok = columns(r + s, _r4(plan.cols), lambda c: (blk * plan.cols + c, c < plan.cols))
    gate = gate[:, :, gate_cols] * gate_ok  # (L+1, K+1, blocks, CG)
    res = res[:, :, res_cols] * res_ok  # (L+1, G/2+3, blocks, CR)
    return torch.cat([gate.permute(0, 2, 1, 3).reshape(n_layers + 1, plan.blocks, -1),
                      res.permute(0, 2, 1, 3).reshape(n_layers + 1, plan.blocks, -1)], dim=2).contiguous()


def fragment_order(device: torch.device | str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, k), each (32, 8): the element (row m, column k) of a 16 x 16 A
    tile of mma.sync m16n8k16 that lane i holds as its i-th bfloat16 value
    (its four registers a0a1, a2a3, a4a5, a6a7; g = lane / 4, c = lane % 4:
    (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1), then the same at k + 8)."""
    lane = torch.arange(32, device=device)
    g, c = lane // 4, 2 * (lane % 4)
    m = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], dim=1)
    k = torch.stack([c, c + 1, c, c + 1, c + 8, c + 9, c + 8, c + 9], dim=1)
    return m, k


def kernel_weights_bf16(packed: Mapping[str, torch.Tensor], plan: GeneratePlan) -> tuple[torch.Tensor, torch.Tensor]:
    """The bfloat16 forms' weights in their layout for ``plan``: (gate,
    residual) uint8 tensors (L, blocks, bytes), block i's slice of layer l
    what it keeps in shared memory for that phase (``bf16_slice_bytes``).
    The gate slice: the rows [w3_l; wcond_l] with each of the four segments
    [x(t-2d) | x(t-d) | h | cond] padded with zero rows to a multiple of 64
    (K = 3 Rq + Cq, ``bf16_widths``), at the tile's 16 columns (the tanh
    columns of pairs 8i .. 8i + 7, then their sigmoid columns; zero past
    G/2), in mma.sync's
    A-fragment order: k16 step s, lane, then the lane's 8 values
    (``fragment_order``; A[m][k] = W[k][column m]), then the 16 float32
    biases of bg_l. The residual slice: the G/2 rows of [wout_l | wskip_l]
    padded to 64 at the tile's columns 16i .. 16i + 15 (zero past R + S),
    the same way, then the biases of [bo_l | bs_l]. No fold: the gate takes
    bf16(h_l), which the float32 form's fold cannot give. Made on the
    weights' device, once a call."""
    w3, wcond, wout, wskip = (packed[k] for k in ("w3", "wcond", "wout", "wskip"))
    n_layers, g = w3.shape[0], w3.shape[-1]
    g2, r, s, c = g // 2, wout.shape[-1], wskip.shape[-1], wcond.shape[1]
    dev = w3.device
    rq, cq, gq, _, _ = bf16_widths((r, g, s, c, packed["l2b"].shape[0]))
    pad = lambda w, rows: torch.cat([w, w.new_zeros((n_layers, rows - w.shape[1], w.shape[2]))], dim=1)
    gate_rows = torch.cat([pad(w3[:, i * r:(i + 1) * r], rq) for i in range(3)] + [pad(wcond, cq)], dim=1)
    res_rows = pad(torch.cat([wout, wskip], dim=2), gq)
    blk = torch.arange(plan.blocks, device=dev)[:, None]
    m = torch.arange(BF16_TILE, device=dev)[None, :]
    pair = blk * (BF16_TILE // 2) + m % (BF16_TILE // 2)
    gate_cols, gate_ok = pair + (m >= BF16_TILE // 2) * g2, pair < g2
    res_cols = blk * BF16_TILE + m
    res_ok = res_cols < r + s
    fm, fk = fragment_order(dev)

    def cut(w: torch.Tensor, bias: torch.Tensor, cols: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """(L, blocks, bytes): each block's tile of w (L, K, N) in fragment
        order, then its float32 biases."""
        tiles = torch.where(ok, w[:, :, torch.where(ok, cols, 0)], torch.zeros((), dtype=w.dtype, device=dev))
        steps = tiles.shape[1] // 16
        tiles = tiles.permute(0, 2, 1, 3).reshape(n_layers, plan.blocks, steps, 16, BF16_TILE)  # (.., step, k, m)
        frags = tiles[..., fk, fm].reshape(n_layers, plan.blocks, -1).contiguous().view(torch.uint8)
        b = torch.where(ok, bias[:, torch.where(ok, cols, 0)], torch.zeros((), device=dev)).contiguous()
        return torch.cat([frags, b.view(torch.uint8)], dim=2).contiguous()

    return (cut(gate_rows, packed["bg"], gate_cols, gate_ok),
            cut(res_rows, torch.cat([packed["bo"], packed["bs"]], dim=1), res_cols, res_ok))


def _library() -> ctypes.CDLL:
    lib = _build.load("wavenet_gen")
    fn = lib.autovc_wavenet_gen
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for fn in (lib.autovc_wavenet_gen_bf16, lib.autovc_wavenet_gen_scan):
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.autovc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_layout(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
                  uniforms: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """(L, R, G, S, C, 3K) after checking what the kernel takes: w3, wcond,
    wout and wskip all float32 or all bfloat16, the rest float32."""
    n_layers = len(dilations)
    wdt = packed["w3"].dtype
    g = packed["w3"].shape[-1]
    r, s, c, nout = packed["fk"].shape[0], packed["wskip"].shape[-1], packed["wcond"].shape[1], packed["l2b"].shape[0]
    want = {
        "w3": (n_layers, 3 * r, g), "wcond": (n_layers, c, g), "wout": (n_layers, g // 2, r),
        "wskip": (n_layers, g // 2, s), "bg": (n_layers, g), "bo": (n_layers, r), "bs": (n_layers, s),
        "fk": (r,), "fb": (r,), "l1k": (s, s), "l1b": (s,), "l2k": (s, nout), "l2b": (nout,),
    }
    for key, shape in want.items():
        t = packed[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"packed[{key!r}] has shape {tuple(t.shape)}, expected {shape}")
        want_dt = wdt if key in ("w3", "wcond", "wout", "wskip") else torch.float32
        if wdt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"packed weights are float32 or bfloat16, not {wdt}")
        if t.dtype != want_dt or t.device != cond.device or not t.is_contiguous():
            raise ValueError(f"packed[{key!r}] must be contiguous {want_dt} on {cond.device}, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"packed[{key!r}] is not 16-byte aligned")
    b, t_len, c_in = cond.shape
    if c_in != c or tuple(uniforms.shape) != (b, t_len, nout // 3 + 1):
        raise ValueError(f"cond {tuple(cond.shape)} / uniforms {tuple(uniforms.shape)} do not match C={c}, 3K={nout}")
    c_unit = 8 if wdt == torch.bfloat16 else 4  # C in 16-byte units of the staged row
    if g % 16 or r % 8 or s % 8 or c % c_unit or nout % 3:
        raise ValueError(f"wavenet kernel needs G % 16 == 0, R % 8 == 0, S % 8 == 0, C % {c_unit} == 0 "
                         f"(G={g}, R={r}, S={s}, C={c})")
    if min(dilations) < 1 or n_layers > MAX_LAYERS:
        raise ValueError(f"dilations must be >= 1, at most {MAX_LAYERS} layers, got {tuple(dilations)}")
    return n_layers, r, g, s, c, nout


_ERR_PLAN, _ERR_RESIDENT, _ERR_TMA = -1, -2, -3  # the launcher's own codes (csrc/coop.cuh, csrc/tma.cuh)


def generate_cuda(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
                  uniforms: torch.Tensor, log_scale_min: float = LOG_SCALE_MIN,
                  scan: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (no synchronisation):
    one cooperative launch of ``generate_plan`` for all T samples, the
    bfloat16 form where the packed weights are bfloat16, its scan rounding
    with ``scan``."""
    global launches, bf16_launches, scan_launches, last_cuda_launches, last_launch
    if scan:
        packed = scan_weights(packed)
    if cond.dtype != torch.float32 or uniforms.dtype != torch.float32:
        raise TypeError(f"wavenet kernel takes float32 cond and uniforms, got {cond.dtype} and {uniforms.dtype}")
    if uniforms.device != cond.device:
        raise ValueError(f"cond on {cond.device}, uniforms on {uniforms.device}")
    cond, uniforms = cond.contiguous(), uniforms.contiguous()
    n_layers, r, g, s, c, nout = _check_layout(packed, dilations, cond, uniforms)
    bf16 = packed["w3"].dtype == torch.bfloat16
    b, t, _ = cond.shape
    plan = _plan_on_card(b, (r, g, s, c, nout), cond.device, 2 if bf16 else 4)
    if cond.device.type != "cuda":
        raise ValueError(f"wavenet kernel takes tensors on a CUDA device, got {cond.device}")
    lib = _library()
    dev = cond.device
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, device=dev, dtype=dtype)
    y, logits = empty(b, t), empty(b, t, nout)
    # Scratch: the rings (sum 2d slots of (B, R), zero: x(t - d) before t = 0),
    # h and z (float32: two of each, a layer's in and out; the bfloat16
    # forms keep one z, bf16(h) for the next gate and, past one pass, the
    # blocks' h and skip columns), skip and last1's output, each written
    # before it is read (the pads of the bfloat16 forms' rows never are, and
    # stay zero).
    wdt = torch.bfloat16 if bf16 else torch.float32
    skip, o1 = empty(b, s), empty(b, s)
    dils = (ctypes.c_int * n_layers)(*dilations)
    info = (ctypes.c_int * 2)(0, 0)
    head = [packed[k].data_ptr() for k in ("fk", "fb", "l1k", "l1b", "l2k", "l2b")]
    shape = (n_layers, b, t, r, g, s, c, nout, log_scale_min)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            # the rows the kernel stages by TMA, padded with zeros to whole
            # 128-byte atoms: the rings and bf16(h) to Rq, z to Gq, cond as
            # (T, B, Cq)
            rq, cq, gq, _, _ = bf16_widths((r, g, s, c, nout))
            ring = torch.zeros((2 * sum(dilations), b, rq), device=dev, dtype=wdt)
            hb, z = torch.zeros((b, rq), device=dev, dtype=wdt), torch.zeros((b, gq), device=dev, dtype=wdt)
            cond_q = torch.zeros((t, b, cq), device=dev, dtype=wdt)
            cond_q[..., :c] = cond.transpose(0, 1)
            hs = empty(b, r + s)
            gate_w, res_w = kernel_weights_bf16(packed, plan)
            fn = lib.autovc_wavenet_gen_scan if scan else lib.autovc_wavenet_gen_bf16
            err = fn(gate_w.data_ptr(), res_w.data_ptr(), *head, cond_q.data_ptr(), uniforms.data_ptr(), y.data_ptr(),
                     logits.data_ptr(), ring.data_ptr(), hb.data_ptr(), skip.data_ptr(), z.data_ptr(), o1.data_ptr(),
                     hs.data_ptr(), ctypes.cast(dils, ctypes.c_void_p), *shape, plan.blocks, plan.rows, plan.head_cols, plan.depth,
                     plan.smem, info, stream)
        else:
            ring = torch.zeros((2 * sum(dilations), b, r), device=dev)
            slices = kernel_weights(packed, plan)
            h, z = empty(2, b, r), empty(2, b, g // 2)
            err = lib.autovc_wavenet_gen(
                slices.data_ptr(), *head, cond.data_ptr(), uniforms.data_ptr(), y.data_ptr(), logits.data_ptr(),
                ring.data_ptr(), h.data_ptr(), skip.data_ptr(), z.data_ptr(), o1.data_ptr(),
                ctypes.cast(dils, ctypes.c_void_p), *shape, plan.blocks, plan.pairs, plan.cols, plan.head_cols,
                plan.depth, plan.smem, info, stream)
    last_launch = (plan, info[0], info[1])
    if err == _ERR_PLAN:
        raise RuntimeError(f"wavenet kernel refused the launch plan {plan}")
    if err == _ERR_RESIDENT:
        raise RuntimeError(f"wavenet kernel: {plan.blocks} blocks must be resident for the grid barrier, but the "
                           f"card holds {info[0]} per SM on {info[1]} SMs")
    if err == _ERR_TMA:
        raise RuntimeError(f"wavenet kernel: the staged rows' tensor maps could not be encoded (plan {plan})")
    if err:
        raise RuntimeError(f"wavenet kernel launch failed: {lib.autovc_cuda_error_string(err).decode()}")
    launches += 1
    bf16_launches += int(bf16 and not scan)
    scan_launches += int(scan)
    last_cuda_launches = plan.launches
    return y, logits


def generate(packed: Mapping[str, torch.Tensor], dilations: Sequence[int], cond: torch.Tensor,
             uniforms: torch.Tensor, log_scale_min: float = LOG_SCALE_MIN,
             scan: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """cond (B, T, C), uniforms (B, T, K+1) -> samples (B, T), logits
    (B, T, 3K): the kernel for a CUDA tensor, the plain version for a CPU
    tensor; ``scan`` (bfloat16 weights) in the scan rounding."""
    if cond.device.type == "cuda":
        return generate_cuda(packed, dilations, cond, uniforms, log_scale_min, scan)
    if cond.device.type == "cpu":
        return generate_ref(packed, dilations, cond, uniforms, log_scale_min, scan)
    raise ValueError(f"generate runs on cuda or cpu tensors, not {cond.device}")
