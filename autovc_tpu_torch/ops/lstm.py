"""LSTM recurrence over hoisted input projections: the CUDA kernels and their
plain PyTorch versions, forward and backward.

Counterpart of ``autovc_tpu/ops/pallas_lstm.py``: given
``xproj = x @ w_ih + b`` of shape (B, T, 4H) and ``w_hh`` (H, 4H), the hidden
sequence (B, T, H). Gate order i, f, g, o; float32 carry; initial state
(h0, c0), zero when None; ``reverse=True`` runs right to left (the backward
direction of a BLSTM) and returns the sequence in natural time order.

- ``lstm_sequence`` (inference, and training through ``LSTMSequenceFn`` when
  grad is on) launches ``csrc/lstm_fwd.cu`` for a CUDA tensor and runs the
  plain version for a CPU tensor; there is no fallback from one to the other.
  Its inference form is the operator ``torch.ops.autovc.lstm_sequence``
  (``torch.library.custom_op``: a CPU and a CUDA kernel, no default, a fake
  implementation), which ``torch.export`` keeps as one graph node
  (``autovc_tpu_torch.serve``).
- ``LSTMSequenceFn`` is the differentiable form, (xproj, w_hh, h0, c0) ->
  (h_seq, hN, cN): its forward runs the kernel's training form, which also
  keeps the cell sequence and the gate activations; its backward runs
  ``csrc/lstm_bwd.cu`` (the reversed recurrence with dh0, then the dW
  product, left out where w_hh does not require grad, as in a frozen
  encoder) on them.
- ``dw_plan`` chooses, in plain Python from (B, T, H), the dW product's
  tiles and its split of K over blocks where the tiles alone leave SMs idle.
- ``launch_plan`` chooses, in plain Python from (B, H), how a sequence is
  launched: one block per batch tile with all of w_hh (regime a), or one
  persistent block per SM, each with its slice of w_hh, meeting at a grid
  barrier each step (regime b). Each kernel keeps its slice of w_hh in
  shared memory for the whole sequence; one launch runs the sequence.
  ``scan_plan`` and ``scan_bwd_plan`` do the same for the scan rounding's
  forward and backward, ``scan_dw_plan`` for its dW.
- ``lstm_sequence_train_ref``, ``lstm_backward_ref`` and
  ``lstm_weight_grad_ref`` are the plain versions: loops of the same formulas,
  not autograd, in float32 (float64 for float64 inputs, a reference of
  higher precision).

bfloat16: the forward takes bfloat16 xproj and w_hh together
(``layers.LSTM`` in ``compute_dtype="bfloat16"``) and rounds as the Pallas
kernel does (``pallas_lstm.py:41-75``): gates = f32(xproj_t) + h_{t-1} @
f32(w_hh) in float32, the (h, c) carry in float32 for the whole sequence,
only the stored sequence rounded to bfloat16; a float32 initial state, and
in the training form the float32 c_seq, hN and cN (``_lstm_kernel_train``).
The backward rounds as the Pallas backward on those residuals does
(``pallas_lstm.py:410-453``, ``_lstm_chunk_bwd_rule`` :514-525): the gate
activations recomputed from the ROUNDED h_seq (``lstm_gates_cuda``, the
``csrc/lstm_gates.cu`` kernel; ``lstm_gates_ref``), dy read in bfloat16,
every sum in float32 and dh's carry over the float32 gate gradients, dxproj
rounded to bfloat16 from them, dW summed in float32 over the float32 gate
gradients and rounded once to bfloat16, dh0 and dc0 float32. The plain
versions do the same. Mixed xproj and w_hh dtypes raise a TypeError. The
gates kernel tiles (B*T, 4H) as ``gates_plan`` says (TMA loads, wgmma).

The scan rounding (``scan=True``; bfloat16 only): JAX's other bfloat16
LSTM, ``_lstm_scan`` under ``jit``, which the d-vector runs on a bfloat16
input: a bfloat16 carry and every op rounded (``lstm_scan_bf16_train_ref``,
``lstm_scan_bf16_backward_ref``; on the card ``csrc/lstm_scan_fwd.cu``, its
recurrent product on the bfloat16 tensor cores (wgmma; mma.sync at H <= 32) as ``scan_plan``
launches it, and ``csrc/lstm_scan_bwd.cu``, its dh product on mma.sync as
``scan_bwd_plan`` launches it: ``lstm_scan_forward_cuda`` and
``lstm_scan_backward_cuda``), and which the Generator runs in bfloat16
unless ``ModelConfig.use_pallas_lstm``. Its forward keeps the residuals of
the scan's VJP, so its backward recomputes nothing. Its dW
(``lstm_scan_bf16_weight_grad_ref``; on the card ``csrc/lstm_scan_dw.cu``,
``lstm_scan_weight_grad_cuda``, as ``scan_dw_plan`` spreads it over the
card) is the transposed scan's: a bfloat16 accumulator that each step's
product is added to, rounded; it is left out where w_hh does not require
grad (the frozen d-vector).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import inspect

import torch

from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.ops import _build

# Sequences launched on the card by each wrapper: a forward, a backward
# (the reversed recurrence with dh0), a dW product, the bfloat16 backward's
# gate activations, one kernel launch each; a forward in bfloat16 counts in
# launches and in bf16_launches, a backward in bfloat16 in bwd_launches and
# in bf16_bwd_launches; one in the scan rounding counts in launches and
# scan_launches, or in bwd_launches and scan_bwd_launches, and its dW in
# scan_dw_launches (not in dw_launches). Callers reset them to 0 and read
# them back.
launches = 0
bf16_launches = 0
scan_launches = 0
bwd_launches = 0
bf16_bwd_launches = 0
scan_bwd_launches = 0
dw_launches = 0
scan_dw_launches = 0
gates_launches = 0
# The same launches of the recurrences by kind and regime ("fwd_c",
# "scan_bwd_b", ...), counted where the kernel is launched.
regime_launches: dict[str, int] = {}


def _compute_dtype(xproj: torch.Tensor) -> torch.dtype:
    """The plain versions compute in float32, or in float64 for float64 inputs."""
    return torch.promote_types(xproj.dtype, torch.float32)


def _zeros_like_state(xproj: torch.Tensor, hidden: int) -> torch.Tensor:
    return torch.zeros((xproj.shape[0], hidden), dtype=_compute_dtype(xproj), device=xproj.device)


def lstm_sequence_train_ref(xproj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor | None = None,
                            c0: torch.Tensor | None = None, reverse: bool = False):
    """The plain forward: a Python loop of the cell update in float32 (float64
    for float64 inputs) -> (h_seq, c_seq, hN, cN), the sequences (B, T, H)
    in natural time order; for bfloat16 xproj h_seq is rounded to bfloat16
    (the carry, c_seq, hN and cN stay float32)."""
    b, t, h4 = xproj.shape
    hidden = h4 // 4
    dt = _compute_dtype(xproj)
    w = w_hh.to(dt)
    h = _zeros_like_state(xproj, hidden) if h0 is None else h0.to(dt)
    c = _zeros_like_state(xproj, hidden) if c0 is None else c0.to(dt)
    hs: list[torch.Tensor] = [h] * t
    cs: list[torch.Tensor] = [c] * t
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = xproj[:, step].to(dt) + h @ w
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[step], cs[step] = h, c
    h_seq = torch.stack(hs, dim=1)
    return h_seq.to(torch.bfloat16) if xproj.dtype == torch.bfloat16 else h_seq, torch.stack(cs, dim=1), h, c


def lstm_sequence_ref(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False, scan: bool = False
                      ) -> torch.Tensor:
    """The plain inference forward from a zero state: the hidden sequence,
    in xproj's dtype where that is bfloat16 (computed with a float32 carry,
    or with ``scan`` the scan rounding's: ``lstm_scan_bf16_ref``)."""
    _check_dtypes(xproj, w_hh)
    if scan:
        return lstm_scan_bf16_ref(xproj, w_hh, reverse=reverse)
    return lstm_sequence_train_ref(xproj, w_hh, reverse=reverse)[0]


def _hprev(h_seq: torch.Tensor, h0: torch.Tensor | None, reverse: bool) -> torch.Tensor:
    """(..., B, T, H): the state each step started from (h0, or zero, at the
    start)."""
    first = torch.zeros_like(h_seq[..., :1, :]) if h0 is None else h0[..., None, :].to(h_seq.dtype)
    if reverse:
        return torch.cat([h_seq[..., 1:, :], first], dim=-2)
    return torch.cat([first, h_seq[..., :-1, :]], dim=-2)


def lstm_weight_grad_ref(h_seq: torch.Tensor, h0: torch.Tensor | None, dxproj: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """dW_hh (H, 4H) = sum over (b, t) of hprev[b, t]^T dxproj[b, t], in
    float32 (float64 for float64 inputs); rounded once to bfloat16 when h_seq
    is bfloat16 (the bfloat16 form, whose dxproj are the float32 gate
    gradients)."""
    dt = _compute_dtype(dxproj)
    hprev = _hprev(h_seq.to(dt), h0, reverse)
    dw = hprev.reshape(-1, hprev.shape[-1]).T @ dxproj.reshape(-1, dxproj.shape[-1]).to(dt)
    return dw.to(torch.bfloat16) if h_seq.dtype == torch.bfloat16 else dw


def lstm_backward_ref(xproj, w_hh, h0, c0, h_seq, c_seq, dy, dhn=None, dcn=None, reverse: bool = False, *,
                      need_dw: bool = True):
    """The plain backward: the reversed loop of ``pallas_lstm.py:438-453``,
    gates recomputed from (xproj, hprev) -> (dxproj, dW_hh, dh0, dc0); dW_hh
    is None unless ``need_dw`` (a frozen w_hh). In bfloat16 (xproj, w_hh,
    h_seq and dy) it computes in float32 from the rounded h_seq, carries the
    float32 gate gradients and returns dxproj and dW_hh rounded to bfloat16,
    dh0 and dc0 in float32."""
    b, t, h4 = xproj.shape
    hidden = h4 // 4
    dt = _compute_dtype(xproj)
    w = w_hh.to(dt)
    hprev_seq = _hprev(h_seq.to(dt), h0, reverse)
    cprev_seq = _hprev(c_seq.to(dt), c0, reverse)
    dh_carry = _zeros_like_state(xproj, hidden) if dhn is None else dhn.to(dt)
    dc = _zeros_like_state(xproj, hidden) if dcn is None else dcn.to(dt)
    dx = torch.empty((b, t, h4), dtype=dt, device=xproj.device)
    for step in (range(t) if reverse else range(t - 1, -1, -1)):
        gates = xproj[:, step].to(dt) + hprev_seq[:, step] @ w
        gi, gf, gg, go = gates.split(hidden, dim=-1)
        si, sf, tg, so = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
        tc = torch.tanh(c_seq[:, step].to(dt))
        dh = dy[:, step].to(dt) + dh_carry
        d_o = dh * tc * so * (1.0 - so)
        dc = dc + dh * so * (1.0 - tc * tc)
        di = dc * tg * si * (1.0 - si)
        dg = dc * si * (1.0 - tg * tg)
        df = dc * cprev_seq[:, step] * sf * (1.0 - sf)
        dgates = torch.cat([di, df, dg, d_o], dim=-1)
        dx[:, step] = dgates
        dh_carry = dgates @ w.T
        dc = dc * sf
    dw = lstm_weight_grad_ref(h_seq, h0, dx, reverse) if need_dw else None
    return dx.to(torch.bfloat16) if xproj.dtype == torch.bfloat16 else dx, dw, dh_carry, dc


def lstm_gates_ref(xproj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor | None, h_seq: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """(B, T, 4H): the gate activations [sigmoid(i), sigmoid(f), tanh(g),
    sigmoid(o)] of every step, from the state each step started from. Not a
    recurrence: one product over all (b, t), in exact float32 (the plain
    version of ``csrc/lstm_gates.cu`` for bfloat16 xproj, w_hh and h_seq,
    widened)."""
    dt = _compute_dtype(xproj)
    hidden = w_hh.shape[0]
    with exact_f32(xproj.device):
        pre = xproj.to(dt) + _hprev(h_seq.to(dt), h0, reverse) @ w_hh.to(dt)
    i, f, g, o = pre.split(hidden, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], dim=-1)


# ------------------------------------------- the scan rounding (bf16 carry)

def _rb(v: torch.Tensor) -> torch.Tensor:
    """A float32 value rounded to bfloat16 (nearest even) and widened back."""
    return v.to(torch.bfloat16).float()


def _products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, one matrix product for each stacked problem (the leading dim
    of b, if any): the product each would make alone, not a batched one."""
    if b.dim() == 2:
        return a @ b
    return torch.stack([x @ y for x, y in zip(a, b)])


def _sigmoid_scan(x: torch.Tensor) -> torch.Tensor:
    """XLA's logistic on bfloat16: 1 / (1 + exp(-x)), each op rounded."""
    return _rb(1.0 / _rb(1.0 + _rb(torch.exp(-x))))


def _dsigmoid_scan(s: torch.Tensor) -> torch.Tensor:
    """The residual of logistic's VJP, s * (1 - s), each op rounded."""
    return _rb(s * _rb(1.0 - s))


def lstm_scan_bf16_train_ref(xproj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor | None = None,
                             c0: torch.Tensor | None = None, reverse: bool = False):
    """The plain forward of the scan rounding -> (h_seq, c_seq, act, hN, cN),
    all bfloat16: ``_lstm_scan`` (``autovc_tpu/models/layers.py:123-144``) on
    bfloat16 xproj, w_hh and state, as XLA runs it under ``jit`` (each
    primitive rounds its result to bfloat16; on the CPU it keeps no excess
    precision across a fusion):

        d = rb(h @ w_hh)                       (float32 sums of exact products)
        i, f, g, o = rb(xproj_t + d)
        sigmoid(x) = rb(1 / rb(1 + rb(exp(-x))))     tanh(x) = rb(tanh(x))
        c = rb(rb(sf * c) + rb(si * tg))     h = rb(so * rb(tanh(c)))

    ``act`` (B, T, 4H) = [si, sf, tg, so] and ``c_seq`` are the residuals
    the backward (``lstm_scan_bf16_backward_ref``) reads. Leading dims
    (..., B, T, 4H) and (..., H, 4H), on every argument, stack problems
    (relabellings of the hidden units, say): each makes its own (B, H) x
    (H, 4H) product and rounds as it would alone. These points were
    chosen by measurement on the CPU against ``jax.jit`` of ``_lstm_scan``,
    both directions: bit-equal at B=8, T=24, H=32; at B=7, T=128, H=256
    99.1-99.9% bit-equal (its float32 sums in another order, carried by a
    bfloat16 state). The loop with the sigmoid rounded once
    (``rb(torch.sigmoid(x))``) is 40% bit-equal and up to 7.8e-3 away; with
    only the carries rounded (every gate op in float32), 29%."""
    _check_dtypes(xproj, w_hh)
    *lead, b, t, h4 = xproj.shape
    hidden = h4 // 4
    w = w_hh.float()
    h = torch.zeros(*lead, b, hidden) if h0 is None else _rb(h0.float())
    c = torch.zeros(*lead, b, hidden) if c0 is None else _rb(c0.float())
    h, c = h.to(xproj.device), c.to(xproj.device)
    hs: list[torch.Tensor] = [h] * t
    cs: list[torch.Tensor] = [c] * t
    acts: list[torch.Tensor] = [c] * t
    with exact_f32(xproj.device):
        for step in (range(t - 1, -1, -1) if reverse else range(t)):
            gates = _rb(xproj[..., step, :].float() + _rb(_products(h, w)))
            i, f, g, o = gates.split(hidden, dim=-1)
            si, sf, tg, so = _sigmoid_scan(i), _sigmoid_scan(f), _rb(torch.tanh(g)), _sigmoid_scan(o)
            c = _rb(_rb(sf * c) + _rb(si * tg))
            h = _rb(so * _rb(torch.tanh(c)))
            hs[step], cs[step], acts[step] = h, c, torch.cat([si, sf, tg, so], dim=-1)
    bf = torch.bfloat16
    return (torch.stack(hs, dim=-2).to(bf), torch.stack(cs, dim=-2).to(bf), torch.stack(acts, dim=-2).to(bf),
            h.to(bf), c.to(bf))


def lstm_scan_bf16_ref(xproj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor | None = None,
                       c0: torch.Tensor | None = None, reverse: bool = False) -> torch.Tensor:
    """The hidden sequence (B, T, H), bfloat16, of ``lstm_scan_bf16_train_ref``."""
    return lstm_scan_bf16_train_ref(xproj, w_hh, h0, c0, reverse)[0]


def lstm_scan_bf16_backward_ref(w_hh: torch.Tensor, act: torch.Tensor, c_seq: torch.Tensor, c0: torch.Tensor | None,
                                dy: torch.Tensor, dhn: torch.Tensor | None = None, dcn: torch.Tensor | None = None,
                                reverse: bool = False):
    """The plain backward of the scan rounding -> (dxproj, dh0, dc0), all
    bfloat16, from the forward's residuals: the VJP ``jax.vjp`` builds for
    ``_lstm_scan`` in bfloat16 (logistic's rule g * s(1 - s), tanh's
    (g + g t)(1 - t) expanded as JAX's jaxpr has it), each op rounded as XLA
    rounds it, the carries dh and dc in bfloat16. Walking the steps in the
    reverse of the forward's order, with tc = rb(tanh(c_t)):

        dh = rb(dy_t + carry)                carry = rb(dgates_{t_next} @ w_hh^T)
        p = rb(rb(so dh) rb(1 - tc))         dc = rb(rb(dc + p) + rb(p tc))
        do = rb(rb(dh tc) rb(so (1 - so)))   di = rb(rb(dc tg) rb(si (1 - si)))
        q = rb(rb(si dc) rb(1 - tg))         dg = rb(q + rb(q tg))
        df = rb(rb(dc cprev) rb(sf (1 - sf)))  dc <- rb(sf dc)

    dxproj_t = [di, df, dg, do]. No dW: ``lstm_scan_bf16_weight_grad_ref``
    forms it from this dxproj where w_hh is trained (the Generator's default
    bfloat16 training), and a frozen w_hh (the d-vector) needs none.
    Measured on the CPU against ``jax.vjp`` under
    ``jax.jit``: bit-equal at B=8, T=24, H=32; 97.2-97.5% bit-equal at B=7,
    T=128, H=256 (float32 sums of another order), up to 1.6e-2 where the
    cotangents peak at 2.0. Torch autograd through the forward loop on
    bfloat16 tensors instead is 25% bit-equal, up to 3.1e-2 (its sigmoid and
    tanh backward round once, not at each op). Leading dims stack problems
    as in ``lstm_scan_bf16_train_ref``."""
    *lead, b, t, h4 = act.shape
    hidden = h4 // 4
    w = w_hh.float()
    act, c_seq = act.float(), c_seq.float()
    cprev_seq = _hprev(c_seq, None if c0 is None else _rb(c0.float()), reverse)
    carry = torch.zeros(*lead, b, hidden, device=act.device) if dhn is None else _rb(dhn.float())
    dc = torch.zeros(*lead, b, hidden, device=act.device) if dcn is None else _rb(dcn.float())
    dx = torch.empty((*lead, b, t, h4), device=act.device)
    with exact_f32(act.device):
        for step in (range(t) if reverse else range(t - 1, -1, -1)):
            si, sf, tg, so = act[..., step, :].split(hidden, dim=-1)
            tc = _rb(torch.tanh(c_seq[..., step, :]))
            dh = _rb(dy[..., step, :].float() + carry)
            p = _rb(_rb(so * dh) * _rb(1.0 - tc))
            dc = _rb(_rb(dc + p) + _rb(p * tc))
            d_o = _rb(_rb(dh * tc) * _dsigmoid_scan(so))
            di = _rb(_rb(dc * tg) * _dsigmoid_scan(si))
            q = _rb(_rb(si * dc) * _rb(1.0 - tg))
            dg = _rb(q + _rb(q * tg))
            df = _rb(_rb(dc * cprev_seq[..., step, :]) * _dsigmoid_scan(sf))
            dgates = torch.cat([di, df, dg, d_o], dim=-1)
            dx[..., step, :] = dgates
            carry = _rb(_products(dgates, w.transpose(-1, -2)))
            dc = _rb(sf * dc)
    bf = torch.bfloat16
    return dx.to(bf), carry.to(bf), dc.to(bf)


def lstm_scan_bf16_weight_grad_ref(h_seq: torch.Tensor, h0: torch.Tensor | None, dxproj: torch.Tensor,
                                   reverse: bool = False) -> torch.Tensor:
    """The plain dW_hh (H, 4H), bfloat16, of the scan rounding: the
    cotangent of w_hh that ``jax.vjp`` of ``_lstm_scan`` in bfloat16 gives
    under ``jit``. The scan's transpose carries it through the reversed loop
    (read from the compiled HLO on the CPU: a dot of the step's bfloat16
    gate gradients and hprev in float32, converted to bfloat16, added to the
    bfloat16 carry in float32 and converted again), so, walking the steps in
    the backward's order from a zero accumulator:

        dW = rb(dW + rb(hprev_t^T @ dxproj_t))     (float32 sums over B)

    hprev_t is the step's starting state (h0, or zero, then h_seq's
    neighbour), dxproj the bfloat16 gate gradients of
    ``lstm_scan_bf16_backward_ref``. Leading dims stack problems as there."""
    *lead, b, t, h4 = dxproj.shape
    hprev = _hprev(h_seq.float(), None if h0 is None else _rb(h0.float()), reverse)
    dx = dxproj.float()
    dw = torch.zeros(*lead, h4 // 4, h4, device=dxproj.device)
    with exact_f32(dxproj.device):
        for step in (range(t) if reverse else range(t - 1, -1, -1)):
            dw = _rb(dw + _rb(_products(hprev[..., step, :].transpose(-1, -2), dx[..., step, :])))
    return dw.to(torch.bfloat16)


# ------------------------------------------------------------- launch plans

SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90
SMS = 132  # SMs of an H100 SXM: the default where no card is asked
THREADS, ROWS_PER_THREAD, PAD = 256, 4, 4  # as in csrc/lstm_fwd.cu and csrc/lstm_bwd.cu
MAX_TILE_ROWS = 32  # batch rows staged at once in regime (b)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one sequence is launched (see the notes of csrc/lstm_fwd.cu).

    regime "a": w_hh fits one block; ``blocks`` blocks of ``rows`` batch rows
    each walk the sequence with all ``units`` = H units, no grid barrier.
    regime "b": ``blocks`` = H / ``units`` persistent blocks, each with its
    units' slice of w_hh, tiles of ``rows`` batch rows staged from global
    memory ``kc`` columns at a time, a grid barrier between steps.
    regime "c": as (b), but only the slice's first ``kres`` rows of K (a
    multiple of ``kc``) stay in shared memory; the rest is streamed from a
    copy in device memory, ``kc`` rows at a time, beside each staged chunk.
    ``smem`` is the dynamic shared memory of one block in bytes."""

    kind: str
    regime: str
    blocks: int
    units: int
    rows: int
    kc: int
    smem: int
    kres: int = 0


def _smem(kind: str, regime: str, hidden: int, units: int, rows: int, kc: int, wbytes: int = 4,
          kres: int = 0) -> int:
    """Shared bytes of a block, laid out as the kernels lay them out: w_hh's
    slice (K x NC, elements of ``wbytes`` bytes; in regime (c) its first
    ``kres`` rows and a ring of two chunks of ``kc`` rows), the staged rows
    and the partial sums of the K split (float32)."""
    k = hidden if kind == "fwd" else 4 * hidden
    nc = 4 * units if kind == "fwd" else -(-units // 4) * 4
    tasks = rows // ROWS_PER_THREAD * (nc // 4)
    staged = rows * (k + PAD) if regime == "a" else 2 * rows * (kc + PAD)
    resident = wbytes * (kres + 2 * kc) * nc if regime == "c" else wbytes * k * nc
    return resident + 4 * (staged + THREADS // tasks * rows * nc)


STREAM_SMEM = SMEM_MAX // 4  # regime (c): the bytes of a block its staged rows and its ring of w_hh chunks take at most


def pad_hidden(hidden: int, sms: int = SMS) -> int:
    """The width the kernels run an LSTM of ``hidden`` units at on a card of
    ``sms`` SMs: the next multiple of 8 (the kernels' 16-byte rows), or of
    16 where that width is past SCAN_BWD_MAX_HIDDEN or would need more than
    ``sms`` blocks of 8 units (the scan kernels then take 16 units a block).
    The added units are zero in every gate block (``pad_gates``): exact, in
    every rounding. The package's widths (32, 256, 512, 768, 1024) are
    their own."""
    width = -(-hidden // 8) * 8
    if width > SCAN_BWD_MAX_HIDDEN or width // 8 > sms:
        width = -(-hidden // 16) * 16
    return width


def pad_units(v: torch.Tensor | None, width: int, dim: int = -1) -> torch.Tensor | None:
    """(..., H, ...) -> (..., width, ...) along ``dim``, zeros appended (the
    state, the hidden sequences, w_hh's rows); ``v`` itself at H = width."""
    if v is None or v.shape[dim] == width:
        return v
    pad = list(v.shape)
    pad[dim] = width - v.shape[dim]
    return torch.cat([v, v.new_zeros(pad)], dim=dim)


def pad_gates(v: torch.Tensor, width: int) -> torch.Tensor:
    """(..., 4H) -> (..., 4 width): zero units appended inside each of the
    i, f, g, o blocks (xproj, the gate activations and gradients, w_hh's
    columns). A padded unit's preactivation is 0, so its c is 0.5·0 +
    0.5·tanh(0) = 0 and its h 0.5·tanh(0) = 0, exactly: it never reaches a
    real unit, whose values are the unpadded ones."""
    *lead, h4 = v.shape
    if h4 == 4 * width:
        return v
    return pad_units(v.reshape(*lead, 4, h4 // 4), width).reshape(*lead, 4 * width)


def strip_units(v: torch.Tensor | None, hidden: int, dim: int = -1) -> torch.Tensor | None:
    """The inverse of ``pad_units``: the first ``hidden`` of ``dim``, contiguous."""
    if v is None or v.shape[dim] == hidden:
        return v
    return v.narrow(dim, 0, hidden).contiguous()


def strip_gates(v: torch.Tensor | None, hidden: int) -> torch.Tensor | None:
    """The inverse of ``pad_gates``: each gate block's first ``hidden`` units."""
    if v is None or v.shape[-1] == 4 * hidden:
        return v
    *lead, h4 = v.shape
    return v.reshape(*lead, 4, h4 // 4)[..., :hidden].reshape(*lead, 4 * hidden)


def pad_w(w_hh: torch.Tensor, width: int) -> torch.Tensor:
    """w_hh (H, 4H) -> (width, 4 width): zero rows and zero gate columns."""
    return pad_gates(pad_units(w_hh, width, 0), width)


def strip_w(dw: torch.Tensor | None, hidden: int) -> torch.Tensor | None:
    """The inverse of ``pad_w`` (a dW_hh at the padded width)."""
    return None if dw is None else strip_gates(strip_units(dw, hidden, 0), hidden)


# A tensor's role in the padding: "u" H units on its last axis, "g" the 4H
# gates on its last axis, "w" w_hh or a dW_hh (H, 4H).
_PAD = {"u": pad_units, "g": pad_gates, "w": pad_w}
_STRIP = {"u": strip_units, "g": strip_gates, "w": strip_w}


def pad_all(roles: str, width: int, *vs: torch.Tensor | None) -> list:
    """Each of ``vs`` padded to ``width`` by its role (None stays None)."""
    return [None if v is None else _PAD[r](v, width) for r, v in zip(roles, vs, strict=True)]


def strip_all(roles: str, hidden: int, *vs: torch.Tensor | None) -> list:
    """The inverse of ``pad_all``."""
    return [_STRIP[r](v, hidden) for r, v in zip(roles, vs, strict=True)]


def _any_width(outs: str, **roles: str):
    """Let a kernel wrapper take any H: its tensor arguments named in
    ``roles`` (the first is the wrapper's first parameter, and gives H) are
    padded to ``_width``'s width and its outputs, of roles ``outs``, stripped
    back to H. At a width that is its own (every width on the CPU, the
    package's widths on the card) the wrapper runs on its arguments as they
    are, with no copy."""
    first, role0 = next(iter(roles.items()))

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def run(*args, **kwargs):
            v = args[0] if args else kwargs[first]
            hidden = v.shape[0] if role0 == "w" else v.shape[-1] // (4 if role0 == "g" else 1)
            width = _width(v, hidden)
            if width == hidden:
                return fn(*args, **kwargs)
            call = sig.bind(*args, **kwargs)
            names = [k for k in roles if k in call.arguments]
            padded = pad_all("".join(roles[k] for k in names), width, *(call.arguments[k] for k in names))
            call.arguments.update(zip(names, padded))
            out = fn(*call.args, **call.kwargs)
            if len(outs) == 1:
                return strip_all(outs, hidden, out)[0]
            return tuple(strip_all(outs[:len(out)], hidden, *out))
        return run
    return wrap


@functools.lru_cache(maxsize=None)
def launch_plan(batch: int, hidden: int, kind: str = "fwd", sms: int = SMS, wbytes: int = 4) -> LaunchPlan | None:
    """The launch plan of one forward (``kind="fwd"``) or backward ("bwd")
    sequence at (B, H) with w_hh in elements of ``wbytes`` bytes (4 float32,
    2 bfloat16: the bfloat16 forms), planned at ``pad_hidden(H, sms)``.
    Regime (a) where w_hh and the staged rows fit one block (the forward in
    float32 up to H=112, in bfloat16 up to H=160), else (b) with the fewest
    units per block (the most blocks, at most one per SM) where each block's
    slice fits its shared memory, else (c): (b)'s blocks with as much of
    their slice resident as shared memory holds beside a ring of two chunks
    (STREAM_SMEM for the ring and the staged rows), the rest streamed every
    step. Batch rows per block follow B, in steps of 4. None only where no
    split of the units gives at most ``sms`` blocks of at most THREADS."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind is 'fwd' or 'bwd', not {kind!r}")
    if wbytes not in (2, 4):
        raise ValueError(f"w_hh elements are 4 bytes (float32) or 2 (bfloat16), not {wbytes}")
    hidden = pad_hidden(hidden, sms)
    k = hidden if kind == "fwd" else 4 * hidden
    row_groups = -(-batch // ROWS_PER_THREAD)

    # at most THREADS row groups x units: the product's tasks and the cell
    # update's (row, unit) pairs, RB a thread, share the block's threads. In
    # regime (a) the blocks are independent, so as many as the SMs take, of
    # as few rows as that allows: a step's latency falls with its work
    if hidden <= THREADS:
        for rg in range(min(-(-row_groups // sms), THREADS // hidden), 0, -1):
            rows = rg * ROWS_PER_THREAD
            smem = _smem(kind, "a", hidden, hidden, rows, 0, wbytes)
            if smem <= SMEM_MAX:
                return LaunchPlan(kind, "a", -(-batch // rows), hidden, rows, 0, smem)
    for units in range(1, hidden + 1):
        if hidden % units or hidden // units > sms or units > THREADS:
            continue
        top = min(row_groups, MAX_TILE_ROWS // ROWS_PER_THREAD, THREADS // units)
        for rg in range(top, 0, -1):
            rows = rg * ROWS_PER_THREAD
            # what is left for the two staging buffers' rows of kc floats; a
            # chunk is a multiple of 32 floats, so that rows staged kc + PAD
            # apart fall in other banks
            room = SMEM_MAX - _smem(kind, "b", hidden, units, rows, 0, wbytes)
            kc_max = room // (4 * 2 * rows) // 32 * 32
            if kc_max < 32:
                continue
            chunks = -(-k // kc_max)
            kc = (-(-k // chunks) + 31) // 32 * 32
            return LaunchPlan(kind, "b", hidden // units, units, rows, kc,
                              _smem(kind, "b", hidden, units, rows, kc, wbytes))
    for units in range(1, min(hidden, THREADS) + 1):
        if hidden % units or hidden // units > sms:
            continue
        rows = min(row_groups, MAX_TILE_ROWS // ROWS_PER_THREAD, THREADS // units) * ROWS_PER_THREAD
        nc = 4 * units if kind == "fwd" else -(-units // 4) * 4
        # the chunk: the longest (a multiple of 32) whose ring and staged
        # rows take at most STREAM_SMEM, and no longer than K
        kc = max(32, min(STREAM_SMEM // (2 * (wbytes * nc + 4 * rows)) // 32 * 32, -(-k // 32) * 32))
        fixed = _smem(kind, "c", hidden, units, rows, kc, wbytes, 0)
        kres = min((SMEM_MAX - fixed) // (wbytes * nc) // kc * kc, k // kc * kc)
        if kres < 0:
            continue
        return LaunchPlan(kind, "c", hidden // units, units, rows, kc,
                          _smem(kind, "c", hidden, units, rows, kc, wbytes, kres), kres)
    return None


DW_TILE, DW_K_TILE, DW_BLOCKS_PER_SM = 128, 16, 2  # as in csrc/lstm_bwd.cu (lstm_dw_kernel)
DW_MIN_K_TILES = 4  # K tiles a split walks at least, so that its ring has work to overlap
DW_MAX_SPLITS = 32  # the last block of a tile reads every split's partial: keep that tail short


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """How the dW product of one sequence is launched (see the notes of
    ``lstm_dw_kernel`` in csrc/lstm_bwd.cu): ``tiles_m`` x ``tiles_n`` output
    tiles of DW_TILE x DW_TILE, each with K = B*T split into ``splits``
    chunks of ``chunk`` rows (a multiple of DW_K_TILE), one block a (tile,
    chunk); ``workspace`` floats of partial sums when ``splits`` > 1."""

    tiles_m: int
    tiles_n: int
    splits: int
    chunk: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits


@functools.lru_cache(maxsize=None)
def dw_plan(batch: int, time: int, hidden: int, sms: int = SMS) -> DwPlan:
    """The dW plan at (B, T, H) on a card of ``sms`` SMs: K is split only
    where the output tiles leave resident blocks (DW_BLOCKS_PER_SM an SM)
    idle, into as many chunks as fill them, each at least DW_MIN_K_TILES
    tiles of K rows long and at most DW_MAX_SPLITS of them (B=7, T=128:
    H=32, 1 tile, K = 896 in 14 chunks; H=512, 64 tiles, 4 chunks; H=1024,
    256 tiles, no split)."""
    k = batch * time
    tiles_m, tiles_n = -(-hidden // DW_TILE), -(-4 * hidden // DW_TILE)
    k_tiles = -(-k // DW_K_TILE)
    slots = DW_BLOCKS_PER_SM * sms
    splits = max(1, min(slots // (tiles_m * tiles_n), k_tiles // DW_MIN_K_TILES, DW_MAX_SPLITS))
    per_split = -(-k_tiles // splits)
    splits = -(-k_tiles // per_split)  # no chunk left empty
    workspace = splits * hidden * 4 * hidden if splits > 1 else 0
    return DwPlan(tiles_m, tiles_n, splits, per_split * DW_K_TILE, workspace)


GATES_ROWS, GATES_COLS = 128, 128  # as in csrc/lstm_gates.cu: rows a block, columns a wgmma
GATES_WIDE_BLOCKS = 100  # the blocks 128 x 256 tiles must still make (of the card's 132 SMs)


@dataclasses.dataclass(frozen=True)
class GatesPlan:
    """How the gates kernel tiles (B*T, 4H): blocks of GATES_ROWS steps of
    one batch row by ``nsub`` x GATES_COLS columns, ``blocks`` of them."""

    nsub: int
    blocks: int


@functools.lru_cache(maxsize=None)
def gates_plan(batch: int, time: int, hidden: int) -> GatesPlan:
    """The gates kernel's tile at (B, T, H): 128 x 256 where those tiles
    still number GATES_WIDE_BLOCKS (fewer L2 reads of each operand), else
    128 x 128 (B=7, T=128: H=1024 wide, 112 blocks; H=512 128 x 128, 112;
    H=32, 7); planned at H rounded up to 8, the padded width's."""
    hidden = -(-hidden // 8) * 8
    rows = batch * -(-time // GATES_ROWS)
    wide = rows * -(-4 * hidden // (2 * GATES_COLS))
    if wide >= GATES_WIDE_BLOCKS:
        return GatesPlan(2, wide)
    return GatesPlan(1, rows * -(-4 * hidden // GATES_COLS))


SCAN_MCOLS, SCAN_KATOM, SCAN_MAX_ROWS = 64, 64, 32  # as in csrc/lstm_scan_fwd.cu: wgmma's M, a swizzle atom's k
SCAN_MAX_PAIRS = 2  # (row, unit) pairs a thread in its cell update
SCAN_RED_PAD = 20  # floats added to a row of its sums


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How one sequence of the scan forward is launched (see the notes of
    csrc/lstm_scan_fwd.cu). regime "a" (H <= 32): ``blocks`` = ceil(B /
    ``rows``) blocks, each with all ``units`` = H units and ``rows`` batch
    rows, no grid barrier. regime "b": ``blocks`` = H / ``units``
    persistent blocks, each with its units' gate columns of w_hh, tiles of
    ``rows`` batch rows, a grid barrier between steps. regime "c": as (b),
    but each warpgroup keeps only the first ``kres`` 64-k atoms of its K
    half of W^T in shared memory and streams the rest, an atom at a time,
    through a ring of SCAN_RING slots. ``rows`` is the tensor-core
    product's N (a multiple of 8: 8 in regime (a), mma.sync's; wgmma's in
    regimes (b) and (c)); ``smem`` the dynamic shared bytes of a block."""

    regime: str
    blocks: int
    units: int
    rows: int
    smem: int
    kres: int = 0


SCAN_RING = 2  # regime (c): a warpgroup's ring slots of streamed W^T atoms


def _scan_smem(hidden: int, rows: int, m_tiles: int, parts: int, kres: int | None = None) -> int:
    """Shared bytes of a scan block, laid out as the kernel lays them out:
    1 KB of alignment slack, W^T (m_tiles x 64 columns x K bfloat16, K = H
    rounded up to 64; in regime (c), ``kres`` given, each K half's first
    ``kres`` atoms and its ring of SCAN_RING), the h tile (rows x 64
    bfloat16 an atom, two K halves of ceil(K / 128) atoms), the K parts'
    sums (``parts`` of rows x (64 m_tiles + SCAN_RED_PAD) floats) and the
    mbarriers (two; six in regime (c))."""
    atoms = -(-hidden // SCAN_KATOM)
    half = -(-atoms // 2)
    w_atoms = atoms if kres is None else min(kres, half) + min(kres, atoms - half) + 2 * SCAN_RING
    return (1024 + 2 * m_tiles * SCAN_MCOLS * w_atoms * SCAN_KATOM + 2 * rows * 2 * half * SCAN_KATOM
            + 4 * parts * rows * (SCAN_MCOLS * m_tiles + SCAN_RED_PAD) + (16 if kres is None else 16 + 32))


@functools.lru_cache(maxsize=None)
def scan_plan(batch: int, hidden: int, sms: int = SMS) -> ScanPlan | None:
    """The scan forward's plan at (B, ``pad_hidden(H, sms)``) on a card of
    ``sms`` SMs, or None for an empty batch or where even 16 units a block
    would outnumber the SMs. H <= 32: regime (a), 8 batch rows a block
    (mma.sync's N; the most blocks), all of K in one part of sums. Else
    regime (b), two K halves: 8 units a block (32 gate columns of wgmma's
    64: each thread updates one (row, unit) pair a step, which measured
    faster than 16 units' full 64 columns and two pairs a thread), or 16
    where H / 8 blocks would outnumber the SMs; one tile of B rows rounded
    up to 8 up to 32, else tiles of 32 (at H=1024, B=32: 128 blocks, 214
    KB each). Where W^T and the h tile overflow a block's shared memory,
    regime (c) with the same blocks and tiles: the atoms of W^T that fit
    stay, the rest stream (B=32: from H=1088)."""
    if batch <= 0:
        return None
    hidden = pad_hidden(hidden, sms)
    if hidden <= 32:
        rows = 8
        return ScanPlan("a", -(-batch // rows), hidden, rows,
                        _scan_smem(hidden, rows, -(-4 * hidden // SCAN_MCOLS), 1))
    units = 8 if hidden // 8 <= sms else 16
    rows = min(SCAN_MAX_ROWS, -(-batch // 8) * 8)
    if hidden % units or hidden // units > sms:
        return None
    smem = _scan_smem(hidden, rows, 1, 2)
    if smem <= SMEM_MAX:
        return ScanPlan("b", hidden // units, units, rows, smem)
    atom = 2 * SCAN_MCOLS * SCAN_KATOM
    kres = max(0, (SMEM_MAX - _scan_smem(hidden, rows, 1, 2, 0)) // atom // 2)
    smem = _scan_smem(hidden, rows, 1, 2, kres)
    return ScanPlan("c", hidden // units, units, rows, smem, kres) if smem <= SMEM_MAX else None


SCAN_BWD_UNITS, SCAN_BWD_ROWS_A = 8, 8  # as in csrc/lstm_scan_bwd.cu: regime (b)'s units a block, (a)'s rows
SCAN_BWD_SUMS = 8 * 16 * SCAN_BWD_UNITS  # regime (b)'s floats of the warps' sums: 8 warps x 16 rows x the units
SCAN_BWD_MAX_HIDDEN = 1024  # its regime (b)'s W^T fragments in registers: 32 k16 steps a warp at most
SCAN_BWD_C_UNITS = 16  # regime (c): units a block, two mma.sync n8 groups
SCAN_BWD_FRAG = 8 * 2 * 32 * 8  # regime (c): bytes of the eight warps' W^T fragments of one k16 step


@dataclasses.dataclass(frozen=True)
class ScanBwdPlan:
    """How one sequence of the scan backward is launched (see the notes of
    csrc/lstm_scan_bwd.cu). regime "a" (H <= 32): ``blocks`` = ceil(B / 8)
    blocks of H / 8 warps, each with all ``units`` = H units and ``rows`` = 8
    batch rows, no grid barrier. regime "b": ``blocks`` = H / 8 persistent
    blocks of 256 threads, 8 ``units`` each, batch tiles of ``rows`` (8 for
    B <= 8, else 16: mma.sync's M), a grid barrier between steps. regime
    "c" (past regime (b)'s registers): H / 16 such blocks of 16 units, batch
    tiles of 8 rows, each warp's first ``kres`` k16 steps of W^T's
    fragments in shared memory, the rest read from a copy in device memory
    every step. ``smem`` the dynamic shared bytes of a block."""

    regime: str
    blocks: int
    units: int
    rows: int
    smem: int
    kres: int = 0


def _scan_bwd_steps(hidden: int) -> int:
    """The k16 steps of K = 4H a warp of the scan backward takes: whole
    eights, an equal number for each of the 8 warps."""
    eights = -(-(hidden // 4) // 8)
    return 8 * -(-eights // 8)


def _scan_bwd_smem(regime: str, batch: int, hidden: int, rows: int, kres: int = 0) -> int:
    """Shared bytes of a scan backward block, as the kernel lays them out: 1
    KB of alignment slack; (a) two dgates tiles of ceil(4H / 64) atoms of 8
    rows x 128 bytes and a 128-byte zero line; (b) and (c) the tile's two K
    halves of ceil(atoms / 2) atoms of ``rows`` x 128 bytes, the zero line,
    the eight warps' sums (16 x units floats each), dc of the block's (row,
    unit) pairs and two mbarriers; (c) then the warps' resident fragments,
    ``kres`` k16 steps each."""
    atoms = -(-4 * hidden // SCAN_KATOM)
    if regime == "a":
        return 1024 + 2 * atoms * SCAN_BWD_ROWS_A * 128 + 128
    tiles = -(-batch // rows)
    units = SCAN_BWD_UNITS if regime == "b" else SCAN_BWD_C_UNITS
    return (1024 + 2 * (-(-atoms // 2)) * rows * 128 + 128 + 4 * (8 * 16 * units + tiles * rows * units) + 16
            + kres * SCAN_BWD_FRAG)


@functools.lru_cache(maxsize=None)
def scan_bwd_plan(batch: int, hidden: int, sms: int = SMS) -> ScanBwdPlan | None:
    """The scan backward's plan at (B, ``pad_hidden(H, sms)``) on a card of
    ``sms`` SMs, or None for an empty batch or where H / 16 blocks would
    outnumber the SMs. H <= 32: regime (a), 8 batch rows a block. Else
    regime (b) up to SCAN_BWD_MAX_HIDDEN where H / 8 blocks fit the SMs: H
    / 8 blocks (at most one an SM), batch tiles of 8 rows for B <= 8, else
    16 (B=7: H=1024 128 blocks of 71 KB, H=512 64 of 38 KB). Else regime
    (c): H / 16 blocks, tiles of 8 rows, as many k16 steps of each warp's
    fragments resident as shared memory holds, in eights."""
    if batch <= 0:
        return None
    hidden = pad_hidden(hidden, sms)
    if hidden <= 32:
        rows = SCAN_BWD_ROWS_A
        return ScanBwdPlan("a", -(-batch // rows), hidden, rows, _scan_bwd_smem("a", batch, hidden, rows))
    if hidden <= SCAN_BWD_MAX_HIDDEN and hidden // SCAN_BWD_UNITS <= sms:
        rows = 8 if batch <= 8 else 16
        smem = _scan_bwd_smem("b", batch, hidden, rows)
        if smem <= SMEM_MAX:
            return ScanBwdPlan("b", hidden // SCAN_BWD_UNITS, SCAN_BWD_UNITS, rows, smem)
    if hidden % SCAN_BWD_C_UNITS or hidden // SCAN_BWD_C_UNITS > sms:
        return None
    rows = 8
    room = SMEM_MAX - _scan_bwd_smem("c", batch, hidden, rows)
    if room < 0:
        return None
    kres = min(_scan_bwd_steps(hidden), room // SCAN_BWD_FRAG // 8 * 8)
    return ScanBwdPlan("c", hidden // SCAN_BWD_C_UNITS, SCAN_BWD_C_UNITS, rows,
                       _scan_bwd_smem("c", batch, hidden, rows, kres), kres)


SCAN_DW_WARPS = 4  # as in csrc/lstm_scan_dw.cu: warps a block
# a block's tile, in 8 units by 32 gate columns, largest first
SCAN_DW_PATCHES = ((8, 8), (4, 4), (2, 2), (1, 1))
SCAN_DW_MAX_SLOTS = 32  # slots a buffer of its ring holds at most
SCAN_DW_SMEM = 100 * 1024  # its shared bytes at most: two blocks an SM
SCAN_DW_MAX_ROWS = 256  # batch rows of a TMA box at most


@dataclasses.dataclass(frozen=True)
class ScanDwPlan:
    """How the scan dW (csrc/lstm_scan_dw.cu) is launched: each block owns
    a tile of 8·``mi`` hidden units by 32·``nj`` gate columns (a thread mi
    units by 2·nj columns); ``blocks`` blocks, ``warps`` warps in all; a
    step's batch staged as ``slabs`` boxes of ``rows`` rows (the last zero-
    filled past B), a slot of the ring each; ``slots`` slots in each of the
    ring's two buffers; ``smem`` the dynamic shared bytes of a block."""

    mi: int
    nj: int
    rows: int
    slabs: int
    blocks: int
    warps: int
    slots: int
    smem: int


def _scan_dw_smem(rows: int, mi: int, nj: int, slots: int) -> int:
    """Shared bytes of a scan dW block, as the kernel lays them out: 128
    bytes of alignment slack, two buffers of ``slots`` slots' boxes (``rows``
    batch rows of the tile's 8·mi bfloat16 units, and of its 32·nj gate
    columns, each box rounded up to 128 bytes) and two mbarriers."""
    boxes = -(-rows * 16 * mi // 128) * 128 + -(-rows * 64 * nj // 128) * 128
    return 128 + 2 * slots * boxes + 16


@functools.lru_cache(maxsize=None)
def scan_dw_plan(batch: int, time: int, hidden: int, sms: int = SMS) -> ScanDwPlan | None:
    """The scan dW's plan at (B, T, H rounded up to 8: the padded width's)
    on a card of ``sms`` SMs, or None for an empty batch or sequence. The
    tile: the largest of SCAN_DW_PATCHES whose warps
    still number 4 an SM (one a sub-partition), else the smallest. A step's
    batch: one box of B rows where it fits SCAN_DW_MAX_ROWS and, twice (the
    ring's two buffers), SCAN_DW_SMEM; else the fewest slabs of equal rows
    that do, in a tile no wider than 128 columns (a thread's sums then one
    run of columns, carried from slab to slab); a wider tile whose step does
    not fit gives way to the next smaller. The most slots a buffer, up to
    SCAN_DW_MAX_SLOTS and the sequence's, in SCAN_DW_SMEM (B=7, T=128:
    H=1024 64 x 256 tiles, 256 blocks, 11 slots; H=512 32 x 128, 256 blocks,
    22; H=32 8 x 32, 16 blocks, 32; B=96 at H=1024: 32 x 128 tiles, one box
    a step; B=300 there: two boxes of 150 rows a step)."""
    if batch <= 0 or time <= 0:
        return None
    hidden = -(-hidden // 8) * 8
    first = next((k for k, (mi, nj) in enumerate(SCAN_DW_PATCHES)
                  if -(-hidden // (8 * mi)) * -(-4 * hidden // (32 * nj)) * SCAN_DW_WARPS >= 4 * sms),
                 len(SCAN_DW_PATCHES) - 1)
    for mi, nj in SCAN_DW_PATCHES[first:]:
        slabs = -(-batch // SCAN_DW_MAX_ROWS)
        while _scan_dw_smem(-(-batch // slabs), mi, nj, 1) > SCAN_DW_SMEM:  # one row always fits
            slabs += 1
        rows = -(-batch // slabs)
        slabs = -(-batch // rows)
        if slabs > 1 and nj > 4:
            continue
        fixed = _scan_dw_smem(rows, mi, nj, 0)
        slots = min(SCAN_DW_MAX_SLOTS, time * slabs, (SCAN_DW_SMEM - fixed) // (_scan_dw_smem(rows, mi, nj, 1) - fixed))
        blocks = -(-hidden // (8 * mi)) * -(-4 * hidden // (32 * nj))
        return ScanDwPlan(mi, nj, rows, slabs, blocks, blocks * SCAN_DW_WARPS, slots,
                          _scan_dw_smem(rows, mi, nj, slots))
    return None


# ------------------------------------------------------------- the kernels

def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    pointers, ints, tail = ctypes.c_void_p, ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]
    if name == "lstm_fwd":
        lib.autovc_lstm_fwd.argtypes = [pointers] * 8 + [ints] * 11 + tail
        lib.autovc_lstm_fwd_bf16.argtypes = [pointers] * 9 + [ints] * 11 + tail
        entries = (lib.autovc_lstm_fwd, lib.autovc_lstm_fwd_bf16)
    elif name == "lstm_scan_fwd":
        lib.autovc_lstm_scan_fwd.argtypes = [pointers] * 9 + [ints] * 10 + tail
        entries = (lib.autovc_lstm_scan_fwd,)
    elif name == "lstm_gates":
        lib.autovc_lstm_gates.argtypes = [pointers] * 5 + [ints] * 5 + [pointers]
        entries = (lib.autovc_lstm_gates,)
    elif name == "lstm_scan_bwd":
        lib.autovc_lstm_scan_bwd.argtypes = [pointers] * 10 + [ints] * 10 + tail
        entries = (lib.autovc_lstm_scan_bwd,)
    elif name == "lstm_scan_dw":
        lib.autovc_lstm_scan_dw.argtypes = [pointers] * 4 + [ints] * 11 + tail
        entries = (lib.autovc_lstm_scan_dw,)
    else:
        lib.autovc_lstm_bwd.argtypes = [pointers] * 10 + [ints] * 11 + tail
        lib.autovc_lstm_bwd_bf16.argtypes = [pointers] * 11 + [ints] * 11 + tail
        lib.autovc_lstm_dw.argtypes = [pointers] * 6 + [ints] * 7 + [pointers]
        entries = (lib.autovc_lstm_bwd, lib.autovc_lstm_bwd_bf16, lib.autovc_lstm_dw)
    for fn in entries:
        fn.restype = ctypes.c_int
    lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.autovc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_dtypes(xproj: torch.Tensor, w_hh: torch.Tensor) -> None:
    """bfloat16 xproj and w_hh come together or not at all."""
    if (xproj.dtype == torch.bfloat16) != (w_hh.dtype == torch.bfloat16):
        raise TypeError(f"mixed dtypes: xproj {xproj.dtype} and w_hh {w_hh.dtype} (bfloat16 takes both)")


# The tensors the bfloat16 forms take in bfloat16 (dxproj: the scan dW's
# bfloat16 gate gradients); the rest (the state, c_seq, the gate activations
# and gradients, the cotangents of hN and cN) float32.
_BF16_OPERANDS = ("xproj", "w_hh", "h_seq", "dy", "dxproj")


def _check(xproj: torch.Tensor, w_hh: torch.Tensor | None, kind: str = "fwd", first: str = "xproj",
           **others: torch.Tensor | None) -> tuple[int, int, int, LaunchPlan | None]:
    """Validate what a kernel takes, before it is built: float32 throughout,
    or the bfloat16 form (``_BF16_OPERANDS`` in bfloat16, the rest float32);
    the first tensor, named ``first``, (B, T, 4H) and w_hh (H, 4H), the
    named (B, H), (B, T, H) and (B, T, 4H) tensors of matching shape, all on
    one CUDA device. Returns (B, T, H) and, when w_hh is given, the ``kind``
    launch plan at the card's SM count. The wrappers call it at the padded
    width (``pad_hidden``), where every plan exists."""
    b, t, h4 = xproj.shape
    hidden = h4 // 4
    given = {first: xproj, "w_hh": w_hh, **others}
    given = {k: v for k, v in given.items() if v is not None}
    bf16 = any(v.dtype == torch.bfloat16 for v in given.values())
    if w_hh is not None and first == "xproj":
        _check_dtypes(xproj, w_hh)
    for name, v in given.items():
        if v.dtype != (torch.bfloat16 if bf16 and name in _BF16_OPERANDS else torch.float32):
            raise TypeError(f"lstm kernels take float32, or {', '.join(_BF16_OPERANDS)} in bfloat16 and the rest "
                            f"in float32, got {name} {v.dtype}")
    if h4 % 4 or (w_hh is not None and w_hh.shape != (hidden, h4)):
        raise ValueError(f"shapes do not match: {first} {tuple(xproj.shape)}, "
                         f"w_hh {None if w_hh is None else tuple(w_hh.shape)}")
    plan = None if w_hh is None else _plan_on_card(b, hidden, kind, xproj.device, 2 if bf16 else 4)
    for name, v in others.items():
        want = ((b, hidden) if name in ("h0", "c0", "dhn", "dcn")
                else (b, t, h4) if name in ("gates", "dgates") else (b, t, hidden))
        if v is not None and tuple(v.shape) != want:
            raise ValueError(f"{name} is {tuple(v.shape)}, expected {want}")
    devices = {v.device for v in given.values()}
    if len(devices) != 1 or xproj.device.type != "cuda":
        raise ValueError(f"lstm kernels take tensors on one CUDA device, got {sorted(map(str, devices))}")
    return b, t, hidden, plan


def _ptr(v: torch.Tensor | None) -> int | None:
    """The data pointer of a contiguous, 16-byte aligned tensor (the kernels
    load float4), or None for an absent one."""
    if v is None:
        return None
    if not v.is_contiguous() or v.data_ptr() % 16:
        raise ValueError("kernel operand is not contiguous and 16-byte aligned")
    return v.data_ptr()


def _dense(v: torch.Tensor | None) -> torch.Tensor | None:
    """A contiguous, 16-byte aligned copy of ``v`` when it is not one already."""
    if v is None:
        return None
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _raise_on(lib: ctypes.CDLL, err: int, what: str,
              plan: LaunchPlan | DwPlan | GatesPlan | ScanPlan | ScanBwdPlan | ScanDwPlan | None = None,
              info=None) -> None:
    if err == _ERR_PLAN:
        raise RuntimeError(f"{what}: the kernel refused the launch plan {plan}")
    if err == _ERR_TMA:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled (found in the loaded libcuda.so.1) refused the tensor maps")
    if err == _ERR_RESIDENT:
        raise RuntimeError(f"{what}: {plan.blocks} blocks must be resident for the grid barrier, but the card "
                           f"holds {info[0]} per SM on {info[1]} SMs")
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.autovc_cuda_error_string(err).decode()}")


_ERR_PLAN, _ERR_RESIDENT, _ERR_TMA = -1, -2, -3  # the launchers' own codes
# The last launch of each kind: (plan, resident blocks per SM, SMs), for
# chip_smoke.py's report.
last_launch: dict[str, tuple[LaunchPlan | ScanPlan | ScanBwdPlan | ScanDwPlan, int, int]] = {}


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _sms_of(device: torch.device) -> int:
    """The SM count of the card a tensor lies on; an H100's, ``SMS``, for a
    tensor elsewhere (which ``_check`` refuses)."""
    return _card_sms(_index(device)) if device.type == "cuda" else SMS


def _width(v: torch.Tensor, hidden: int) -> int:
    """The width the kernels take an LSTM of ``hidden`` units at, for
    tensors on v's device: ``pad_hidden`` at the card's SM count; a CPU
    tensor's own (the plain versions take any width; ``_check`` refuses it
    for the kernels)."""
    return pad_hidden(hidden, _sms_of(v.device)) if v.device.type == "cuda" else hidden


def _plan_on_card(b: int, hidden: int, kind: str, device: torch.device, wbytes: int = 4) -> LaunchPlan:
    """The ``kind`` launch plan at the SM count of the card the tensors lie
    on. Raises unless the forward and the backward both have one, so that no
    forward trains into a backward that cannot launch (every width of at
    most THREADS units a block for each of the SMs has both)."""
    sms = _sms_of(device)
    plan = launch_plan(b, hidden, kind, sms, wbytes)
    if plan is None or launch_plan(b, hidden, "bwd" if kind == "fwd" else "fwd", sms, wbytes) is None:
        raise ValueError(f"lstm kernels split H={hidden} into at most {sms} blocks of at most {THREADS} units: "
                         f"no split on this card of {sms} SMs")
    return plan


_REGIMES = {"a": 0, "b": 1, "c": 2}  # the launchers' regime codes


def _stream_buffer(plan: LaunchPlan, hidden: int, w_hh: torch.Tensor) -> torch.Tensor | None:
    """Regime (c)'s copy of the streamed rows of each block's slice of w_hh
    (its K - kres rows x NC columns, in w_hh's dtype), which the kernel
    writes at its start and streams from every step; None in (a) and (b)."""
    if plan.regime != "c":
        return None
    k = hidden if plan.kind == "fwd" else 4 * hidden
    nc = 4 * plan.units if plan.kind == "fwd" else -(-plan.units // 4) * 4
    return torch.empty(plan.blocks * (k - plan.kres) * nc, device=w_hh.device, dtype=w_hh.dtype)


def _launch(lib: ctypes.CDLL, fn, plan: LaunchPlan, pointers: list, shape: tuple, what: str) -> None:
    info = (ctypes.c_int * 2)(0, 0)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*pointers, *shape, _REGIMES[plan.regime], plan.blocks, plan.units, plan.rows, plan.kc, plan.kres,
             plan.smem, info, stream)
    last_launch[plan.kind] = (plan, info[0], info[1])
    _raise_on(lib, err, what, plan, info)
    _count_regime(plan.kind, plan.regime)


def _count_regime(kind: str, regime: str) -> None:
    key = f"{kind}_{regime}"
    regime_launches[key] = regime_launches.get(key, 0) + 1


@_any_width("uuuug", xproj="g", w_hh="w", h0="u", c0="u")
def lstm_forward_cuda(xproj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor | None = None,
                      c0: torch.Tensor | None = None, reverse: bool = False, with_cseq: bool = False,
                      with_gates: bool = False):
    """Launch the forward kernel on the current stream (no synchronisation),
    one launch for the sequence -> (h_seq, c_seq or None, hN, cN), and the
    gate activations (B, T, 4H) after them when ``with_gates``. hN is
    h_seq's last step. bfloat16 xproj and w_hh launch the bfloat16 form:
    h_seq in bfloat16, the state (h0, c0 in; c_seq, hN, cN out) in float32,
    and no gate activations (its backward recomputes them from the rounded
    h_seq: ``lstm_gates_cuda``). Any H (``_any_width``)."""
    global launches
    if xproj.dtype == torch.bfloat16 and with_gates:
        raise ValueError("the bfloat16 forward keeps no gate activations: its backward recomputes them from the "
                         "rounded h_seq (lstm_gates_cuda)")
    b, t, hidden, plan = _check(xproj, w_hh, "fwd", h0=h0, c0=c0)
    if xproj.dtype == torch.bfloat16:
        return _forward_bf16(xproj, w_hh, h0, c0, reverse, with_cseq, b, t, hidden, plan)
    lib = _library("lstm_fwd")
    xproj, w_hh, h0 = _dense(xproj), _dense(w_hh), _dense(h0)
    wst = _stream_buffer(plan, hidden, w_hh)
    h_seq = torch.empty((b, t, hidden), device=xproj.device, dtype=torch.float32)
    c_seq = torch.empty_like(h_seq) if with_cseq else None
    gates = torch.empty_like(xproj) if with_gates else None
    c = torch.zeros((b, hidden), device=xproj.device, dtype=torch.float32) if c0 is None else _dense(c0).clone()
    with torch.cuda.device(xproj.device):
        _launch(lib, lib.autovc_lstm_fwd, plan, [_ptr(v) for v in (xproj, w_hh, h0, h_seq, c, c_seq, gates, wst)],
                (b, t, hidden, int(reverse)), "lstm forward kernel")
    launches += 1
    out = (h_seq, c_seq, h_seq[:, 0 if reverse else -1].clone(), c)
    return out + (gates,) if with_gates else out


def _forward_bf16(xproj, w_hh, h0, c0, reverse, with_cseq, b, t, hidden, plan):
    """The bfloat16 form's launch: h_seq in bfloat16, (h, c) carried in
    float32 from (h0, c0), exchanged in regimes (b) and (c) through a float32 (2, B, H)
    buffer; c_seq (the training form) and hN, cN in float32."""
    global launches, bf16_launches
    lib = _library("lstm_fwd")
    xproj, w_hh, h0 = _dense(xproj), _dense(w_hh), _dense(h0)
    dev = xproj.device
    h_seq = torch.empty((b, t, hidden), device=dev, dtype=torch.bfloat16)
    c_seq = torch.empty((b, t, hidden), device=dev, dtype=torch.float32) if with_cseq else None
    c = torch.zeros((b, hidden), device=dev, dtype=torch.float32) if c0 is None else _dense(c0).clone()
    hn = torch.empty((b, hidden), device=dev, dtype=torch.float32)
    hbuf = torch.empty((2, b, hidden), device=dev, dtype=torch.float32) if plan.regime != "a" else None
    wst = _stream_buffer(plan, hidden, w_hh)
    with torch.cuda.device(dev):
        _launch(lib, lib.autovc_lstm_fwd_bf16, plan,
                [_ptr(v) for v in (xproj, w_hh, h0, h_seq, hbuf, c, c_seq, hn, wst)],
                (b, t, hidden, int(reverse)), "lstm forward kernel (bfloat16)")
    launches += 1
    bf16_launches += 1
    return h_seq, c_seq, hn, c


def lstm_sequence_cuda(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
                       scan: bool = False) -> torch.Tensor:
    """The inference form from a zero state: the hidden sequence only
    (``scan``: the scan rounding's form)."""
    if scan:
        return lstm_scan_forward_cuda(xproj, w_hh, reverse=reverse)[0]
    return lstm_forward_cuda(xproj, w_hh, reverse=reverse)[0]


def _scan_state(v: torch.Tensor | None, name: str) -> torch.Tensor | None:
    """A bfloat16 state of the scan form as the float32 the kernels read."""
    if v is not None and v.dtype != torch.bfloat16:
        raise TypeError(f"the scan form's {name} is bfloat16, got {v.dtype}")
    return None if v is None else v.float()


@_any_width("uuguu", xproj="g", w_hh="w", h0="u", c0="u")
def lstm_scan_forward_cuda(xproj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor | None = None,
                           c0: torch.Tensor | None = None, reverse: bool = False, with_residuals: bool = False):
    """Launch ``csrc/lstm_scan_fwd.cu`` (the rounding of
    ``lstm_scan_bf16_train_ref``, its product on the tensor cores) on the
    current stream, one launch for the sequence -> (h_seq, c_seq, act, hN,
    cN): bfloat16 xproj, w_hh and state (h0, c0, zero when None), h_seq, hN
    and cN in bfloat16; with ``with_residuals`` the backward's residuals
    c_seq (B, T, H) and act (B, T, 4H) = [si, sf, tg, so], float32 tensors
    that hold bfloat16 values, else None for both; launched as ``scan_plan``
    plans it at the card's SM count (the kernel refuses a plan that does not
    fit the shapes). With ``with_residuals`` (training) it raises where the
    scan backward could not launch at this shape, before the forward runs.
    Any H (``_any_width``)."""
    global launches, scan_launches
    if xproj.dtype != torch.bfloat16:
        raise TypeError(f"the scan form takes bfloat16 xproj and w_hh, got {xproj.dtype}")
    h0, c0 = _scan_state(h0, "h0"), _scan_state(c0, "c0")
    b, t, hidden, _ = _check(xproj, w_hh, "bwd", h0=h0, c0=c0)
    if with_residuals:
        _scan_bwd_plan_on_card(b, hidden, xproj.device)
    sms = _card_sms(_index(xproj.device))
    plan = scan_plan(b, hidden, sms)
    if plan is None:
        raise ValueError(f"the scan forward takes at most 16 units a block, one block an SM: H={hidden} needs "
                         f"more than the {sms} SMs of this card")
    lib = _library("lstm_scan_fwd")
    xproj, w_hh = _dense(xproj), _dense(w_hh)
    dev = xproj.device
    h0 = None if h0 is None else _dense(h0.to(torch.bfloat16))
    h_seq = torch.empty((b, t, hidden), device=dev, dtype=torch.bfloat16)
    c_seq = torch.empty((b, t, hidden), device=dev, dtype=torch.float32) if with_residuals else None
    act = torch.empty((b, t, 4 * hidden), device=dev, dtype=torch.float32) if with_residuals else None
    c = torch.zeros((b, hidden), device=dev, dtype=torch.float32) if c0 is None else _dense(c0).clone()
    hbuf = wst = None
    if plan.regime != "a":  # the exchange buffer, rows padded to 64 with zeros; step 0 reads h0 from its half 1
        hbuf = torch.zeros((2, b, -(-hidden // SCAN_KATOM) * SCAN_KATOM), device=dev, dtype=torch.bfloat16)
        if h0 is not None:
            hbuf[1, :, :hidden].copy_(h0)
    if plan.regime == "c":  # the streamed W^T atoms of every block (64 x 64 bfloat16 each), written by the kernel
        atoms = -(-hidden // SCAN_KATOM)
        half = -(-atoms // 2)
        streamed = atoms - min(plan.kres, half) - min(plan.kres, atoms - half)
        wst = torch.empty(plan.blocks * streamed * SCAN_MCOLS * SCAN_KATOM, device=dev, dtype=torch.bfloat16)
    info = (ctypes.c_int * 2)(0, 0)
    with torch.cuda.device(dev):
        err = lib.autovc_lstm_scan_fwd(*[_ptr(v) for v in (xproj, w_hh, h0, h_seq, hbuf, c, c_seq, act, wst)], b, t,
                                       hidden, int(reverse), _REGIMES[plan.regime], plan.blocks, plan.units,
                                       plan.rows, plan.kres, plan.smem, info, torch.cuda.current_stream().cuda_stream)
    last_launch["scan_fwd"] = (plan, info[0], info[1])
    _raise_on(lib, err, "lstm scan forward kernel", plan, info)
    _count_regime("scan_fwd", plan.regime)
    launches += 1
    scan_launches += 1
    return h_seq, c_seq, act, h_seq[:, 0 if reverse else -1].clone(), c.to(torch.bfloat16)


@_any_width("guu", w_hh="w", act="g", c_seq="u", c0="u", dy="u", dhn="u", dcn="u")
def lstm_scan_backward_cuda(w_hh: torch.Tensor, act: torch.Tensor, c_seq: torch.Tensor, c0: torch.Tensor | None,
                            dy: torch.Tensor, dhn: torch.Tensor | None = None, dcn: torch.Tensor | None = None,
                            reverse: bool = False):
    """Launch ``csrc/lstm_scan_bwd.cu`` (the rounding of
    ``lstm_scan_bf16_backward_ref``, its dh product on the tensor cores) on
    the current stream: the reversed recurrence and dh0 in one launch of
    ``scan_bwd_plan`` at the card's SM count -> (dxproj, dh0, dc0),
    bfloat16. No dW: ``LSTMSequenceFn`` launches ``lstm_scan_weight_grad_cuda``
    on this dxproj where w_hh requires grad (the Generator's training), and
    nothing for a frozen w_hh (the d-vector). ``act`` and ``c_seq`` are
    ``lstm_scan_forward_cuda``'s residuals; w_hh, dy and the state's
    cotangents (zero when None) bfloat16. Any H (``_any_width``)."""
    global bwd_launches, scan_bwd_launches
    if act.dtype != torch.float32 or c_seq.dtype != torch.float32:
        raise TypeError("the scan backward reads the scan forward's residuals (float32 tensors of bfloat16 values)")
    c0, dhn, dcn = _scan_state(c0, "c0"), _scan_state(dhn, "dhN"), _scan_state(dcn, "dcN")
    b, t, hidden, _ = _check(act, w_hh, "bwd", first="gates", c0=c0, c_seq=c_seq, dy=dy, dhn=dhn, dcn=dcn)
    plan = _scan_bwd_plan_on_card(b, hidden, act.device)
    lib = _library("lstm_scan_bwd")
    w_hh, act, c0, c_seq, dy, dhn = map(_dense, (w_hh, act, c0, c_seq, dy, dhn))
    dev = act.device
    # 64 elements past the end: the kernel's copies read whole 64-k atoms of the last row
    n = b * t * 4 * hidden
    dx = torch.empty(n + SCAN_KATOM, device=dev, dtype=torch.bfloat16)[:n].view(b, t, 4 * hidden)
    dc = torch.zeros((b, hidden), device=dev, dtype=torch.float32) if dcn is None else _dense(dcn).clone()
    dh0 = torch.empty((b, hidden), device=dev, dtype=torch.float32)
    # regime (c): the streamed k16 steps' W^T fragments of every block's eight warps (two n8 groups), which the
    # kernel writes at its start
    wst = None
    if plan.regime == "c":
        wst = torch.empty(plan.blocks * (_scan_bwd_steps(hidden) - plan.kres) * SCAN_BWD_FRAG // 2 + 8, device=dev,
                          dtype=torch.bfloat16)
    info = (ctypes.c_int * 2)(0, 0)
    with torch.cuda.device(dev):
        err = lib.autovc_lstm_scan_bwd(*[_ptr(v) for v in (act, w_hh, c0, c_seq, dy, dhn, dx, dc, dh0, wst)], b, t,
                                       hidden, int(reverse), _REGIMES[plan.regime], plan.blocks, plan.units, plan.rows,
                                       plan.kres, plan.smem, info, torch.cuda.current_stream().cuda_stream)
    last_launch["scan_bwd"] = (plan, info[0], info[1])
    _raise_on(lib, err, "lstm scan backward kernel", plan, info)
    _count_regime("scan_bwd", plan.regime)
    bwd_launches += 1
    scan_bwd_launches += 1
    return dx, dh0.to(torch.bfloat16), dc.to(torch.bfloat16)


def _scan_bwd_plan_on_card(b: int, hidden: int, device: torch.device) -> ScanBwdPlan:
    """``scan_bwd_plan`` at the SM count of the card the tensors lie on;
    raises where there is none."""
    sms = _card_sms(_index(device))
    plan = scan_bwd_plan(b, hidden, sms)
    if plan is None:
        raise ValueError(f"the scan backward takes at most 16 units a block, one block an SM: H={hidden} needs more "
                         f"than the {sms} SMs of this card")
    return plan


# The split dW's tile counters of each (device, stream): zero, and left zero
# by every launch, so that calls on one stream, which run in order, share
# them without a fill kernel a call.
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _dw_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    if key not in _counters or _counters[key].numel() < n:
        _counters[key] = torch.zeros(max(n, 256), device=device, dtype=torch.int32)
    return _counters[key]


@_any_width("w", h_seq="u", h0="u", dxproj="g")
def lstm_weight_grad_cuda(h_seq: torch.Tensor, h0: torch.Tensor | None, dxproj: torch.Tensor,
                          reverse: bool = False) -> torch.Tensor:
    """Launch the dW kernel: (H, 4H) = sum over (b, t) of hprev^T dxproj,
    one launch of ``dw_plan`` at the card's SM count. dxproj is float32 (in
    the bfloat16 form the float32 gate gradients); a bfloat16 h_seq gives
    dW rounded once to bfloat16. Any H (``_any_width``)."""
    global dw_launches
    b, t, hidden, _ = _check(dxproj, None, first="dgates", h_seq=h_seq, h0=h0)
    plan = dw_plan(b, t, hidden, _card_sms(_index(dxproj.device)))
    lib = _library("lstm_bwd")
    h_seq, h0, dxproj = _dense(h_seq), _dense(h0), _dense(dxproj)
    dw = torch.empty((hidden, 4 * hidden), device=dxproj.device, dtype=h_seq.dtype)
    ws = counters = None
    with torch.cuda.device(dxproj.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.splits > 1:
            ws = torch.empty(plan.workspace, device=dxproj.device, dtype=torch.float32)
            counters = _dw_counters(dxproj.device, stream, plan.tiles_m * plan.tiles_n)
        err = lib.autovc_lstm_dw(_ptr(h_seq), _ptr(h0), _ptr(dxproj), _ptr(dw), _ptr(ws), _ptr(counters), b, t,
                                 hidden, int(reverse), plan.splits, plan.chunk, int(h_seq.dtype == torch.bfloat16),
                                 stream)
    _raise_on(lib, err, "lstm dW kernel", plan)
    dw_launches += 1
    return dw


@_any_width("w", h_seq="u", h0="u", dxproj="g")
def lstm_scan_weight_grad_cuda(h_seq: torch.Tensor, h0: torch.Tensor | None, dxproj: torch.Tensor,
                               reverse: bool = False) -> torch.Tensor:
    """Launch ``csrc/lstm_scan_dw.cu``: dW_hh (H, 4H) of the scan rounding,
    bfloat16, one launch of ``scan_dw_plan`` at the card's SM count (the
    rounding of ``lstm_scan_bf16_weight_grad_ref``: each step's product
    rounded and added to a bfloat16 accumulator; its sums over the batch in
    the plain version's order). h_seq and dxproj bfloat16 (the scan
    forward's sequence, the scan backward's gate gradients), h0 bfloat16 or
    None (zero). Any H (``_any_width``)."""
    global scan_dw_launches
    if h_seq.dtype != torch.bfloat16 or dxproj.dtype != torch.bfloat16:
        raise TypeError(f"the scan dW takes bfloat16 h_seq and dxproj, got {h_seq.dtype} and {dxproj.dtype}")
    b, t, hidden, _ = _check(dxproj, None, first="dxproj", h_seq=h_seq, h0=_scan_state(h0, "h0"))
    plan = scan_dw_plan(b, t, hidden, _card_sms(_index(dxproj.device)))
    lib = _library("lstm_scan_dw")
    h_seq, h0, dxproj = _dense(h_seq), _dense(h0), _dense(dxproj)
    dw = torch.empty((hidden, 4 * hidden), device=dxproj.device, dtype=torch.bfloat16)
    info = (ctypes.c_int * 2)(0, 0)
    with torch.cuda.device(dxproj.device):
        err = lib.autovc_lstm_scan_dw(_ptr(h_seq), _ptr(h0), _ptr(dxproj), _ptr(dw), b, t, hidden, int(reverse),
                                      plan.mi, plan.nj, plan.rows, plan.slabs, plan.slots, plan.blocks, plan.smem,
                                      info, torch.cuda.current_stream().cuda_stream)
    last_launch["scan_dw"] = (plan, info[0], info[1])
    _raise_on(lib, err, "lstm scan dW kernel", plan, info)
    scan_dw_launches += 1
    return dw


@_any_width("g", xproj="g", w_hh="w", h0="u", h_seq="u")
def lstm_gates_cuda(xproj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor | None, h_seq: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Launch ``csrc/lstm_gates.cu``: the gate activations (B, T, 4H),
    float32, of a bfloat16 sequence, recomputed from its rounded h_seq (and
    the float32 h0, or zero) as the Pallas backward recomputes them; one
    launch of ``gates_plan``'s tiles (TMA loads, wgmma). The float32
    backward reads the forward's own (``with_gates``). Any H
    (``_any_width``; TMA's 16-byte strides take H % 8 == 0)."""
    global gates_launches
    if xproj.dtype != torch.bfloat16:
        raise TypeError("the gates kernel takes the bfloat16 form; the float32 forward keeps its gate "
                        "activations (with_gates=True)")
    b, t, hidden, _ = _check(xproj, w_hh, "bwd", h0=h0, h_seq=h_seq)
    plan = gates_plan(b, t, hidden)
    lib = _library("lstm_gates")
    xproj, w_hh, h0, h_seq = map(_dense, (xproj, w_hh, h0, h_seq))
    act = torch.empty((b, t, 4 * hidden), device=xproj.device, dtype=torch.float32)
    with torch.cuda.device(xproj.device):
        err = lib.autovc_lstm_gates(_ptr(xproj), _ptr(w_hh), _ptr(h0), _ptr(h_seq), _ptr(act), b, t, hidden,
                                    int(reverse), plan.nsub, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "lstm gates kernel", plan)
    gates_launches += 1
    return act


@_any_width("gwuu", xproj="g", w_hh="w", h0="u", c0="u", h_seq="u", c_seq="u", dy="u", dhn="u", dcn="u",
            gates="g")
def lstm_backward_cuda(xproj, w_hh, h0, c0, h_seq, c_seq, dy, dhn=None, dcn=None, reverse: bool = False, *,
                       gates, need_dw: bool = True):
    """Launch the backward kernels on the current stream -> (dxproj, dW_hh,
    dh0, dc0): the reversed recurrence with dh0 in one launch, then dW, or,
    when not ``need_dw`` (a frozen w_hh), no dW launch and None for it.
    ``gates`` are the gate activations: the float32 forward kernel's own
    (its ``with_gates`` output), or, in the bfloat16 form, those
    ``lstm_gates_cuda`` recomputes from the rounded h_seq. In the bfloat16
    form dxproj and dW_hh come back in bfloat16 (dW summed over the float32
    gate gradients), dh0 and dc0 in float32. Any H (``_any_width``)."""
    global bwd_launches, bf16_bwd_launches
    if gates is None:
        raise ValueError("lstm_backward_cuda takes the gate activations (the float32 forward's with_gates=True, "
                         "or lstm_gates_cuda)")
    b, t, hidden, plan = _check(xproj, w_hh, "bwd", h0=h0, c0=c0, h_seq=h_seq, c_seq=c_seq, dy=dy, dhn=dhn,
                                dcn=dcn, gates=gates)
    bf16 = xproj.dtype == torch.bfloat16
    lib = _library("lstm_bwd")
    w_hh, c0, h_seq, c_seq, dy, dhn, gates = map(_dense, (w_hh, c0, h_seq, c_seq, dy, dhn, gates))
    dev = xproj.device
    dgates = torch.empty((b, t, 4 * hidden), device=dev, dtype=torch.float32)
    dx = torch.empty((b, t, 4 * hidden), device=dev, dtype=torch.bfloat16) if bf16 else dgates
    dc = torch.zeros((b, hidden), device=dev, dtype=torch.float32) if dcn is None else _dense(dcn).clone()
    dh0 = torch.empty((b, hidden), device=dev, dtype=torch.float32)
    wst = _stream_buffer(plan, hidden, w_hh)
    with torch.cuda.device(dev):
        if bf16:
            _launch(lib, lib.autovc_lstm_bwd_bf16, plan,
                    [_ptr(v) for v in (gates, w_hh, c0, c_seq, dy, dhn, dgates, dx, dc, dh0, wst)],
                    (b, t, hidden, int(reverse)), "lstm backward kernel (bfloat16)")
        else:
            _launch(lib, lib.autovc_lstm_bwd, plan,
                    [_ptr(v) for v in (gates, w_hh, c0, c_seq, dy, dhn, dx, dc, dh0, wst)],
                    (b, t, hidden, int(reverse)), "lstm backward kernel")
    bwd_launches += 1
    bf16_bwd_launches += bf16
    return dx, lstm_weight_grad_cuda(h_seq, h0, dgates, reverse) if need_dw else None, dh0, dc


def _device_kind(xproj: torch.Tensor) -> str:
    if xproj.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lstm_sequence runs on cuda or cpu tensors, not {xproj.device}")
    return xproj.device.type


class LSTMSequenceFn(torch.autograd.Function):
    """(xproj, w_hh, h0, c0, reverse, scan) -> (h_seq, hN, cN), differentiable
    in the four tensors (h0 and c0 may be None: zero). The kernels for CUDA
    tensors, the plain versions for CPU tensors. In bfloat16 (xproj and
    w_hh; h0 and c0 float32) h_seq is bfloat16 and the gradients of xproj
    and w_hh come back in bfloat16, as ``_lstm_chunk``'s custom VJP returns
    them; the backward on the card first recomputes the gate activations
    from the rounded h_seq (``lstm_gates_cuda``). With ``scan`` (bfloat16
    only) the scan rounding: a bfloat16 state (h0, c0, hN, cN), the forward's
    bfloat16 residuals read by the backward, and dW, where w_hh requires
    grad, summed into a bfloat16 accumulator a step at a time
    (``lstm_scan_weight_grad_cuda``). On the card any H runs at
    ``pad_hidden``'s width, padded once here by the wrappers' own helpers
    (``pad_all``, ``strip_all``): the kernels take the padded residuals as
    they are (their wrappers find the width their own and copy nothing), and
    every output and gradient is stripped back to H."""

    @staticmethod
    def forward(ctx, xproj, w_hh, h0, c0, reverse, scan=False):
        _check_dtypes(xproj, w_hh)
        ctx.reverse, ctx.scan = reverse, scan
        # on the card, padded once (pad_hidden) where the sequence enters: the
        # residuals stay at the padded width, so that the backward's kernels
        # take them as they are; what leaves is stripped
        hidden = w_hh.shape[0]
        width = _width(xproj, hidden)
        ctx.hidden = hidden
        xproj, w_hh, h0, c0 = pad_all("gwuu", width, xproj, w_hh, h0, c0)
        if scan:
            if xproj.dtype != torch.bfloat16:
                raise TypeError(f"the scan rounding is a bfloat16 form, got {xproj.dtype}")
            if _device_kind(xproj) == "cuda":
                h_seq, c_seq, act, hn, cn = lstm_scan_forward_cuda(xproj, w_hh, h0, c0, reverse, with_residuals=True)
            else:
                h_seq, c_seq, act, hn, cn = lstm_scan_bf16_train_ref(xproj, w_hh, h0, c0, reverse)
            ctx.save_for_backward(w_hh, h0, c0, h_seq, c_seq, act)
            return tuple(strip_all("uuu", hidden, h_seq, hn, cn))
        bf16 = xproj.dtype == torch.bfloat16
        if _device_kind(xproj) == "cuda":
            out = lstm_forward_cuda(xproj, w_hh, h0, c0, reverse, with_cseq=True, with_gates=not bf16)
            h_seq, c_seq, hn, cn = out[:4]
            gates = None if bf16 else out[4]
        else:
            h_seq, c_seq, hn, cn = lstm_sequence_train_ref(xproj, w_hh, h0, c0, reverse)
            gates = None
        ctx.save_for_backward(xproj, w_hh, h0, c0, h_seq, c_seq, gates)
        return tuple(strip_all("uuu", hidden, h_seq, hn, cn))

    @staticmethod
    def backward(ctx, dy, dhn, dcn):
        if ctx.scan:
            return LSTMSequenceFn._scan_backward(ctx, dy, dhn, dcn)
        xproj, w_hh, h0, c0, h_seq, c_seq, gates = ctx.saved_tensors
        width, hidden = w_hh.shape[0], ctx.hidden
        dy, dhn, dcn = pad_all("uuu", width, dy, dhn, dcn)
        args = (xproj, w_hh, h0, c0, h_seq, c_seq, dy, dhn, dcn, ctx.reverse)
        need_dw = ctx.needs_input_grad[1]  # no dW for a frozen w_hh
        if _device_kind(xproj) == "cuda":
            if gates is None:  # the bfloat16 form
                gates = lstm_gates_cuda(xproj, w_hh, h0, h_seq, ctx.reverse)
            dx, dw, dh0, dc0 = lstm_backward_cuda(*args, gates=gates, need_dw=need_dw)
        else:
            dx, dw, dh0, dc0 = lstm_backward_ref(*args, need_dw=need_dw)
        dh0, dc0 = (None if h0 is None else dh0), (None if c0 is None else dc0)
        return (*strip_all("gwuu", hidden, dx, dw, dh0, dc0), None, None)

    @staticmethod
    def _scan_backward(ctx, dy, dhn, dcn):
        w_hh, h0, c0, h_seq, c_seq, act = ctx.saved_tensors
        width, hidden = w_hh.shape[0], ctx.hidden
        dy = dy.to(torch.bfloat16) if dy is not None else torch.zeros(
            act.shape[:2] + (width,), dtype=torch.bfloat16, device=act.device)
        dy, dhn, dcn = pad_all("uuu", width, dy, dhn, dcn)
        args = (w_hh, act, c_seq, c0, dy, dhn, dcn, ctx.reverse)
        need_dw = ctx.needs_input_grad[1]  # no dW for a frozen w_hh (the d-vector)
        if _device_kind(act) == "cuda":
            dx, dh0, dc0 = lstm_scan_backward_cuda(*args)
            dw = lstm_scan_weight_grad_cuda(h_seq, h0, dx, ctx.reverse) if need_dw else None
        else:
            dx, dh0, dc0 = lstm_scan_bf16_backward_ref(*args)
            dw = lstm_scan_bf16_weight_grad_ref(h_seq, h0, dx, ctx.reverse) if need_dw else None
        h0_grad, c0_grad = ctx.needs_input_grad[2:4]
        dh0, dc0 = (dh0 if h0_grad else None), (dc0 if c0_grad else None)
        return (*strip_all("gwuu", hidden, dx, dw, dh0, dc0), None, None)


@torch.library.custom_op("autovc::lstm_sequence", mutates_args=(), device_types="cpu")
def _lstm_sequence_op(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool, scan: bool) -> torch.Tensor:
    """The inference forward as the operator ``torch.ops.autovc.lstm_sequence``,
    so that ``torch.export`` keeps each recurrence as one graph node (the
    serving bundles, ``autovc_tpu_torch.serve``): the plain version for a CPU
    tensor, ``lstm_sequence_cuda`` for a CUDA tensor (registered below); any
    other device raises, as no default implementation is registered."""
    return lstm_sequence_ref(xproj, w_hh, reverse, scan)


_lstm_sequence_op.register_kernel("cuda")(lstm_sequence_cuda)


@_lstm_sequence_op.register_fake
def _(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool, scan: bool) -> torch.Tensor:
    # B and T are symbolic under export: sizes pass through, never as ints
    return xproj.new_empty((xproj.shape[0], xproj.shape[1], w_hh.shape[0]))


def lstm_sequence(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False, scan: bool = False
                  ) -> torch.Tensor:
    """(B, T, 4H), (H, 4H) -> (B, T, H) from a zero state: the kernel for a
    CUDA tensor, the plain version for a CPU tensor (both through the
    operator ``autovc::lstm_sequence``); through ``LSTMSequenceFn`` when
    grad is on and an input requires it. ``scan`` (bfloat16): the scan
    rounding (``lstm_scan_bf16_train_ref``)."""
    _device_kind(xproj)
    if torch.is_grad_enabled() and (xproj.requires_grad or w_hh.requires_grad):
        return LSTMSequenceFn.apply(xproj, w_hh, None, None, reverse, scan)[0]
    return torch.ops.autovc.lstm_sequence(xproj, w_hh, reverse, scan)
