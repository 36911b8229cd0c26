"""Sequence (time-axis) parallelism for long-utterance conversion.

Counterpart of ``autovc_tpu/parallel/sequence.py``. Each rank of a 'seq'
mesh axis holds one time block of every sequence, (B, T / n, C), and the
functions here take and return that block:

- ``halo_conv1d``: a 'same' convolution of odd width k over the blocks. The
  ranks exchange k // 2-frame halos with both neighbours (zeros at the
  sequence's two ends), then convolve their block with no padding. At k = 1
  there is nothing to exchange.
- ``sp_lstm``: the recurrence as a relay. The input product x @ w_ih + b is
  local; rank d then waits for (h, c) from rank d - 1 (from d + 1 when
  ``reverse``), runs its block from that state and sends its last state on.
  The first block starts from zeros. JAX rounds this over a ring of
  ``ppermute`` calls; here it is one point-to-point handoff a block. On the
  card a block is one launch of the forward kernel from (h0, c0)
  (``ops.lstm.lstm_forward_cuda``), on the CPU the plain loop
  (``ops.lstm.lstm_sequence_train_ref``). Under gloo on the card the state
  crosses through host memory (``mesh.send``/``recv``); under NCCL it stays
  on the card.
- ``sp_blstm``: a stack of bidirectional layers of ``sp_lstm``.

A rank's 'seq' group lies within its slice of any other mesh axis, so with
the batch split over a second axis (data x sequence parallelism) each
slice's blocks relay among themselves; ``time_block`` cuts a rank's block
out of a global batch along both. Float32 only, as the JAX functions.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from autovc_tpu_torch.ops import lstm as lstm_ops
from autovc_tpu_torch.parallel.mesh import Mesh, batch_split, exchange, recv, send

# Blocks that ``sp_lstm`` ran from a state received from the block before
# (every block but a direction's first); callers set it to 0 and read it.
relays = 0


def time_block(x: torch.Tensor, mesh: Mesh, axis: str = "seq", batch_axis: str | None = None) -> torch.Tensor:
    """This rank's block of a global (B, T, ...) batch: its time block along
    ``axis`` and, with ``batch_axis``, its rows along that axis."""
    if batch_axis is not None:
        x = batch_split(x, mesh, batch_axis)
    n, t = mesh.size(axis), x.shape[1]
    if t % n:
        raise ValueError(f"{t} steps do not split over {n} '{axis}' ranks")
    return x[:, mesh.index(axis) * (t // n) : (mesh.index(axis) + 1) * (t // n)]


def halo_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, mesh: Mesh,
                axis: str = "seq") -> torch.Tensor:
    """A 'same' 1-D convolution of this rank's time block x (B, Tb, Cin) with
    ``weight`` (Cout, Cin, k), k odd -> (B, Tb, Cout)."""
    k = weight.shape[-1]
    if k % 2 != 1:
        raise ValueError(f"halo_conv1d needs an odd kernel, got {k}")
    halo = k // 2
    if halo == 0:
        padded = x  # k = 1: pointwise, nothing to exchange
    else:
        if x.shape[1] < halo:
            raise ValueError(f"a block of {x.shape[1]} steps is shorter than the {halo}-step halo")
        from_prev, from_next = exchange(x[:, :halo], x[:, -halo:], mesh, axis)
        padded = torch.cat([from_prev, x, from_next], dim=1)
    return F.conv1d(padded.transpose(1, 2), weight, bias).transpose(1, 2)


def _run_block(xproj: torch.Tensor, w_hh: torch.Tensor, h0, c0, reverse: bool):
    """(h_seq, hN, cN) of one block from (h0, c0) (None: zeros)."""
    if xproj.device.type == "cuda":
        h_seq, _, hn, cn = lstm_ops.lstm_forward_cuda(xproj, w_hh, h0, c0, reverse)
    else:
        h_seq, _, hn, cn = lstm_ops.lstm_sequence_train_ref(xproj, w_hh, h0, c0, reverse)
    return h_seq, hn, cn


def sp_lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor, mesh: Mesh,
            axis: str = "seq", reverse: bool = False) -> torch.Tensor:
    """One LSTM direction over this rank's block x (B, Tb, Cin) -> (B, Tb, H),
    the state handed from block to block (``reverse``: right to left)."""
    global relays
    n, idx = mesh.size(axis), mesh.index(axis)
    xproj = torch.matmul(x, w_ih) + b
    hidden = w_hh.shape[0]
    src, dst = (idx + 1, idx - 1) if reverse else (idx - 1, idx + 1)
    h0 = c0 = None
    if 0 <= src < n:
        state = recv(xproj.new_empty((2, x.shape[0], hidden)), mesh, axis, src)
        h0, c0 = state[0], state[1]
        relays += 1
    h_seq, hn, cn = _run_block(xproj, w_hh, h0, c0, reverse)
    if 0 <= dst < n:
        send(torch.stack([hn, cn]), mesh, axis, dst)
    return h_seq


def sp_blstm(x: torch.Tensor, params: Mapping[str, torch.Tensor], mesh: Mesh, axis: str = "seq",
             num_layers: int = 2) -> torch.Tensor:
    """A bidirectional stack over this rank's block, with ``layers.LSTM``'s
    parameter names (``w_ih_l{k}_{fwd,bwd}``, ``w_hh_...``, ``b_...``)."""
    h = x
    for layer in range(num_layers):
        h = torch.cat([sp_lstm(h, params[f"w_ih_l{layer}_{d}"], params[f"w_hh_l{layer}_{d}"],
                               params[f"b_l{layer}_{d}"], mesh, axis, reverse=d == "bwd") for d in ("fwd", "bwd")],
                      dim=-1)
    return h
