"""LSTM recurrence over hoisted input projections: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``autovc_tpu/ops/pallas_lstm.py::lstm_sequence``: given
``xproj = x @ w_ih + b`` of shape (B, T, 4H) and ``w_hh`` (H, 4H), return the
hidden sequence (B, T, H). Gate order i, f, g, o; float32 carry; zero
initial state; ``reverse=True`` runs right to left (the backward direction of
a BLSTM) and returns the sequence in natural time order.

``lstm_sequence`` launches the kernel in ``csrc/lstm_fwd.cu`` for a CUDA
tensor and runs ``lstm_sequence_ref`` for a CPU tensor; there is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from autovc_tpu_torch.ops import _build

# Calls of lstm_sequence that launched the CUDA kernel (one call = one
# sequence = T step launches). Callers reset it to 0 and read it back.
launches = 0


def lstm_sequence_ref(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The plain version: a Python loop of the cell update, in float32."""
    b, t, h4 = xproj.shape
    hidden = h4 // 4
    xs = xproj.float().flip(1) if reverse else xproj.float()
    w = w_hh.float()
    h = xproj.new_zeros((b, hidden), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for step in range(t):
        gates = xs[:, step] + h @ w
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs, dim=1)
    return out.flip(1) if reverse else out


def _library() -> ctypes.CDLL:
    lib = _build.load("lstm_fwd")
    fn = lib.autovc_lstm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.autovc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def lstm_sequence_cuda(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global launches
    b, t, h4 = xproj.shape
    hidden = h4 // 4
    if xproj.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"lstm kernel takes float32, got {xproj.dtype} and {w_hh.dtype}")
    if w_hh.shape != (hidden, h4) or h4 % 4:
        raise ValueError(f"shapes do not match: xproj {tuple(xproj.shape)}, w_hh {tuple(w_hh.shape)}")
    if hidden % 8:
        raise ValueError(f"lstm kernel needs H % 8 == 0, got H={hidden}")
    if w_hh.device != xproj.device:
        raise ValueError(f"xproj on {xproj.device}, w_hh on {w_hh.device}")
    lib = _library()
    xproj = xproj.contiguous()
    w_hh = w_hh.contiguous()
    out = torch.empty((b, t, hidden), device=xproj.device, dtype=torch.float32)
    c = torch.empty((b, hidden), device=xproj.device, dtype=torch.float32)
    with torch.cuda.device(xproj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.autovc_lstm_fwd(
            xproj.data_ptr(), w_hh.data_ptr(), out.data_ptr(), c.data_ptr(),
            b, t, hidden, int(reverse), stream,
        )
    if err:
        raise RuntimeError(f"lstm kernel launch failed: {lib.autovc_cuda_error_string(err).decode()}")
    launches += 1
    return out


def lstm_sequence(xproj: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """(B, T, 4H), (H, 4H) -> (B, T, H): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if xproj.device.type == "cuda":
        return lstm_sequence_cuda(xproj, w_hh, reverse)
    if xproj.device.type == "cpu":
        return lstm_sequence_ref(xproj, w_hh, reverse)
    raise ValueError(f"lstm_sequence runs on cuda or cpu tensors, not {xproj.device}")
