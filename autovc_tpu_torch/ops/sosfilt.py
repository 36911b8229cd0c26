"""One pass of a cascade of second-order sections (biquads) over the time
axis: the CUDA kernel and its plain version.

A port-only kernel: it replaces the ``lax.scan`` of
``autovc_tpu/dsp/filters.py::_sosfilt`` (:135-161), which
``_sos_filtfilt_jit`` (:164-173) runs twice, forward and over the reversed
signal. It has no Pallas counterpart. For each row, sample and section s, in
direct form II transposed:

    y_new = fma(b0, y, z0)
    z0    = fma(b1, y, -(a1 * y_new)) + z1
    z1    = fma(b2, y, -(a2 * y_new))
    y     = y_new                                 (the next section's input)

``fma`` rounds once. That is the rounding of ``_sosfilt``'s step as XLA
compiles it for the CPU, which contracts ``b * y + z`` and
``b * y - a * y_new`` into fused multiply-adds. The order matters: the 30 Hz
highpass has its poles near z = 1, so the float32 rounding of every step is
amplified at low frequencies, and two orders of the same step leave outputs
1e-4 apart on a 6-s utterance. With this one, the port's float32 highpass
is the JAX package's, bit for bit.

- ``sosfilt`` launches ``csrc/sosfilt.cu`` for a CUDA tensor and runs
  ``sosfilt_ref`` for a CPU tensor; there is no fallback from one to the
  other. The kernel takes float32 only.
- ``sosfilt_ref`` is the plain version: a Python loop over time on Python
  floats, one row at a time, in the kernel's arithmetic: a fused
  multiply-add is computed in double, where the product of two float32 is
  exact, and rounded to float32 once. It runs whole utterances on the CPU,
  where a loop of a dozen dispatched torch operations per time step would
  cost an order of magnitude more than one on Python floats.
"""

from __future__ import annotations

import ctypes
from array import array

import torch

from autovc_tpu_torch.ops import _build

MAX_SECTIONS = 4  # the kernel's register state; a 5th-order Butterworth has 3

# Passes launched on the card (one launch filters every row once). Callers
# reset it to 0 and read it back.
launches = 0


def _check_shapes(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor) -> tuple[int, int, int]:
    if sos.ndim != 2 or sos.shape[1] != 6 or x.ndim != 2 or tuple(zi.shape) != (x.shape[0], sos.shape[0], 2):
        raise ValueError(f"sosfilt takes sos (S, 6), x (B, L) and zi (B, S, 2); got sos {tuple(sos.shape)}, "
                         f"x {tuple(x.shape)}, zi {tuple(zi.shape)}")
    return x.shape[0], x.shape[1], sos.shape[0]


def sosfilt_ref(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """The plain pass: sos (S, 6) with a0 = 1, x (B, L), zi (B, S, 2), all
    float32 -> y (B, L) float32 on x's device, rounded as the kernel rounds."""
    _check_shapes(sos, x, zi)
    if x.dtype != torch.float32:
        raise TypeError(f"sosfilt takes float32, got {x.dtype}")
    box = array("f", [0.0])

    def rnd(v: float) -> float:  # to the nearest float32, ties to even
        box[0] = v
        return box[0]

    coef = [[rnd(float(c)) for c in row] for row in sos.detach().cpu().double().tolist()]
    secs = [(b0, b1, b2, -a1, -a2) for b0, b1, b2, _, a1, a2 in coef]
    rows = []
    for xr, zr in zip(x.detach().cpu().double().tolist(), zi.detach().cpu().double().tolist()):
        z = [[rnd(v) for v in zs] for zs in zr]
        out = [0.0] * len(xr)
        for t, y in enumerate(xr):
            for (b0, b1, b2, na1, na2), zs in zip(secs, z):
                yn = rnd(b0 * y + zs[0])
                zs[0] = rnd(rnd(b1 * y + rnd(na1 * yn)) + zs[1])
                zs[1] = rnd(b2 * y + rnd(na2 * yn))
                y = yn
            out[t] = y
        rows.append(out)
    return torch.tensor(rows, dtype=x.dtype).reshape(x.shape).to(x.device)


def _library() -> ctypes.CDLL:
    lib = _build.load("sosfilt")
    lib.autovc_sosfilt.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                           ctypes.c_void_p]
    lib.autovc_sosfilt.restype = ctypes.c_int
    lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.autovc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def sosfilt_cuda(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation): one
    thread per row, the sections' state in registers."""
    global launches
    b, length, n_sections = _check_shapes(sos, x, zi)
    for name, v in (("sos", sos), ("x", x), ("zi", zi)):
        if v.dtype != torch.float32:
            raise TypeError(f"the sosfilt kernel takes float32, got {name} {v.dtype}")
    if {sos.device, x.device, zi.device} != {x.device} or x.device.type != "cuda":
        raise ValueError(f"the sosfilt kernel takes tensors on one CUDA device, got "
                         f"{sorted({str(sos.device), str(x.device), str(zi.device)})}")
    if not 1 <= n_sections <= MAX_SECTIONS:
        raise ValueError(f"the sosfilt kernel takes 1 to {MAX_SECTIONS} sections, got {n_sections}")
    sos, x, zi = sos.contiguous(), x.contiguous(), zi.contiguous()
    y = torch.empty_like(x)
    if b == 0 or length == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.autovc_sosfilt(x.data_ptr(), y.data_ptr(), sos.data_ptr(), zi.data_ptr(), b, length,
                                 n_sections, stream)
    if err:
        raise RuntimeError(f"sosfilt kernel launch failed: {lib.autovc_cuda_error_string(err).decode()}")
    launches += 1
    return y


def sosfilt(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """(S, 6), (B, L), (B, S, 2) -> (B, L): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return sosfilt_cuda(sos, x, zi)
    if x.device.type == "cpu":
        return sosfilt_ref(sos, x, zi)
    raise ValueError(f"sosfilt runs on cuda or cpu tensors, not {x.device}")
