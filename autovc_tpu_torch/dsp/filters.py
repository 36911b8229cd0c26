"""IIR filtering: Butterworth design and scipy-compatible zero-phase
filtfilt (counterpart of ``autovc_tpu/dsp/filters.py``).

The reference removes drifting noise with a 5th-order 30 Hz Butterworth
highpass applied zero-phase by scipy.signal.filtfilt (make_spect.py:30-34,74).
Filter design is host SciPy in float64, as in the JAX package. Filtering
comes in two forms:

- ``filtfilt``/``lfilter``, the transfer-function form, used only by the
  float64 front end: a plain loop in float64 on the CPU, the arithmetic of
  scipy's C loop (bit for bit on the reference's chain). It raises on a CUDA
  tensor.
- ``sos_filtfilt``, the float32 production path: cascaded biquads, scipy's
  odd extension and steady-state initial state scaled by the edge sample,
  one pass forward and one over the reversed signal, each pass through
  ``ops.sosfilt`` (the CUDA kernel on the card, its plain version on the
  CPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy import signal as _scipy_signal

from autovc_tpu_torch.ops.sosfilt import note_host_copy
from autovc_tpu_torch.ops.sosfilt import sosfilt as _sosfilt


def butter_highpass(
    cutoff_hz: float = 30.0, fs: int = 16_000, order: int = 5
) -> tuple[np.ndarray, np.ndarray]:
    """Butterworth highpass transfer-function coefficients (b, a), float64."""
    nyq = 0.5 * fs
    b, a = _scipy_signal.butter(order, cutoff_hz / nyq, btype="high", analog=False)
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions for a step input (scipy.signal.lfilter_zi).

    Solves (I - A) zi = B for the DF2T state-space companion form, host-side
    in float64.
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    n = max(len(a), len(b))
    a0 = a[0]
    a = np.r_[a, np.zeros(n - len(a))] / a0
    b = np.r_[b, np.zeros(n - len(b))] / a0
    # transposed companion matrix of the denominator (DF2T state update)
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:n]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:n] - a[1:n] * b[0]
    zi = np.linalg.solve(np.eye(n - 1) - A, B)
    return zi


def _cpu_only(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"{what} is the float64 host path and runs on the CPU only, not on {x.device}")


def lfilter(
    b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct-form-II-transposed IIR filter over the last axis.

    x: (..., L); zi: (..., order) or None (zeros). Returns (y, zf) in x's
    dtype, computed in float64 by a Python loop over time, one row at a time.
    """
    x = torch.as_tensor(x)
    _cpu_only(x, "lfilter")
    b = [float(v) for v in np.asarray(b, np.float64)]
    a = [float(v) for v in np.asarray(a, np.float64)]
    order = len(b) - 1
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1]).double().tolist()
    zrows = ([[0.0] * order] * len(rows) if zi is None
             else torch.as_tensor(zi).reshape(-1, order).double().tolist())
    b0, b_rest, a_rest = b[0], b[1:], a[1:]
    ys, zfs = [], []
    for xr, zr in zip(rows, zrows):
        z = list(zr)
        y = [0.0] * len(xr)
        for t, xn in enumerate(xr):
            yn = b0 * xn + z[0]
            for i in range(order - 1):
                z[i] = z[i + 1] + b_rest[i] * xn - a_rest[i] * yn
            z[order - 1] = b_rest[order - 1] * xn - a_rest[order - 1] * yn
            y[t] = yn
        ys.append(y)
        zfs.append(z)
    y = torch.tensor(ys, dtype=torch.float64).reshape(x.shape).to(x.dtype)
    zf = torch.tensor(zfs, dtype=torch.float64).reshape(*lead, order).to(x.dtype)
    return y, zf


def _odd_ext(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """scipy.signal._arraytools.odd_ext over the last axis."""
    left = 2.0 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _check_length(x: torch.Tensor, padlen: int) -> None:
    if x.shape[-1] <= padlen:  # scipy raises here too
        raise ValueError(f"input length {x.shape[-1]} must exceed padlen {padlen}")


def filtfilt(
    b: np.ndarray, a: np.ndarray, x: torch.Tensor, padlen: int | None = None
) -> torch.Tensor:
    """Zero-phase forward-backward filter matching scipy.signal.filtfilt
    defaults (method='pad', padtype='odd'), on the CPU.

    The transfer-function form of a high-order lowcut filter is badly
    conditioned: give it float64 inputs. The float32 production path is
    :func:`sos_filtfilt`.
    """
    if padlen is None:
        padlen = 3 * max(len(a), len(b))
    x = torch.as_tensor(x)
    _cpu_only(x, "filtfilt")
    _check_length(x, padlen)
    zi = torch.as_tensor(lfilter_zi(b, a), dtype=x.dtype)
    ext = _odd_ext(x, padlen)
    y, _ = lfilter(b, a, ext, zi=zi * ext[..., :1])
    y = y.flip(-1)
    y, _ = lfilter(b, a, y, zi=zi * y[..., :1])
    return y.flip(-1)[..., padlen:-padlen]


def butter_highpass_sos(
    cutoff_hz: float = 30.0, fs: int = 16_000, order: int = 5
) -> np.ndarray:
    """Butterworth highpass as second-order sections (stable in float32)."""
    nyq = 0.5 * fs
    return _scipy_signal.butter(
        order, cutoff_hz / nyq, btype="high", analog=False, output="sos"
    )


@functools.lru_cache(maxsize=16)
def _sos_tensors(sos_bytes: bytes, shape: tuple[int, ...], dtype: torch.dtype,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The sections (S, 6) and their unit steady state ``sosfilt_zi`` (S, 2)
    on ``device``, made once per filter: a file adds no host->device copy,
    and ``ops.sosfilt`` makes its scan tables from the sections' host copy."""
    sos = np.frombuffer(sos_bytes, np.float64).reshape(shape).copy()
    host = torch.as_tensor(sos, dtype=dtype)
    sos_t = host.to(device)
    note_host_copy(sos_t, host.double().numpy())
    return sos_t, torch.as_tensor(_scipy_signal.sosfilt_zi(sos), dtype=dtype, device=device)


def sos_filtfilt(sos: np.ndarray, x: torch.Tensor, padlen: int | None = None) -> torch.Tensor:
    """Zero-phase filtering via second-order sections (scipy.sosfiltfilt
    semantics: odd padding, steady-state zi scaled by the edge sample) of a
    float32 x (..., L) on its device: two ``ops.sosfilt`` passes over (B, L)."""
    sos = np.ascontiguousarray(sos, np.float64)
    if padlen is None:
        padlen = 3 * (2 * len(sos) + 1 - min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum()))
    padlen = int(padlen)
    x = torch.as_tensor(x)
    _check_length(x, padlen)
    sos_t, zi = _sos_tensors(sos.tobytes(), sos.shape, x.dtype, x.device)
    ext = _odd_ext(x, padlen).reshape(-1, x.shape[-1] + 2 * padlen)
    y = _sosfilt(sos_t, ext, zi * ext[:, :1, None]).flip(-1)
    y = _sosfilt(sos_t, y, zi * y[:, :1, None]).flip(-1)
    return y[:, padlen:-padlen].reshape(x.shape)
