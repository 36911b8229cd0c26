"""Mel projection fused with the dB normalization: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``autovc_tpu/ops/pallas_mel.py::mel_normalize`` (its body
``_kernel`` :25): given the magnitude spectrogram ``mag`` (T, n_bins) and the
mel basis (n_bins, n_mels), both float32,

    m   = mag @ mel_basis                                       (T, n_mels)
    out = clip((20 * log10(max(1e-5, m)) - ref_db - min_db) / -min_db, 0, 1)

(make_spect.py:81-86). ``normalize_db`` is the second line alone; the front
end (``dsp.features``) takes it from here.

- ``mel_normalize`` launches ``csrc/mel_norm.cu`` for a CUDA tensor and runs
  ``mel_normalize_ref`` for a CPU tensor; there is no fallback from one to
  the other. The kernel takes contiguous float32 only, any n_bins and any
  n_mels; the TPU's padding to 128 lanes, ``tile_t`` and ``interpret`` have
  no counterpart.
- ``mel_normalize_ref`` is the plain version, ``normalize_db(mag @ basis)``:
  the arithmetic of ``MelFrontend.mel_features`` in the JAX package
  (``dsp/features.py:108-118``), in the dtype of ``mag``.
"""

from __future__ import annotations

import ctypes

import torch

from autovc_tpu_torch.ops import _build

# min_level = exp(-100/20 * ln 10) = 1e-5 (make_spect.py:52)
MIN_LEVEL = 1e-5

# Kernel launches (one a call). Callers reset it to 0 and read it back.
launches = 0


def normalize_db(mag: torch.Tensor, ref_db: float = 16.0, min_db: float = -100.0) -> torch.Tensor:
    """dB-normalize to [0, 1]: clip((20*log10(max(1e-5, m)) - ref + 100)/100)
    (make_spect.py:82-86)."""
    db = 20.0 * torch.log10(torch.clamp(mag, min=MIN_LEVEL)) - ref_db
    return torch.clamp((db - min_db) / -min_db, 0.0, 1.0)


def mel_normalize_ref(mag: torch.Tensor, mel_basis: torch.Tensor, ref_db: float = 16.0,
                      min_db: float = -100.0) -> torch.Tensor:
    """The plain version: (T, n_bins) @ (n_bins, n_mels), then normalize_db."""
    return normalize_db(mag @ mel_basis.to(mag.dtype), ref_db, min_db)


def _library() -> ctypes.CDLL:
    lib = _build.load("mel_norm")
    lib.autovc_mel_norm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    lib.autovc_mel_norm.restype = ctypes.c_int
    lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.autovc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def mel_normalize_cuda(mag: torch.Tensor, mel_basis: torch.Tensor, ref_db: float = 16.0,
                       min_db: float = -100.0) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation)."""
    global launches
    if mag.ndim != 2 or mel_basis.ndim != 2 or mag.shape[1] != mel_basis.shape[0]:
        raise ValueError(f"mel_normalize takes mag (T, n_bins) and mel_basis (n_bins, n_mels), got "
                         f"{tuple(mag.shape)} and {tuple(mel_basis.shape)}")
    for name, v in (("mag", mag), ("mel_basis", mel_basis)):
        if v.dtype != torch.float32:
            raise TypeError(f"the mel kernel takes float32, got {name} {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"the mel kernel takes contiguous tensors, {name} is not")
    if mag.device != mel_basis.device or mag.device.type != "cuda":
        raise ValueError(f"the mel kernel takes tensors on one CUDA device, got {mag.device} and "
                         f"{mel_basis.device}")
    t, n_bins = mag.shape
    n_mels = mel_basis.shape[1]
    out = torch.empty((t, n_mels), device=mag.device, dtype=torch.float32)
    if t == 0 or n_mels == 0:
        return out
    lib = _library()
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.autovc_mel_norm(mag.data_ptr(), mel_basis.data_ptr(), out.data_ptr(), t, n_bins, n_mels,
                                  ref_db, min_db, stream)
    if err:
        raise RuntimeError(f"mel kernel launch failed: {lib.autovc_cuda_error_string(err).decode()}")
    launches += 1
    return out


def mel_normalize(mag: torch.Tensor, mel_basis: torch.Tensor, ref_db: float = 16.0,
                  min_db: float = -100.0) -> torch.Tensor:
    """mag (T, n_bins) -> normalized mel (T, n_mels): the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if mag.device.type == "cuda":
        return mel_normalize_cuda(mag, mel_basis, ref_db, min_db)
    if mag.device.type == "cpu":
        return mel_normalize_ref(mag, mel_basis, ref_db, min_db)
    raise ValueError(f"mel_normalize runs on cuda or cpu tensors, not {mag.device}")
