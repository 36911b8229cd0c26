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

A mel filter spans at most 34 of the 513 bins (the (513, 80) basis has 941
nonzeros of 41,040), so the kernel walks each filter's own bins only:
``filter_spans`` gives each column's [first, last + 1) nonzero bins, which
the wrapper derives on the device once per basis tensor. ``tile_plan`` is
the kernel's launch: a block a tile of ``TILE_FRAMES`` frames and every mel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops._cache import TensorCache

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


def filter_spans(mel_basis: torch.Tensor) -> torch.Tensor:
    """(n_bins, n_mels) -> (n_mels, 2) int32 [lo, hi): each column's first
    nonzero bin and one past its last, on the basis's device; the zeros
    between them stay inside the span (so any basis works, a dense one too),
    and a column of zeros gets (0, 0). Tensor operations only: no
    device->host synchronisation."""
    nz = (torch.as_tensor(mel_basis) != 0).to(torch.int32)
    lo = nz.argmax(dim=0)  # the first maximal element: the first nonzero
    hi = nz.shape[0] - nz.flip(0).argmax(dim=0)
    some = nz.amax(dim=0) > 0
    return torch.stack([torch.where(some, lo, 0), torch.where(some, hi, 0)], dim=1).to(torch.int32).contiguous()


# ------------------------------------------------------------- launch plan

SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90
TILE_FRAMES, THREADS = 32, 640  # as in csrc/mel_norm.cu: a warp's lanes are a tile's frames
MIN_WEIGHTS = 1024  # packed filter weights a block stages at once, at least (941 for the spmel basis)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How one call is launched (see the notes of csrc/mel_norm.cu):
    ``blocks`` blocks of ``threads``, each a tile of ``frames`` frames and
    every mel; a block stages up to ``weights`` packed filter weights at
    once (at least n_bins, one dense column); ``smem`` dynamic shared bytes
    a block."""

    frames: int
    blocks: int
    threads: int
    weights: int
    smem: int


def tile_plan(t: int, n_bins: int, n_mels: int) -> TilePlan:
    """The plan at T frames of (n_bins, n_mels): shared memory laid out as
    the kernel lays it out, the tile's magnitudes (an odd pitch of n_bins or
    n_bins + 1 floats a frame), the packed weights, the tile's outputs (an
    odd pitch of n_mels or n_mels + 1), the spans and offsets, the tile
    copy's mbarrier. At (513, 80): 81,104 bytes, 2 blocks an SM; 311 frames
    (a 4.97-s file) take 10 blocks."""
    weights = max(MIN_WEIGHTS, n_bins)
    spans_end = 4 * (TILE_FRAMES * (n_bins | 1) + weights + TILE_FRAMES * (n_mels | 1) + 3 * n_mels + 1)
    smem = -(-spans_end // 8) * 8 + 8  # the tile copy's mbarrier, 8-byte aligned
    if smem > SMEM_MAX:
        raise ValueError(f"the mel kernel stages {TILE_FRAMES} frames of {n_bins} bins and {n_mels} mels in "
                         f"{smem} bytes of shared memory, more than {SMEM_MAX}")
    return TilePlan(TILE_FRAMES, -(-t // TILE_FRAMES), THREADS, weights, smem)


_ERR_PLAN = -1  # the launcher's own code: the plan does not match the shapes

# What the kernel reads of a basis, kept on its device once per basis
# tensor: the basis transposed (a filter's weights contiguous) and its
# spans, both made by tensor operations (no synchronisation).
_prepared = TensorCache(64)


def _prepare(mel_basis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _prepared.get(mel_basis, lambda b: (b.t().contiguous(), filter_spans(b)))


def _library() -> ctypes.CDLL:
    lib = _build.load("mel_norm")
    lib.autovc_mel_norm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    basis_t, spans = _prepare(mel_basis)
    out = torch.empty((t, n_mels), device=mag.device, dtype=torch.float32)
    if t == 0 or n_mels == 0:
        return out
    plan = tile_plan(t, n_bins, n_mels)
    lib = _library()
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.autovc_mel_norm(mag.data_ptr(), basis_t.data_ptr(), spans.data_ptr(), out.data_ptr(), t,
                                  n_bins, n_mels, ref_db, min_db, plan.weights, plan.smem, stream)
    if err == _ERR_PLAN:
        raise RuntimeError(f"mel kernel: the kernel refused the plan {plan}")
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
