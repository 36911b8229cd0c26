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
on the CPU is the JAX package's, bit for bit.

- ``sosfilt`` launches ``csrc/sosfilt.cu`` for a CUDA tensor and runs
  ``sosfilt_ref`` for a CPU tensor; there is no fallback from one to the
  other. The kernel takes float32 only.
- ``sosfilt_ref`` is the plain version: a Python loop over time on Python
  floats, one row at a time, in the step's arithmetic above: a fused
  multiply-add is computed in double, where the product of two float32 is
  exact, and rounded to float32 once. It runs whole utterances on the CPU,
  where a loop of a dozen dispatched torch operations per time step would
  cost an order of magnitude more than one on Python floats.

The kernel is a chunked scan over time (``scan_plan``): one block a row,
the row cut into one chunk of C samples a thread. The recurrence is linear,
so across a chunk the joint state s of the sections (2S values) evolves as
s_end = M s_start + e, with M = A^C the map of C zero-input steps and e the
chunk's end state from a zero state, the sum of G[i] x_i over its samples
(``scan_tables``: the powers M^(2^j), one a Kogge-Stone level, and G, in
float64). Phase 1 forms each chunk's e in float64, phase 2 scans the carries
in float64, and phase 3 runs the cascade over each chunk from its carry in
float64, rounding each output once to float32; chunk 0 runs from zi in the
plain version's float32 arithmetic. So chunk 0 (and a row of up to C
samples) is the plain version's bit for bit, and every later sample is the
float64 filter's to within its float32 rounding: another rounding than the
sequential pass's, so the kernel is held to the float64 filter instead, each
row no farther from it than twice the plain version's distance plus 1e-6 of
the row's max-abs (csrc/sosfilt.cu says why float64).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from array import array

import numpy as np
import torch

from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops._cache import TensorCache

MAX_SECTIONS = 4  # the kernel's register state; a 5th-order Butterworth has 3
MAX_THREADS = 512  # threads a block: one chunk each
MIN_CHUNK = 32  # samples a chunk at least: a row of up to 32 samples is one chunk, the sequential pass
# as in csrc/sosfilt.cu: samples of each chunk staged a round, floats a chunk in the tile, staging buffers
ROUND, PITCH, NBUF = 16, 20, 4

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
    float32 -> y (B, L) float32 on x's device, rounded as the step above
    rounds."""
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


# ------------------------------------------------------------ the scan plan

@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How one row of L samples is cut (see the notes of csrc/sosfilt.cu):
    ``chunks`` chunks of ``chunk`` samples (the last one shorter), one a
    thread of a block of ``threads`` (whole warps); ``levels`` Kogge-Stone
    levels of the carry scan, 2^levels >= chunks; ``smem`` dynamic shared
    bytes a block at ``sections`` sections."""

    chunk: int
    chunks: int
    threads: int
    levels: int
    sections: int
    smem: int


def _smem(threads: int, sections: int, levels: int) -> int:
    """Shared bytes of a block, laid out as the kernel lays them out: NBUF
    staging buffers, each ROUND rows of G (2S doubles a row) and ROUND
    samples of every chunk (PITCH floats a chunk), or in phase 2 two buffers
    of the carries (2S doubles a chunk); then the powers M^(2^j) (levels x
    2S x 2S doubles)."""
    n = 2 * sections
    return max(NBUF * (ROUND * n * 8 + threads * PITCH * 4), 2 * threads * n * 8) + levels * n * n * 8


@functools.lru_cache(maxsize=None)
def scan_plan(length: int, sections: int = 3) -> ScanPlan:
    """The plan of a row of ``length`` samples: chunks of C = max(MIN_CHUNK,
    ceil(L / MAX_THREADS)) samples rounded up to a multiple of 4 (whole
    16-byte copies), one a thread. At a 5-s file (80,036 samples with the
    odd extension) C = 160 in 501 chunks; at 131,072 + 36, C = 260 in 505;
    up to 32 samples, one chunk."""
    if length < 1:
        raise ValueError(f"sosfilt scans rows of at least one sample, not {length}")
    if not 1 <= sections <= MAX_SECTIONS:
        raise ValueError(f"the sosfilt kernel takes 1 to {MAX_SECTIONS} sections, got {sections}")
    chunk = -(-max(MIN_CHUNK, -(-length // MAX_THREADS)) // 4) * 4
    chunks = -(-length // chunk)
    threads = -(-chunks // 32) * 32
    levels = (chunks - 1).bit_length()
    return ScanPlan(chunk, chunks, threads, levels, sections, _smem(threads, sections, levels))


def _step(sos: np.ndarray, z: np.ndarray, x: float) -> np.ndarray:
    """The joint state [z0, z1 of section 0, z0, z1 of section 1, ...] after
    one step of the cascade with input x, in float64."""
    out = np.empty_like(z)
    y = x
    for s, (b0, b1, b2, _, a1, a2) in enumerate(sos):
        yn = b0 * y + z[2 * s]
        out[2 * s] = b1 * y - a1 * yn + z[2 * s + 1]
        out[2 * s + 1] = b2 * y - a2 * yn
        y = yn
    return out


def scan_tables(sos, chunk: int, levels: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's float64 tables for chunks of ``chunk`` samples:
    ``powers`` (levels, 2S, 2S), M^(2^j) for j < levels with M = A^chunk, A
    the state map of one zero-input step; and ``response`` (chunk, 2S), row i
    the end state of a chunk from a zero state with a unit sample at i and
    zeros elsewhere, A^(chunk-1-i) B (B the state after one step from zero
    with a unit input), so that a chunk's end state from zero is
    ``x_chunk @ response``."""
    sos = np.asarray(sos, np.float64)
    n = 2 * sos.shape[0]
    a = np.stack([_step(sos, np.eye(n)[i], 0.0) for i in range(n)], axis=1)
    response = np.empty((chunk, n))
    response[-1] = _step(sos, np.zeros(n), 1.0)
    for i in range(chunk - 2, -1, -1):
        response[i] = a @ response[i + 1]
    m = np.linalg.matrix_power(a, chunk)
    powers = np.empty((levels, n, n))
    for j in range(levels):
        powers[j] = m
        m = m @ m
    return powers, response


# The values of a device sos tensor as float64 on the host, by the tensor's
# identity: the front end records them where it makes the tensor
# (``note_host_copy``); any other sos tensor is copied to the host once.
_host_sos = TensorCache(16)


def note_host_copy(sos: torch.Tensor, values) -> None:
    """Record ``values``, the sections of the tensor ``sos`` on the host, so
    that the kernel's tables for ``sos`` are made with no device->host
    copy."""
    _host_sos.put(sos, np.array(values, np.float64))


# The tables on the card, made once per (filter, chunk length, levels,
# device) from pinned host copies, which stay here so that their copies to
# the card need no synchronisation. A corpus of 2-8 s files has about 50
# chunk lengths; a file adds nothing once its length's tables are made.
_TABLES_CACHE_SIZE = 256
_tables: dict[tuple, tuple[list[torch.Tensor], list[torch.Tensor]]] = {}


def _device_tables(sos: torch.Tensor, plan: ScanPlan) -> list[torch.Tensor]:
    values = _host_sos.get(sos, lambda s: s.detach().cpu().double().numpy())
    key = (values.tobytes(), values.shape, plan.chunk, plan.levels, str(sos.device))
    hit = _tables.get(key)
    if hit is None:
        if len(_tables) >= _TABLES_CACHE_SIZE:
            _tables.clear()
        host = [torch.from_numpy(t).pin_memory() for t in scan_tables(values, plan.chunk, max(plan.levels, 1))]
        hit = _tables[key] = (host, [t.to(sos.device, non_blocking=True) for t in host])
    return hit[1]


# ------------------------------------------------------------------- kernel

_ERR_PLAN = -1  # the launcher's own code: the plan does not match the shapes


def _library() -> ctypes.CDLL:
    lib = _build.load("sosfilt")
    lib.autovc_sosfilt.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.autovc_sosfilt.restype = ctypes.c_int
    lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.autovc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def sosfilt_cuda(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation): one
    block a row, the chunked scan of ``scan_plan``."""
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
    if b == 0 or length == 0:
        return torch.empty_like(x)
    # the kernel copies 16 bytes at a time: rows 16-byte aligned, ld floats
    # apart (a multiple of 4); other rows are copied into a padded buffer
    ld = -(-length // 4) * 4
    padded = (b > 1 and ld != length) or x.data_ptr() % 16
    if padded:
        xp = x.new_zeros((b, ld))
        xp[:, :length] = x
        x = xp
    y = torch.empty_like(x)
    plan = scan_plan(length, n_sections)
    lib = _library()
    with torch.cuda.device(x.device):
        powers, response = _device_tables(sos, plan)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.autovc_sosfilt(x.data_ptr(), y.data_ptr(), sos.data_ptr(), zi.data_ptr(), powers.data_ptr(),
                                 response.data_ptr(), b, length, ld, n_sections, plan.chunk, plan.threads,
                                 plan.levels, plan.smem, stream)
    if err == _ERR_PLAN:
        raise RuntimeError(f"sosfilt kernel: the kernel refused the plan {plan} at L={length}")
    if err:
        raise RuntimeError(f"sosfilt kernel launch failed: {lib.autovc_cuda_error_string(err).decode()}")
    launches += 1
    return y[:, :length].contiguous() if padded else y


def sosfilt(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """(S, 6), (B, L), (B, S, 2) -> (B, L): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return sosfilt_cuda(sos, x, zi)
    if x.device.type == "cpu":
        return sosfilt_ref(sos, x, zi)
    raise ValueError(f"sosfilt runs on cuda or cpu tensors, not {x.device}")
