"""STFT / iSTFT / Griffin-Lim in PyTorch (counterpart of
``autovc_tpu/dsp/stft.py``).

Matches the reference ``pySTFT`` (make_spect.py:36-48): reflect-pad n_fft//2
on both sides, hop-strided frames, periodic Hann window, |rfft|. Frames are
one gather over a grid of folded indices, so the reflect padding is NumPy's
for any length, also when the pad is longer than the signal (where
``torch.nn.functional.pad`` refuses). The FFT is ``torch.fft`` (cuFFT on
the card), as the JAX package leaves it to ``jnp.fft`` outside any kernel.

Also the inverse transforms: weighted-overlap-add iSTFT and Griffin-Lim
with momentum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window — scipy.signal.get_window('hann', N, fftbins=True)."""
    n = np.arange(n_fft, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    return w.astype(dtype)


def num_frames(n_samples: int, n_fft: int = 1024, hop: int = 256) -> int:
    """Frame count after reflect-padding n_fft//2 both sides (make_spect.py:38-41):
    (n + 2*(n_fft//2) - (n_fft - hop)) // hop == (n + hop) // hop for even n_fft."""
    padded = n_samples + 2 * (n_fft // 2)
    return (padded - (n_fft - hop)) // hop


def _window(n_fft: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The Hann window built in float64 and cast, as the JAX package does."""
    return torch.as_tensor(hann_window(n_fft, dtype=np.float64), device=device).to(dtype)


def _reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Index into a signal of length n of each position of its reflect-padded
    extension (``np.pad(mode='reflect')``): the extension is periodic with
    period 2(n-1), mirrored about 0 and n-1."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def frame_signal(x: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Reflect-pad and slice into overlapping frames.

    x: (..., L) -> (..., T, n_fft) with T = num_frames(L).
    """
    length = x.shape[-1]
    t = num_frames(length, n_fft, hop)
    pos = (torch.arange(t, device=x.device)[:, None] * hop
           + torch.arange(n_fft, device=x.device)[None, :] - n_fft // 2)
    return x[..., _reflect_index(pos, length)]


def stft_complex(x: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Complex STFT, frames-major: (..., L) -> (..., T, n_fft//2+1)."""
    frames = frame_signal(x, n_fft, hop)
    return torch.fft.rfft(frames * _window(n_fft, x.dtype, x.device), n=n_fft, dim=-1)


def stft_magnitude(x: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """|STFT|, frames-major (..., T, bins) — the reference's pySTFT returns
    the (bins, T) transpose."""
    return torch.abs(stft_complex(x, n_fft, hop))


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., T, n_fft) frames at stride hop -> (..., n_fft + (T-1)*hop),
    summed as the JAX package sums them: k = n_fft / hop phase streams (the
    frames f with f % k == p, which do not overlap), added in phase order.
    Hop block j of the output takes chunk q of frame j - q for q < k: each
    chunk is shifted into place by padding, and stream p takes at block j
    the chunk of the one frame of phase p there (q = (j - p) % k, zero past
    the ends), so that no size hangs on a comparison with T (which
    torch.export cannot prove for a symbolic T: ``serve.py``'s hybrid
    program)."""
    t, n_fft = frames.shape[-2:]
    k = n_fft // hop
    chunks = frames.reshape(*frames.shape[:-1], k, hop)
    shifted = torch.stack([F.pad(chunks[..., q, :], (0, 0, q, k - 1 - q)) for q in range(k)], dim=-3)
    block = torch.arange(t + k - 1, device=frames.device)
    total = None
    for p in range(k):
        stream = shifted[..., (block - p) % k, block, :]  # (..., T + k - 1, hop)
        total = stream if total is None else total + stream
    return total.reshape(*frames.shape[:-2], -1)


def istft(
    spec: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    length: int | None = None,
) -> torch.Tensor:
    """Weighted-overlap-add inverse of ``stft_complex``.

    spec: (..., T, n_fft//2+1) complex -> (..., L) real with
    L = (T-1)*hop (center padding removed), or `length` if given.
    """
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    window = _window(n_fft, frames.dtype, frames.device)
    frames = frames * window

    t = spec.shape[-2]
    out_len = n_fft + (t - 1) * hop
    if n_fft % hop:
        raise ValueError("istft requires n_fft divisible by hop")
    total = _overlap_add(frames, hop)
    # the window sum counts real frames only
    wsum = _overlap_add((window.float() ** 2).expand(t, n_fft), hop)
    y = total / torch.clamp(wsum, min=1e-10).to(total.dtype)
    pad = n_fft // 2
    if length is None:
        return y[..., pad : out_len - pad]
    # exactly `length` samples (librosa semantics); beyond the WOLA buffer
    # the tail is zero
    extra = pad + length - out_len
    if extra > 0:
        y = torch.cat([y, y.new_zeros(*y.shape[:-1], extra)], dim=-1)
    return y[..., pad : pad + length]


def griffin_lim(
    mag: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: int | None = None,
    generator: torch.Generator | None = None,
    init_phase: torch.Tensor | None = None,
) -> torch.Tensor:
    """Griffin-Lim phase reconstruction (librosa-style with momentum).

    mag: (..., T, bins) magnitude -> (..., L) waveform. ``generator`` draws
    the random initial phase (a generator seeded with 0 when None; the JAX
    package takes a ``jax.random`` key, whose numbers differ);
    ``init_phase``, (..., T, bins) complex unit phasors, starts from a given
    phase instead.
    """
    t = mag.shape[-2]
    out_len = (t - 1) * hop if length is None else length
    if init_phase is not None:
        init_phase = torch.as_tensor(init_phase, device=mag.device)
        angles = (init_phase / torch.clamp(torch.abs(init_phase), min=1e-16)).to(torch.complex64)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = torch.rand(mag.shape, generator=generator, dtype=torch.float32).to(mag.device)
        angles = torch.exp(2j * math.pi * u).to(torch.complex64)
    mag_c = mag.to(torch.complex64)
    rebuilt = torch.zeros_like(mag_c)
    for _ in range(n_iter):
        tprev = rebuilt
        inv = istft(mag_c * angles, n_fft, hop, length=out_len)
        rebuilt = stft_complex(inv, n_fft, hop)[..., :t, :]
        tnew = rebuilt - (momentum / (1.0 + momentum)) * tprev
        angles = tnew / torch.clamp(torch.abs(tnew), min=1e-16)
    return istft(mag_c * angles, n_fft, hop, length=out_len)
