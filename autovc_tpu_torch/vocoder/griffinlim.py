"""Griffin-Lim mel vocoder: mel (T, 80, normalized) -> denormalize ->
pseudo-inverse mel basis -> linear magnitude (T, 513) -> Griffin-Lim phase
reconstruction -> waveform.

Counterpart of ``autovc_tpu/vocoder/griffinlim.py`` (the reference's
notebook fallback, vocoder_stft.ipynb cell 0 / istft.ipynb cells 4-6), on
this package's ``dsp.griffin_lim`` and ``dsp.denormalize_db``. Plain
PyTorch on the device of its input; no kernel. The random initial phase
comes from a ``torch.Generator`` (seed 0 when None), whose numbers differ
from JAX's ``key``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from autovc_tpu_torch.config import AudioConfig
from autovc_tpu_torch.dsp.features import denormalize_db
from autovc_tpu_torch.dsp.mel import mel_filterbank
from autovc_tpu_torch.dsp.stft import griffin_lim


@functools.lru_cache(maxsize=4)
def _pinv_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, dtype=np.float64)  # (bins, mels)
    return np.linalg.pinv(fb).astype(np.float32)  # (mels, bins)


def mel_to_linear(mel: torch.Tensor, audio: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Normalized mel (..., T, n_mels) -> linear magnitude (..., T, bins)."""
    mel = torch.as_tensor(mel, dtype=torch.float32)
    inv = torch.from_numpy(
        _pinv_basis(audio.sample_rate, audio.n_fft, audio.n_mels, audio.mel_fmin, audio.mel_fmax)).to(mel.device)
    mag_mel = denormalize_db(mel, audio.ref_level_db, audio.min_level_db)
    return torch.clamp(mag_mel @ inv, min=0.0)


def mel_to_waveform(mel: torch.Tensor, audio: AudioConfig = AudioConfig(), n_iter: int = 60,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Normalized mel (T, n_mels) -> waveform via Griffin-Lim."""
    lin = mel_to_linear(mel, audio)
    return griffin_lim(lin, audio.n_fft, audio.hop_length, n_iter=n_iter, generator=generator)


def stft_to_waveform(stft_norm: torch.Tensor, audio: AudioConfig = AudioConfig(), n_iter: int = 60,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Normalized |STFT| (T, n_fft//2+1) -> waveform: the stft variant's
    direct Griffin-Lim path (the reference's vocoder_stft.ipynb cell 0 ran
    librosa.griffinlim on the converted STFT magnitudes)."""
    mag = denormalize_db(torch.as_tensor(stft_norm, dtype=torch.float32), audio.ref_level_db, audio.min_level_db)
    return griffin_lim(mag, audio.n_fft, audio.hop_length, n_iter=n_iter, generator=generator)
