"""Hybrid neural + Griffin-Lim vocoder: a neural vocoder's waveform gives the
phase, the mel gives the magnitude, and a few Griffin-Lim iterations make
the two consistent.

Counterpart of ``autovc_tpu/vocoder/hybrid.py``: the neural waveform's STFT
phase starts ``dsp.stft.griffin_lim`` (``init_phase``) on the linear
magnitude the mel implies (``vocoder.griffinlim.mel_to_linear``), so the
output keeps the magnitude the fidelity metric checks and the neural
vocoder's phase. Plain PyTorch (cuFFT on a card), as it is plain XLA in
JAX; not the WaveNet kernel's hybrid-ring form.
"""

from __future__ import annotations

import numpy as np
import torch

from autovc_tpu_torch.config import AudioConfig
from autovc_tpu_torch.dsp.stft import griffin_lim, stft_complex
from autovc_tpu_torch.vocoder.griffinlim import mel_to_linear


class HybridVocoder:
    """Wraps any neural vocoder with ``generate(mel) -> waveform``."""

    def __init__(self, neural, audio: AudioConfig = AudioConfig(), n_iter: int = 2):
        self.neural = neural
        self.audio = audio
        self.n_iter = n_iter

    def generate(self, mel: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Normalized mel (T, n_mels) -> waveform (T * hop,), on the neural
        vocoder's device."""
        wav0 = torch.as_tensor(self.neural.generate(mel))
        return refine_with_mel_magnitude(wav0, torch.as_tensor(mel, device=wav0.device), self.audio,
                                         n_iter=self.n_iter)


def refine_with_mel_magnitude(wav: torch.Tensor, mel: torch.Tensor, audio: AudioConfig = AudioConfig(),
                              n_iter: int = 2) -> torch.Tensor:
    """``wav`` projected onto the magnitude ``mel`` implies: its STFT phase
    (padded with its last frame where the waveform is short, cut to the
    mel's T frames) with the mel-derived magnitude, then ``n_iter``
    Griffin-Lim iterations (0: one inverse STFT). The output has T * hop
    samples, as the neural vocoders' do."""
    lin = mel_to_linear(torch.as_tensor(mel, dtype=torch.float32, device=wav.device), audio)
    t = lin.shape[-2]
    phase = stft_complex(wav, audio.n_fft, audio.hop_length)
    if phase.shape[-2] < t:
        reps = phase[..., -1:, :].expand(*phase.shape[:-2], t - phase.shape[-2], phase.shape[-1])
        phase = torch.cat([phase, reps], dim=-2)
    else:
        phase = phase[..., :t, :]
    return griffin_lim(lin, audio.n_fft, audio.hop_length, n_iter=n_iter, length=t * audio.hop_length,
                       init_phase=phase)
