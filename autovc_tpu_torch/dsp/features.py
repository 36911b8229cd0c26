"""Feature pipelines: waveform -> {spmel, stft, legacy, wav} features
(counterpart of ``autovc_tpu/dsp/features.py``; reference make_spect.py:50-94).

On the card, in float32, the chain is: the biquad highpass
(``ops/csrc/sosfilt.cu``, two passes), x 0.96 + dither, the framed rFFT
(cuFFT), and for 'spmel' the fused mel projection + dB normalization
(``ops/csrc/mel_norm.cu``, over each filter's own bins). For 'stft' and
'legacy' the dB normalization, and for 'wav' the robust scaling, are plain
torch on the card, as they are plain XLA in the JAX package. float64 is
the parity path: the transfer-function ``filtfilt`` of scipy's arithmetic,
on the CPU only.
Host-side pieces (filter design, mel basis, the per-speaker dither stream)
are NumPy/SciPy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import AudioConfig
from autovc_tpu_torch.dsp.filters import butter_highpass, butter_highpass_sos, filtfilt, sos_filtfilt
from autovc_tpu_torch.dsp.mel import mel_filterbank
from autovc_tpu_torch.dsp.stft import stft_magnitude
from autovc_tpu_torch.ops.mel import mel_normalize, normalize_db

__all__ = ["normalize_db", "denormalize_db", "robust_scale", "dither_reference", "mel_from_stft_mag",
           "MelFrontend"]


def denormalize_db(s: torch.Tensor, ref_db: float = 16.0, min_db: float = -100.0) -> torch.Tensor:
    """Inverse of normalize_db (up to the clip): [0,1] -> linear magnitude."""
    db = s * -min_db + min_db + ref_db
    return torch.pow(10.0, db / 20.0)


def _quantiles(x: torch.Tensor, qs: tuple[float, ...]) -> list[torch.Tensor]:
    """Linear-interpolation quantiles (fractions in [0, 1]) along the last
    axis, keepdim, from one sort: NumPy's default method, which
    ``jnp.percentile`` uses and which at 0.5 is ``jnp.median``'s midpoint
    (``torch.median`` returns the lower middle value, and ``torch.quantile``
    refuses inputs above 2^24 elements)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        w = pos - lo
        out.append(s[..., lo : lo + 1] * (1.0 - w) + s[..., hi : hi + 1] * w)
    return out


def robust_scale(x: torch.Tensor, q_low: float = 5.0, q_high: float = 95.0) -> torch.Tensor:
    """Per-utterance robust scaling: (x - median) / (q95 - q5), matching
    sklearn.RobustScaler(quantile_range=(5,95)).fit_transform on a 1-D
    waveform (make_spect.py:88)."""
    med, lo, hi = _quantiles(x, (0.5, q_low / 100.0, q_high / 100.0))
    return (x - med) / (hi - lo)


def dither_reference(n: int, speaker_seed: int, n_prior: int = 0) -> np.ndarray:
    """The reference's dither noise stream: per-speaker RandomState(seed) where
    seed = int(speaker_dir[1:]), consuming prng.rand(len) per file in sorted
    order (make_spect.py:68,76). `n_prior` is the total sample count of files
    processed earlier for the same speaker (to position the stream)."""
    prng = np.random.RandomState(speaker_seed)
    if n_prior:
        prng.rand(n_prior)
    return ((prng.rand(n) - 0.5) * 1e-6).astype(np.float64)


def mel_from_stft_mag(mag: torch.Tensor, mel_basis: torch.Tensor) -> torch.Tensor:
    """(..., T, n_bins) @ (n_bins, n_mels): the projection alone (the front
    end fuses it with the dB step in ``ops.mel``)."""
    return torch.matmul(mag, torch.as_tensor(mel_basis, device=mag.device).to(mag.dtype))


class MelFrontend:
    """Holds the filter coefficients and the mel basis (built once, host
    float64) and extracts features on ``device``.

    ``dtype=torch.float32`` is the production path, on the card by default;
    ``dtype=torch.float64`` is the parity path of scipy's arithmetic and runs
    on the CPU only. Inputs are array-likes or tensors of shape (..., L);
    outputs are tensors on ``device``.
    """

    def __init__(self, audio: AudioConfig = AudioConfig(), dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"MelFrontend computes in float32 or float64, not {dtype}")
        self.device = resolve_device(device)
        if dtype == torch.float64 and self.device.type != "cpu":
            raise ValueError("the float64 front end runs on the CPU only (device='cpu'); "
                             "the card runs float32")
        self.audio = audio
        self.dtype = dtype
        self.b, self.a = butter_highpass(audio.highpass_cutoff_hz, audio.sample_rate, audio.highpass_order)
        self.sos = butter_highpass_sos(audio.highpass_cutoff_hz, audio.sample_rate, audio.highpass_order)
        self.mel_basis = mel_filterbank(audio.sample_rate, audio.n_fft, audio.n_mels, audio.mel_fmin,
                                        audio.mel_fmax, dtype=np.float64)
        self._mel_basis_dev = torch.as_tensor(self.mel_basis, dtype=dtype, device=self.device).contiguous()

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v).to(device=self.device, dtype=self.dtype)

    def highpass_dither(self, wav, noise=None) -> torch.Tensor:
        """filtfilt highpass then y*0.96 + noise (make_spect.py:74-76):
        the transfer-function form in float64, the biquad cascade in float32."""
        wav = self._tensor(wav)
        with exact_f32(self.device):
            if self.dtype == torch.float64:
                y = filtfilt(self.b, self.a, wav)
            else:
                y = sos_filtfilt(self.sos, wav)
            if noise is None:
                return y
            return y * 0.96 + self._tensor(noise)

    def _db(self, mag: torch.Tensor) -> torch.Tensor:
        return normalize_db(mag, self.audio.ref_level_db, self.audio.min_level_db)

    def from_filtered(self, model_type: str, w) -> torch.Tensor:
        """The ``model_type`` features of a waveform that ``highpass_dither``
        has already filtered and dithered."""
        w = self._tensor(w)
        with exact_f32(self.device):
            if model_type == "spmel":  # one ops.mel launch over every frame of the batch
                mag = stft_magnitude(w, self.audio.n_fft, self.audio.hop_length)
                lead, n_bins = mag.shape[:-1], mag.shape[-1]
                out = mel_normalize(mag.reshape(-1, n_bins), self._mel_basis_dev, self.audio.ref_level_db,
                                    self.audio.min_level_db)
                return out.reshape(*lead, out.shape[-1])
            if model_type == "stft":
                return self._db(stft_magnitude(w, self.audio.n_fft, self.audio.hop_length))
            if model_type == "legacy":
                return self._db(stft_magnitude(w, self.audio.legacy_n_fft, self.audio.hop_length))
            if model_type == "wav":
                return robust_scale(w, *self.audio.robust_quantile_range)[..., None]
        raise ValueError(f"unknown model_type {model_type!r}")

    def mel_features(self, wav, noise=None) -> torch.Tensor:
        """wav (..., L) -> normalized mel (..., T, 80) — the 'spmel' variant."""
        return self.extract("spmel", wav, noise)

    def stft_features(self, wav, noise=None) -> torch.Tensor:
        """wav (..., L) -> normalized |STFT| (..., T, 513) — the 'stft' variant."""
        return self.extract("stft", wav, noise)

    def legacy_stft_features(self, wav, noise=None) -> torch.Tensor:
        """wav (..., L) -> normalized |STFT| (..., T, 257) — the legacy 512-pt
        variant ("old code/make_spect_old.py":19-66: same highpass/dither/dB
        chain)."""
        return self.extract("legacy", wav, noise)

    def wav_features(self, wav, noise=None) -> torch.Tensor:
        """wav (..., L) -> robust-scaled waveform (..., L, 1) — the 'wav' variant."""
        return self.extract("wav", wav, noise)

    def extract(self, model_type: str, wav, noise=None) -> torch.Tensor:
        return self.from_filtered(model_type, self.highpass_dither(wav, noise))
