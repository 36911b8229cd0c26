"""Slaney-scale mel filterbank, numerically matching librosa 0.9's
``librosa.filters.mel(sr, n_fft, fmin, fmax, n_mels)`` with the default
``htk=False, norm='slaney'`` — the filterbank the reference uses everywhere
(make_spect.py:51, conversion.py:30, solver_encoder.py:43).

A copy of ``autovc_tpu/dsp/mel.py``: NumPy in float64 on the host, so the
basis is bit for bit the JAX package's. The card sees a dense
(n_fft//2 + 1, n_mels) float32 matrix, the right operand of the mel kernel
(``ops.mel``).
"""

from __future__ import annotations

import numpy as np

# Slaney auditory-toolbox mel scale constants
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    """Hz -> mel (Slaney scale, piecewise linear/log)."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-30) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mel):
    """mel -> Hz (Slaney scale inverse)."""
    mel = np.asarray(mel, dtype=np.float64)
    freq = _F_SP * mel
    log_region = mel >= _MIN_LOG_MEL
    freq = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), freq)
    return freq


def mel_filterbank(
    sr: int = 16_000,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 90.0,
    fmax: float = 7600.0,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank with Slaney area normalization.

    Returns shape (n_fft//2 + 1, n_mels), transposed the way the reference
    applies it (``np.dot(D.T, mel_basis)``, make_spect.py:51,81), so that
    ``mel_spec = stft_mag_frames @ mel_filterbank(...)``.
    """
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins, dtype=np.float64)

    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]  # (n_mels+2, n_bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_bins)

    # Slaney normalization: each filter has unit area in Hz
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]

    return weights.T.astype(dtype)  # (n_bins, n_mels)
