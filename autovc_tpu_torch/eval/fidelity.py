"""Spectral fidelity metrics beyond plain mel-L1.

A copy of ``autovc_tpu/eval/fidelity.py`` (NumPy and SciPy only):
mel-cepstral distortion weights the spectral envelope, the standard
objective metric of voice conversion, beside mel L1 and MSE. Frames are
assumed time-aligned (both mels extracted at the same hop), so no DTW.
"""

from __future__ import annotations

import numpy as np
from scipy.fftpack import dct


def _norm_mel_to_ln(mel: np.ndarray, ref_db: float = 16.0, min_db: float = -100.0):
    """Normalized mel -> natural-log magnitude: the inverse of the dB
    normalisation's affine part (db = norm * -min_db + min_db + ref_db)."""
    db = np.asarray(mel, np.float64) * -min_db + min_db + ref_db
    return db * (np.log(10.0) / 20.0)


def mel_cepstral_distortion(
    mel_a: np.ndarray,
    mel_b: np.ndarray,
    n_coeffs: int = 13,
    ref_db: float = 16.0,
    min_db: float = -100.0,
) -> float:
    """MCD in dB between two normalized mel spectrograms (T, n_mels).

    DCT-II (ortho) cepstra of the natural-log mel spectrum; coefficients
    1..n_coeffs-1 (c0, the overall energy, excluded);
    mcd = (10/ln10) * sqrt(2) * mean_t ||c_a(t) - c_b(t)||_2.
    """
    n = min(mel_a.shape[0], mel_b.shape[0])
    ca = dct(_norm_mel_to_ln(mel_a[:n], ref_db, min_db), type=2, norm="ortho", axis=-1)
    cb = dct(_norm_mel_to_ln(mel_b[:n], ref_db, min_db), type=2, norm="ortho", axis=-1)
    d = ca[:, 1:n_coeffs] - cb[:, 1:n_coeffs]
    frame_dist = np.sqrt(np.sum(d * d, axis=-1))
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0) * frame_dist.mean())


def mel_fidelity_report(mel_ref: np.ndarray, mel_hyp: np.ndarray) -> dict:
    """L1 / MSE / MCD on aligned frames."""
    n = min(mel_ref.shape[0], mel_hyp.shape[0])
    d = np.asarray(mel_hyp[:n], np.float64) - np.asarray(mel_ref[:n], np.float64)
    return {
        "mel_l1": float(np.mean(np.abs(d))),
        "mel_mse": float(np.mean(d * d)),
        "mcd_db": mel_cepstral_distortion(mel_ref, mel_hyp),
    }
