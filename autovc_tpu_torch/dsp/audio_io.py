"""Host-side WAV I/O with the stdlib ``wave`` module (a copy of
``autovc_tpu/dsp/audio_io.py``).

Reproduces what the reference got from librosa.load(sr=16000) for a 16 kHz
16-bit mono corpus: int16 -> float32 / 32768. Writing scales symmetrically
by 32767 and rounds to 16-bit PCM.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str, expected_sr: int | None = 16_000) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono samples in [-1, 1), sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    if expected_sr is not None and sr != expected_sr:
        raise ValueError(
            f"{path}: sample rate {sr} != {expected_sr}; resample offline first"
        )
    return x, sr


def write_wav(path: str, x: np.ndarray, sr: int = 16_000) -> None:
    """Write float waveform in [-1, 1] as 16-bit PCM WAV."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
