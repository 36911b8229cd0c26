"""Feature extraction CLI (counterpart of ``autovc_tpu/cli/make_spect.py``;
reference make_spect.py + main.py:19-24).

Walks <wav_dir>/<speaker>/*.wav and writes <main_dir>/<model_type>/<speaker>/
<utt>.npy feature files (float32). By default the float32 ``MelFrontend``
runs on the card: the highpass kernel (``ops/csrc/sosfilt.cu``, two
launches a file), the rFFT and, for spmel, the mel kernel
(``ops/csrc/mel_norm.cu``, one launch a file). ``--device cpu`` runs the
same chain with the kernels' plain versions. ``--exact`` is the JAX CLI's
default host chain, the reference's arithmetic: scipy filtfilt in float64 +
the per-speaker dither + the NumPy float64 STFT, mel and dB steps; it runs
no kernel and ignores ``--device``.

Usage: python -m autovc_tpu_torch.cli.make_spect --main_dir DIR [--wav_dir DIR]
           [--model_type spmel|stft|wav|legacy] [--mic mic1]
           [--device cuda|cpu] [--exact]

'legacy' is the old-code 512-pt/257-bin magnitude pipeline
("old code/make_spect_old.py").
"""

from __future__ import annotations

import argparse
import os
import zlib

import numpy as np
import scipy.signal

from autovc_tpu_torch.config import AudioConfig
from autovc_tpu_torch.dsp.audio_io import read_wav
from autovc_tpu_torch.dsp.filters import butter_highpass
from autovc_tpu_torch.dsp.mel import mel_filterbank
from autovc_tpu_torch.dsp.stft import hann_window

MODEL_TYPES = ("spmel", "stft", "wav", "legacy")


def _host_stft_mag(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    xp = np.pad(x, n_fft // 2, mode="reflect")
    t = (xp.shape[0] - (n_fft - hop)) // hop
    idx = np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = xp[idx] * hann_window(n_fft, np.float64)
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=-1))


def speaker_seed(speaker: str) -> int:
    """The per-speaker dither seed (make_spect.py:68): the digits of the
    directory name; a name without digits (the reference assumes VCTK
    'pNNN') hashes to a stable seed instead of failing on int('')."""
    digits = "".join(c for c in speaker if c.isdigit())
    return int(digits) if digits else zlib.crc32(speaker.encode()) % (2**31)


def exact_features(x: np.ndarray, noise: np.ndarray, model_type: str, audio: AudioConfig,
                   b: np.ndarray, a: np.ndarray, mel_basis: np.ndarray) -> np.ndarray:
    """The host chain (make_spect.py:74-88) in float64: highpass -> *0.96 +
    dither -> features."""
    min_level = 1e-5
    wav = scipy.signal.filtfilt(b, a, x.astype(np.float64)) * 0.96 + noise
    if model_type == "spmel":
        d = _host_stft_mag(wav, audio.n_fft, audio.hop_length)
        m = d @ mel_basis
        db = 20 * np.log10(np.maximum(min_level, m)) - audio.ref_level_db
        return np.clip((db + 100) / 100, 0, 1)
    if model_type in ("stft", "legacy"):
        n_fft = audio.n_fft if model_type == "stft" else audio.legacy_n_fft
        d = _host_stft_mag(wav, n_fft, audio.hop_length)
        db = 20 * np.log10(np.maximum(min_level, d)) - audio.ref_level_db
        return np.clip((db + 100) / 100, 0, 1)
    if model_type == "wav":
        med = np.median(wav)
        lo, hi = np.percentile(wav, audio.robust_quantile_range)
        return ((wav - med) / (hi - lo)).reshape(-1, 1)
    raise ValueError(f"unknown model_type {model_type!r}")


def extract_all(
    main_dir: str,
    wav_dir: str | None = None,
    model_type: str = "spmel",
    mic: str = "mic1",
    audio: AudioConfig = AudioConfig(),
    device: str = "cuda",
    exact: bool = False,
) -> list[str]:
    """Extract features for every speaker dir; returns the written paths."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}")
    if wav_dir is None:
        for cand in ("wav48_silence_trimmed", "wavs", "wav"):
            p = os.path.join(main_dir, cand)
            if os.path.isdir(p):
                wav_dir = p
                break
        else:
            raise FileNotFoundError(f"no wav directory under {main_dir}")

    save_dir = os.path.join(main_dir, model_type)
    if exact:
        b, a = butter_highpass(audio.highpass_cutoff_hz, audio.sample_rate, audio.highpass_order)
        mel_basis = mel_filterbank(audio.sample_rate, audio.n_fft, audio.n_mels, audio.mel_fmin,
                                   audio.mel_fmax, dtype=np.float64)
    else:
        from autovc_tpu_torch.dsp.features import MelFrontend

        fe = MelFrontend(audio, device=device)
    written = []

    speakers = sorted(d for d in os.listdir(wav_dir) if os.path.isdir(os.path.join(wav_dir, d)))
    for speaker in speakers:
        os.makedirs(os.path.join(save_dir, speaker), exist_ok=True)
        prng = np.random.RandomState(speaker_seed(speaker))
        for fname in sorted(os.listdir(os.path.join(wav_dir, speaker))):
            if mic in fname or not fname.endswith(".wav"):
                continue  # the excluded microphone (make_spect.py:70)
            x, _ = read_wav(os.path.join(wav_dir, speaker, fname), audio.sample_rate)
            noise = (prng.rand(x.shape[0]) - 0.5) * 1e-6
            if exact:
                s = exact_features(x, noise, model_type, audio, b, a, mel_basis)
            else:
                # the front end owns the whole chain (highpass -> *0.96 +
                # dither -> features): it gets the raw wav and the host
                # dither stream
                s = fe.extract(model_type, x, noise.astype(np.float32)).cpu().numpy()
            out = os.path.join(save_dir, speaker, fname[: fname.rfind(".")] + ".npy")
            np.save(out, np.asarray(s, np.float32), allow_pickle=False)
            written.append(out)
        print(f"[make_spect] {speaker}: done")
    return written


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--wav_dir", default=None)
    ap.add_argument("--model_type", default="spmel", choices=list(MODEL_TYPES))
    ap.add_argument("--mic", default="mic1", help="microphone substring to EXCLUDE")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--exact", action="store_true",
                    help="the float64 host chain of the reference (scipy filtfilt, NumPy STFT); no kernel")
    args = ap.parse_args(argv)
    return extract_all(args.main_dir, args.wav_dir, args.model_type, args.mic, device=args.device,
                       exact=args.exact)


if __name__ == "__main__":
    main()
