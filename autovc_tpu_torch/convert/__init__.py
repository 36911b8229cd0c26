"""Conversion inference for the generator family (spmel, stft, wav).

Counterpart of ``autovc_tpu/convert/__init__.py``: pad the source features
to a multiple of ``freq`` (or to a coarser bucket), run the generator with
the source and target speaker embeddings, strip the padding, and project a
513-bin stft output onto the 80 mel bands for the vocoder
(``convert_to_mel``, ``convert_batch(to_mel=True)``: a plain product,
``torch.matmul`` in exact float32 on the card). ``WavConverter`` converts a
raw waveform and re-extracts the vocoder's mel from the waveform it
produced. A spec is any object with ``src_features`` (T, n_bins) (a
waveform (L, 1) for wav), ``src_embedding`` (dim_emb,) and
``trg_embedding`` (dim_emb,), such as ``data.ConversionSpec``;
``run_conversions`` writes the results manifest and ``all_pairs_specs``
builds the N x N matrix of a train manifest.

A generator built with ``compute_dtype="bfloat16"`` converts in bfloat16;
the results are float32 NumPy arrays holding the bfloat16 values exactly
(NumPy has no bfloat16: the JAX package returns ml_dtypes bfloat16 arrays
of the same values), and the stft projection takes them widened to
float32.
"""

from __future__ import annotations

import math
import os
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np
import torch

from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.config import AudioConfig, ModelConfig, wav_len_crop
from autovc_tpu_torch.data.manifest import ConversionSpec, SpeakerEntry, save_results
from autovc_tpu_torch.dsp.features import MelFrontend
from autovc_tpu_torch.dsp.mel import mel_filterbank

if TYPE_CHECKING:  # the serving path imports pad_seq without the model code
    from autovc_tpu_torch.models import Generator, GeneratorWav


def pad_seq(x: np.ndarray, base: int = 32) -> tuple[np.ndarray, int]:
    """Right-pad (T, F) with zeros to a multiple of ``base``; returns the
    padded array and the number of rows added."""
    len_out = int(base * math.ceil(x.shape[0] / base))
    len_pad = len_out - x.shape[0]
    return np.pad(x, ((0, len_pad), (0, 0)), "constant"), len_pad


def bucket_length(t: int, base: int = 32, bucket: int = 256) -> int:
    """The multiple of ``bucket`` (itself a multiple of ``base``) covering
    ``t``: a few padded lengths instead of one a ``base``."""
    if bucket % base:
        raise ValueError(f"bucket {bucket} is not a multiple of base {base}")
    return int(bucket * math.ceil(t / bucket))


class Converter:
    """Runs conversions through a spmel or stft generator built by
    ``autovc_tpu_torch.models.build_generator``, on that generator's device.

    ``use_buckets=False`` pads as the reference does (to a multiple of
    ``freq``); ``use_buckets=True`` pads to multiples of 256 frames, fewer
    distinct shapes at the cost of other BLSTM context in the padded tail.
    ``audio`` gives the mel basis of the stft projection."""

    def __init__(self, generator: Generator, cfg: ModelConfig = ModelConfig(), audio: AudioConfig = AudioConfig(),
                 use_buckets: bool = False):
        self.generator = generator
        self.cfg = cfg
        self.use_buckets = use_buckets
        self.device = next(generator.parameters()).device
        self.mel_basis = torch.from_numpy(mel_filterbank(audio.sample_rate, audio.n_fft, audio.n_mels,
                                                         audio.mel_fmin, audio.mel_fmax)).to(self.device)

    @torch.inference_mode()
    def _forward(self, x: np.ndarray, emb_org: np.ndarray, emb_trg: np.ndarray, to_mel: bool = False
                 ) -> torch.Tensor:
        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        with exact_f32(self.device):
            _, x_psnt, _ = self.generator(dev(x), dev(emb_org), dev(emb_trg))
            out = x_psnt.float()
            if to_mel and self.cfg.model_type == "stft":
                out = torch.matmul(out, self.mel_basis)
        return out

    def project_mel(self, features: np.ndarray) -> np.ndarray:
        """(..., n_bins) features -> (..., 80) mel: stft features through the
        mel basis (conversion.py:102: ``np.dot(uttr_trg, mel_basis)``), spmel
        features as they are."""
        if self.cfg.model_type != "stft":
            return features
        with torch.inference_mode(), exact_f32(self.device):
            x = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
            return torch.matmul(x, self.mel_basis).cpu().numpy()

    def convert(self, spec: Any) -> np.ndarray:
        """One conversion -> output features (T, n_bins), padding stripped."""
        return self.convert_batch([spec], batch_size=1, to_mel=False)[0]

    def convert_to_mel(self, spec: Any) -> np.ndarray:
        """One conversion, a stft output projected onto the mel bands."""
        return self.convert_batch([spec], batch_size=1)[0]

    def convert_batch(self, specs: Sequence[Any], batch_size: int = 8, to_mel: bool = True) -> list[np.ndarray]:
        """Conversions grouped by padded length (or bucket), ``batch_size`` at
        a time (a short group is filled with zero rows); results in the order
        of ``specs``, each with its padding stripped, and with ``to_mel``
        stft outputs projected onto the mel bands on the device."""
        results: list[np.ndarray | None] = [None] * len(specs)
        by_length: dict[int, list[tuple[int, np.ndarray]]] = {}
        for i, s in enumerate(specs):
            x, _ = pad_seq(s.src_features, base=self.cfg.freq)
            tb = bucket_length(x.shape[0], self.cfg.freq) if self.use_buckets else x.shape[0]
            by_length.setdefault(tb, []).append((i, x))

        for tb, items in by_length.items():
            for off in range(0, len(items), batch_size):
                group = items[off : off + batch_size]
                xs = np.zeros((batch_size, tb, group[0][1].shape[-1]), np.float32)
                es = np.zeros((batch_size, specs[group[0][0]].src_embedding.shape[0]), np.float32)
                et = np.zeros_like(es)
                for k, (i, x) in enumerate(group):
                    xs[k, : x.shape[0]] = x
                    es[k] = specs[i].src_embedding
                    et[k] = specs[i].trg_embedding
                out = self._forward(xs, es, et, to_mel).cpu().numpy()
                for k, (i, _) in enumerate(group):
                    results[i] = out[k][: specs[i].src_features.shape[0]]
        return results  # type: ignore[return-value]


class WavConverter:
    """Raw-waveform conversion (reference conversion_nina.py:42-189) through
    a ``GeneratorWav``, on its device. The input features are robust-scaled
    waveforms (L, 1); the generator gives a waveform, from which the
    vocoder's mel is re-extracted (conversion_nina.py:144-146) by the
    float32 ``MelFrontend`` without dither (on the card: the ``sosfilt``
    and ``mel_norm`` kernels)."""

    def __init__(self, generator: GeneratorWav, cfg: ModelConfig = ModelConfig(model_type="wav"),
                 audio: AudioConfig = AudioConfig()):
        self.generator = generator
        self.cfg = cfg
        self.audio = audio
        self.device = next(generator.parameters()).device
        self.frontend = MelFrontend(audio, torch.float32, device=self.device)

    def valid_length(self, n: int) -> int:
        """The largest L <= n whose latent has a multiple of ``freq`` frames
        (the reference fixes 33536 samples, 128 frames;
        conversion_nina.py:74)."""
        frames = (n - self.audio.win_length) // self.audio.hop_length + 1
        frames -= frames % self.cfg.freq
        if frames <= 0:
            raise ValueError(f"utterance too short for conversion: {n} samples")
        return wav_len_crop(self.audio, frames)

    @torch.inference_mode()
    def convert(self, spec: Any) -> np.ndarray:
        """-> the converted waveform (L,), L the valid length."""
        x = np.asarray(spec.src_features, np.float32)
        if x.ndim == 1:
            x = x[:, None]
        n = self.valid_length(x.shape[0])

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        with exact_f32(self.device):
            out = self.generator(dev(x[None, :n]), dev(spec.src_embedding[None]), dev(spec.trg_embedding[None]))[1]
        return out[0, :, 0].float().cpu().numpy()

    def convert_to_mel(self, spec: Any) -> np.ndarray:
        """The converted waveform's mel (T, 80) for the vocoder."""
        return self.frontend.mel_features(self.convert(spec)).cpu().numpy()


def run_conversions(converter: Converter | WavConverter, specs: Sequence[Any], results_path: str | None = None
                    ) -> list[tuple[str, np.ndarray]]:
    """The conversion.py main loop: every spec -> ``[(str(id), mel)]``,
    pickled to ``results_path`` when given (``data.save_results``)."""
    results = [(str(s.conversion_id), converter.convert_to_mel(s)) for s in specs]
    if results_path:
        save_results(results_path, results)
    return results


def all_pairs_specs(entries: Sequence[SpeakerEntry], feature_dir: str, utterance_index: int = 0
                    ) -> list[ConversionSpec]:
    """The AutoVC N x N conversion matrix (conversion_temp.py:82-101): each
    speaker's ``utterance_index``-th utterance converted to every speaker,
    ids 0 .. N*N-1 in source-major order."""
    specs = []
    for src in entries:
        rel = src.utterances[utterance_index]
        feats = np.load(os.path.join(feature_dir, rel))
        name = os.path.basename(rel)[: -len(".npy")]
        for trg in entries:
            specs.append(ConversionSpec(conversion_id=len(specs), src_name=name, src_embedding=src.embedding,
                                        src_features=feats, trg_speaker=trg.speaker_id,
                                        trg_embedding=trg.embedding, src_speaker=src.speaker_id))
    return specs


__all__ = ["Converter", "WavConverter", "all_pairs_specs", "bucket_length", "pad_seq", "run_conversions"]
