"""Conversion inference for the spmel generator.

Counterpart of ``autovc_tpu/convert/__init__.py``: pad the source mel to a
multiple of ``freq``, run the generator with the source and target speaker
embeddings, strip the padding. A spec is any object with ``src_features``
(T, n_bins), ``src_embedding`` (dim_emb,) and ``trg_embedding`` (dim_emb,),
such as the JAX package's ``ConversionSpec``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.models import Generator


def pad_seq(x: np.ndarray, base: int = 32) -> tuple[np.ndarray, int]:
    """Right-pad (T, F) with zeros to a multiple of ``base``; returns the
    padded array and the number of rows added."""
    len_out = int(base * math.ceil(x.shape[0] / base))
    len_pad = len_out - x.shape[0]
    return np.pad(x, ((0, len_pad), (0, 0)), "constant"), len_pad


class Converter:
    """Runs conversions through a generator built by
    ``autovc_tpu_torch.models.build_generator``, on that generator's device."""

    def __init__(self, generator: Generator, cfg: ModelConfig = ModelConfig()):
        self.generator = generator
        self.cfg = cfg
        self.device = next(generator.parameters()).device

    @torch.inference_mode()
    def _forward(self, x: np.ndarray, emb_org: np.ndarray, emb_trg: np.ndarray) -> torch.Tensor:
        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        _, x_psnt, _ = self.generator(dev(x), dev(emb_org), dev(emb_trg))
        return x_psnt

    def convert(self, spec: Any) -> np.ndarray:
        """One conversion -> output features (T, n_bins), padding stripped."""
        x, len_pad = pad_seq(spec.src_features, base=self.cfg.freq)
        out = self._forward(x[None], spec.src_embedding[None], spec.trg_embedding[None])
        out = out[0].cpu().numpy()
        return out[: out.shape[0] - len_pad]

    def convert_batch(self, specs: Sequence[Any], batch_size: int = 8) -> list[np.ndarray]:
        """Conversions grouped by padded length, ``batch_size`` at a time (a
        short group is filled with zero rows); results in the order of
        ``specs``, each with its padding stripped."""
        results: list[np.ndarray | None] = [None] * len(specs)
        by_length: dict[int, list[tuple[int, np.ndarray, int]]] = {}
        for i, s in enumerate(specs):
            x, len_pad = pad_seq(s.src_features, base=self.cfg.freq)
            by_length.setdefault(x.shape[0], []).append((i, x, len_pad))

        for t, items in by_length.items():
            for off in range(0, len(items), batch_size):
                group = items[off : off + batch_size]
                xs = np.zeros((batch_size, t, group[0][1].shape[-1]), np.float32)
                es = np.zeros((batch_size, specs[group[0][0]].src_embedding.shape[0]), np.float32)
                et = np.zeros_like(es)
                for k, (i, x, _) in enumerate(group):
                    xs[k] = x
                    es[k] = specs[i].src_embedding
                    et[k] = specs[i].trg_embedding
                out = self._forward(xs, es, et).cpu().numpy()
                for k, (i, _, len_pad) in enumerate(group):
                    results[i] = out[k][: t - len_pad]
        return results  # type: ignore[return-value]
