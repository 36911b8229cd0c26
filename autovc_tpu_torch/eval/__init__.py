"""Quantitative quality evaluation: speaker similarity and verification EER.

Counterpart of ``autovc_tpu/eval/__init__.py``:

- ``SpeakerEmbedder``: the windowed GE2E d-vector embedding of an utterance,
  on ``device`` (the LSTM kernels on a card, the plain recurrence on the CPU);
- ``load_speaker_mels`` and ``speaker_centroids``: the per-speaker mean
  embedding over the first utterances of each speaker in a manifest;
- ``similarity_record`` and ``summarize_similarity``: a converted output
  re-embedded and scored by cosine to the target and to the source centroid;
- ``verification_eer`` and ``embedding_separation``: the encoder's own
  quality gate over all utterance pairs.

Everything but the embedder is the JAX package's NumPy code, copied.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.config import SpeakerEncoderConfig
from autovc_tpu_torch.models import build_dvector, dvector_for_params

WINDOW_STRIDE = 64  # frames between the starts of two embedding windows (half a crop)


class SpeakerEmbedder:
    """Frozen d-vector encoder -> one unit embedding per utterance.

    Windows of ``len_crop`` frames at ``stride``, the tail window always
    included and a short utterance zero-padded to one window; the window
    batch is padded to a multiple of 8 (masked out of the mean), which keeps
    the LSTM kernels' launch plans to a few batch sizes. ``params`` is a GE2E
    checkpoint tree (``{'dvector', 'w', 'b'}``) or bare DVector params
    (numpy); the encoder is sized to it, and explicit dims override."""

    def __init__(
        self,
        params: dict,
        dim_input: int | None = None,
        dim_cell: int | None = None,
        dim_emb: int | None = None,
        len_crop: int = SpeakerEncoderConfig.len_crop,
        stride: int = WINDOW_STRIDE,
        *,
        device: str | torch.device = "cuda",
    ):
        self.params = params.get("dvector", params)
        inferred = dvector_for_params(self.params)
        dims = (dim_input or inferred.dim_input, dim_cell or inferred.dim_cell, dim_emb or inferred.dim_emb)
        if dims != (inferred.dim_input, inferred.dim_cell, inferred.dim_emb):
            raise ValueError(f"DVector dims {dims} do not match the checkpoint's "
                             f"{(inferred.dim_input, inferred.dim_cell, inferred.dim_emb)}")
        self.model = build_dvector(self.params, device=device)
        self.device = next(self.model.parameters()).device
        self.len_crop = len_crop
        self.stride = stride

    def _windows(self, mel: np.ndarray) -> np.ndarray:
        t = mel.shape[0]
        if t <= self.len_crop:
            w = np.zeros((1, self.len_crop, mel.shape[1]), np.float32)
            w[0, :t] = mel
            return w
        starts = list(range(0, t - self.len_crop + 1, self.stride))
        if starts[-1] != t - self.len_crop:  # always cover the tail
            starts.append(t - self.len_crop)
        return np.stack([mel[s : s + self.len_crop] for s in starts]).astype(np.float32)

    @torch.inference_mode()
    def embed(self, mel: np.ndarray) -> np.ndarray:
        """(T, n_mels) -> (dim_emb,) unit vector: one d-vector forward over
        the utterance's windows on the embedder's device."""
        w = self._windows(np.asarray(mel, np.float32))
        n = w.shape[0]
        pad = (-n) % 8
        if pad:
            w = np.concatenate([w, np.zeros((pad,) + w.shape[1:], np.float32)])
        with exact_f32(self.device):
            e = self.model(torch.from_numpy(w).to(self.device)).cpu().numpy()[:n]
        m = e.mean(axis=0)
        return m / (np.linalg.norm(m) + 1e-12)


def load_speaker_mels(feature_dir: str, entries, max_per_speaker: int = 10) -> dict[str, list[np.ndarray]]:
    """The centroid input recipe: the first ``max_per_speaker`` manifest
    utterances of each speaker, loaded from ``feature_dir``. Shared by the
    conversion evaluation and the Solver's lambda_spk 'windowed' protocol,
    so that training and evaluation use the same centroids."""
    return {
        e.speaker_id: [np.load(os.path.join(feature_dir, rel)) for rel in e.utterances[:max_per_speaker]]
        for e in entries
    }


def speaker_centroids(embedder: SpeakerEmbedder, mels_by_speaker: dict[str, list[np.ndarray]]
                      ) -> dict[str, np.ndarray]:
    """Per-speaker mean of utterance embeddings, L2-normalized
    (make_metadata.py:81's recipe with deterministic windows)."""
    out = {}
    for spk, mels in mels_by_speaker.items():
        es = np.stack([embedder.embed(m) for m in mels])
        c = es.mean(axis=0)
        out[spk] = c / (np.linalg.norm(c) + 1e-12)
    return out


def similarity_record(
    embedder: SpeakerEmbedder,
    centroids: dict[str, np.ndarray],
    converted_mel: np.ndarray,
    src: str,
    trg: str,
    orig_mel: np.ndarray | None = None,
) -> dict:
    """Score one conversion: cosine of the converted output's embedding to
    the target vs the source centroid (and the original utterance's cosines
    as the pre-conversion reference point)."""
    e = embedder.embed(converted_mel)
    rec = {
        "src": src,
        "trg": trg,
        "cos_trg": float(e @ centroids[trg]),
        "cos_src": float(e @ centroids[src]),
    }
    rec["success"] = rec["cos_trg"] > rec["cos_src"]
    rec["margin"] = rec["cos_trg"] - rec["cos_src"]
    if orig_mel is not None:
        eo = embedder.embed(orig_mel)
        rec["orig_cos_trg"] = float(eo @ centroids[trg])
        rec["orig_cos_src"] = float(eo @ centroids[src])
    return rec


def summarize_similarity(records: list[dict]) -> dict:
    """Aggregate cross-speaker records (src != trg) into the headline."""
    xs = [r for r in records if r["src"] != r["trg"]]
    if not xs:
        return {"pairs": 0}
    return {
        "pairs": len(xs),
        "success_rate": float(np.mean([r["success"] for r in xs])),
        "mean_cos_trg": float(np.mean([r["cos_trg"] for r in xs])),
        "mean_cos_src": float(np.mean([r["cos_src"] for r in xs])),
        "mean_margin": float(np.mean([r["margin"] for r in xs])),
        "median_margin": float(np.median([r["margin"] for r in xs])),
    }


def verification_eer(embeddings: np.ndarray, labels: np.ndarray) -> tuple[float, float]:
    """Speaker-verification equal error rate.

    embeddings: (N, D) unit vectors; labels: (N,) int speaker ids. All
    N*(N-1)/2 pairs are trials, scored by cosine. Returns (eer, threshold)
    where the false-accept rate equals the false-reject rate, interpolated
    linearly between the two straddling thresholds."""
    n = embeddings.shape[0]
    sims = embeddings @ embeddings.T
    iu = np.triu_indices(n, k=1)
    scores = sims[iu]
    same = (labels[:, None] == labels[None, :])[iu]
    assert same.any() and (~same).any(), "need both same- and cross-speaker pairs"

    order = np.argsort(-scores)  # descending: accept everything above the threshold
    scores_s, same_s = scores[order], same[order]
    n_same, n_diff = int(same.sum()), int((~same).sum())
    # sweeping the threshold down: after accepting k pairs,
    # FAR = diff accepted / n_diff, FRR = same rejected / n_same
    cum_same = np.cumsum(same_s)
    cum_diff = np.cumsum(~same_s)
    far = cum_diff / n_diff
    frr = (n_same - cum_same) / n_same
    d = far - frr
    k = int(np.argmax(d >= 0))  # first crossing
    if k == 0 or d[k] == d[k - 1]:
        eer, thr = (far[k] + frr[k]) / 2.0, scores_s[k]
    else:
        a = -d[k - 1] / (d[k] - d[k - 1])
        eer = far[k - 1] + a * (far[k] - far[k - 1])
        thr = scores_s[k - 1] + a * (scores_s[k] - scores_s[k - 1])
    return float(eer), float(thr)


def embedding_separation(embeddings: np.ndarray, labels: np.ndarray) -> dict:
    """Mean intra-speaker vs inter-speaker cosine."""
    n = embeddings.shape[0]
    sims = embeddings @ embeddings.T
    iu = np.triu_indices(n, k=1)
    scores = sims[iu]
    same = (labels[:, None] == labels[None, :])[iu]
    return {
        "intra_speaker_cos_mean": float(scores[same].mean()),
        "inter_speaker_cos_mean": float(scores[~same].mean()),
        "separation": float(scores[same].mean() - scores[~same].mean()),
    }


__all__ = [
    "SpeakerEmbedder",
    "embedding_separation",
    "load_speaker_mels",
    "similarity_record",
    "speaker_centroids",
    "summarize_similarity",
    "verification_eer",
]
