"""In-RAM utterance dataset and batch iterator.

Counterpart of ``autovc_tpu/data/dataset.py``, with the reference's sampling
semantics and the same ``np.random.default_rng(seed)`` stream, so one seed
gives the JAX iterator's batches:

- the dataset's length is its number of speakers;
- an epoch is a shuffled pass over the speakers, batched with drop_last;
- each sample draws a random utterance of its speaker and a random
  ``len_crop``-frame crop, zero-padded on the right when short.

Features load with a thread pool of ``np.load`` (the JAX package's optional
native loader is not ported), and the iterator has no per-host sharding.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from autovc_tpu_torch.data.manifest import SpeakerEntry, load_train_manifest


class UtteranceDataset:
    def __init__(self, root_dir: str, manifest: str | list[SpeakerEntry] = "train.pkl"):
        if isinstance(manifest, str):
            manifest = load_train_manifest(os.path.join(root_dir, manifest))
        self.entries = manifest
        self.root_dir = root_dir

        def _load(entry: SpeakerEntry) -> list[np.ndarray]:
            return [np.load(os.path.join(root_dir, p)) for p in entry.utterances]

        with ThreadPoolExecutor(max_workers=min(16, max(1, len(manifest)))) as pool:
            self.features = list(pool.map(_load, manifest))

    @property
    def num_speakers(self) -> int:
        return len(self.entries)

    def embedding(self, speaker_index: int) -> np.ndarray:
        return self.entries[speaker_index].embedding

    def sample(self, speaker_index: int, len_crop: int, rng: np.random.Generator) -> np.ndarray:
        """A random utterance of the speaker, cropped or zero-padded to
        ``len_crop`` frames."""
        utts = self.features[speaker_index]
        u = utts[int(rng.integers(0, len(utts)))]
        t = u.shape[0]
        if t < len_crop:
            out = np.zeros((len_crop,) + u.shape[1:], u.dtype)
            out[:t] = u
            return out
        if t > len_crop:
            left = int(rng.integers(0, t - len_crop))
            return u[left : left + len_crop]
        return u


class BatchIterator:
    """Infinite deterministic stream of (x (B, len_crop, F), emb (B, dim_emb))
    float32 numpy batches."""

    def __init__(self, dataset: UtteranceDataset, batch_size: int, len_crop: int, seed: int = 0):
        if batch_size > dataset.num_speakers:
            raise ValueError(f"batch_size {batch_size} > num_speakers {dataset.num_speakers} "
                             "(an epoch samples distinct speakers)")
        self.ds = dataset
        self.batch_size = batch_size
        self.len_crop = len_crop
        self.rng = np.random.default_rng(seed)
        self._epoch_order: list[int] = []

    def _next_speakers(self) -> list[int]:
        while len(self._epoch_order) < self.batch_size:
            # a new epoch of shuffled speakers; a short remainder is dropped
            self._epoch_order = list(self.rng.permutation(self.ds.num_speakers))
        out = self._epoch_order[: self.batch_size]
        self._epoch_order = self._epoch_order[self.batch_size :]
        if len(self._epoch_order) < self.batch_size:
            self._epoch_order = []
        return out

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        speakers = self._next_speakers()
        xs = [self.ds.sample(s, self.len_crop, self.rng) for s in speakers]
        embs = [self.ds.embedding(s) for s in speakers]
        return np.stack(xs).astype(np.float32), np.stack(embs).astype(np.float32)
