"""In-RAM utterance dataset and batch iterator.

Counterpart of ``autovc_tpu/data/dataset.py``, with the reference's sampling
semantics and the same ``np.random.default_rng(seed)`` stream, so one seed
gives the JAX iterator's batches:

- the dataset's length is its number of speakers;
- an epoch is a shuffled pass over the speakers, batched with drop_last;
- each sample draws a random utterance of its speaker and a random
  ``len_crop``-frame crop, zero-padded on the right when short.

Features load into RAM with the native loader when it is built
(``autovc_tpu_torch.runtime``: a threaded C++ ``.npy`` reader, each
utterance a read-only view of its buffer) or with a thread pool of
``np.load``, as ``use_native`` says (None: the native loader when it
builds). ``BatchIterator(host_index, host_count)`` shards each global batch
over hosts (the ranks of a data-parallel run): every host draws the whole
batch's samples from the same seeded stream and keeps its rows
[h * B / H, (h + 1) * B / H), so the hosts' rows, joined, are the
single-host batch.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from autovc_tpu_torch.data.manifest import SpeakerEntry, load_train_manifest


class UtteranceDataset:
    def __init__(self, root_dir: str, manifest: str | list[SpeakerEntry] = "train.pkl",
                 use_native: bool | None = None):
        if isinstance(manifest, str):
            manifest = load_train_manifest(os.path.join(root_dir, manifest))
        self.entries = manifest
        self.root_dir = root_dir
        if use_native is None:
            from autovc_tpu_torch.runtime import native_available

            use_native = native_available()
        if use_native:
            from autovc_tpu_torch.runtime import FeatureStore

            self._store = FeatureStore()
            ids = self._store.load_npy_batch([os.path.join(root_dir, p) for e in manifest for p in e.utterances])
            if (ids < 0).any():
                raise OSError(f"the native loader could not read {int((ids < 0).sum())} feature file(s) under "
                              f"{root_dir}")
            views = iter(self._store.view(int(i)) for i in ids)
            self.features = [[next(views) for _ in e.utterances] for e in manifest]
            return

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
    float32 numpy batches; with ``host_count`` > 1 this host's B / host_count
    rows of each."""

    def __init__(self, dataset: UtteranceDataset, batch_size: int, len_crop: int, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        if batch_size % host_count:
            raise ValueError(f"batch_size {batch_size} does not split over {host_count} hosts")
        if batch_size > dataset.num_speakers:
            raise ValueError(f"batch_size {batch_size} > num_speakers {dataset.num_speakers} "
                             "(an epoch samples distinct speakers)")
        self.ds = dataset
        self.batch_size = batch_size
        self.len_crop = len_crop
        self.rng = np.random.default_rng(seed)
        self.host_index = host_index
        self.host_count = host_count
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
        xs = [self.ds.sample(s, self.len_crop, self.rng) for s in speakers]  # all drawn: the stream's order
        rows = slice(self.host_index * (self.batch_size // self.host_count),
                     (self.host_index + 1) * (self.batch_size // self.host_count))
        embs = [self.ds.embedding(s) for s in speakers[rows]]
        return np.stack(xs[rows]).astype(np.float32), np.stack(embs).astype(np.float32)
