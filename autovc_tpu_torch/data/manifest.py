"""The manifests, byte-compatible with the reference and the JAX package
(``autovc_tpu/data/manifest.py``).

train.pkl (make_metadata.py:84-89): a pickled list where each row is
    [speaker_id: str, embedding: np.ndarray (256,), relpath1: str, ...]

metadata.pkl (make_metadata.py:125-128): a pickled list where each row is
    [conversion_id: int,
     [src_name: str, src_emb (256,), src_features (T, F)],
     [trg_speaker: str, trg_emb (256,)]]

results_<id>.pkl (conversion.py:117-121): a pickled list of
    (name: str, mel: np.ndarray (T, F))

They are read and written as these exact structures, with typed wrappers
for use inside the package. Unpickle only files this program or the JAX
package wrote.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np


@dataclass
class SpeakerEntry:
    speaker_id: str
    embedding: np.ndarray  # (dim_emb,)
    utterances: list[str]  # feature paths relative to the feature directory


@dataclass
class ConversionSpec:
    conversion_id: int
    src_name: str  # e.g. 'p225_001'
    src_embedding: np.ndarray
    src_features: np.ndarray  # (T, F)
    trg_speaker: str
    trg_embedding: np.ndarray
    # the source speaker where the metadata builder knows it (not stored in the
    # pickle); consumers parse src_name only when this is None
    src_speaker: str | None = None


def load_train_manifest(path: str) -> list[SpeakerEntry]:
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return [SpeakerEntry(row[0], np.asarray(row[1], dtype=np.float32), [str(p) for p in row[2:]])
            for row in raw]


def save_train_manifest(path: str, entries: list[SpeakerEntry]) -> None:
    raw = [[e.speaker_id, np.asarray(e.embedding, np.float32), *e.utterances] for e in entries]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(raw, f)


def load_conversion_metadata(path: str) -> list[ConversionSpec]:
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return [ConversionSpec(conversion_id=int(row[0]), src_name=str(row[1][0]),
                           src_embedding=np.asarray(row[1][1], np.float32),
                           src_features=np.asarray(row[1][2], np.float32), trg_speaker=str(row[2][0]),
                           trg_embedding=np.asarray(row[2][1], np.float32))
            for row in raw]


def save_conversion_metadata(path: str, specs: list[ConversionSpec]) -> None:
    raw = [
        [
            s.conversion_id,
            [s.src_name, np.asarray(s.src_embedding, np.float32), np.asarray(s.src_features, np.float32)],
            [s.trg_speaker, np.asarray(s.trg_embedding, np.float32)],
        ]
        for s in specs
    ]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(raw, f)


def save_results(path: str, results: list[tuple[str, np.ndarray]]) -> None:
    """results_<id>.pkl contract (conversion.py:117-121): list of (name, mel)."""
    with open(path, "wb") as f:
        pickle.dump(results, f)


def load_results(path: str) -> list[tuple[str, np.ndarray]]:
    with open(path, "rb") as f:
        return pickle.load(f)
