"""The training manifest, byte-compatible with the reference and the JAX
package (``autovc_tpu/data/manifest.py``).

train.pkl: a pickled list where each row is
    [speaker_id: str, embedding: np.ndarray (256,), relpath1: str, ...]

It is read and written as this exact structure, with a typed wrapper for
use inside the package. Unpickle only files this program or the JAX
package wrote. (The conversion metadata and results files come with the
rest of conversion, ROADMAP Queue 1 #5.)
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
