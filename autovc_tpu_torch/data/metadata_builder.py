"""Speaker embeddings and manifests (reference make_metadata.py).

Counterpart of ``autovc_tpu/data/metadata_builder.py``: builds train.pkl
and metadata.pkl/metadata.log from a feature tree. Speaker embeddings come
from a GE2E d-vector (``embed_speaker``, always on the spmel features,
whatever the model type), one-hot identity vectors, or an existing
train.pkl. ``embed_speaker`` draws its crops from the caller's
``np.random.Generator`` with the JAX package's calls in the JAX package's
order, so one seed picks the same crops in both.

The speaker table (``speaker_info.txt``, the VCTK layout: a header line of
column names, one whitespace-separated row a speaker) is read with the
standard library (``SpeakerTable``) in place of pandas, and its rows are
written into metadata.log as pandas' ``to_string(index=False)`` writes them
for the rectangular tables pandas reads the same way (the divergences are
listed in ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from autovc_tpu_torch.config import SpeakerEncoderConfig
from autovc_tpu_torch.data.manifest import ConversionSpec, SpeakerEntry

# pandas.read_csv's default missing-value tokens
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>",
       "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?\d+")


def _is_float(v: str) -> bool:
    try:
        float(v)
    except ValueError:
        return False
    return True


def _float_strings(values: list[float | None]) -> list[str]:
    """pandas' fixed-point floats: six decimals, trailing zeros trimmed
    together down to one decimal, NaN for a missing value."""
    out = [f"{v:.6f}" for v in values if v is not None]
    while out and all(s.endswith("0") and not s.endswith(".0") for s in out):
        out = [s[:-1] for s in out]
    it = iter(out)
    return ["NaN" if v is None else next(it) for v in values]


@dataclasses.dataclass
class SpeakerTable:
    """A whitespace-separated table with a header line, each column typed
    as pandas types it: int where every value is an integer, float where
    every present value is a number, else text; missing values are None.
    A row with more fields than the header keeps the rest in its last
    column, joined by one space."""

    columns: list[str]
    kinds: list[str]  # 'int' | 'float' | 'str'
    rows: list[list]

    @classmethod
    def read(cls, path: str) -> "SpeakerTable":
        with open(path) as fh:
            lines = [line.split() for line in fh if line.strip()]
        columns, raw = lines[0], []
        for fields in lines[1:]:
            if len(fields) > len(columns):
                fields = fields[: len(columns) - 1] + [" ".join(fields[len(columns) - 1 :])]
            raw.append([None if f in _NA else f for f in fields] + [None] * (len(columns) - len(fields)))
        kinds, rows = [], [list(r) for r in raw]
        for j in range(len(columns)):
            col = [r[j] for r in raw]
            present = [v for v in col if v is not None]
            if present and len(present) == len(col) and all(_INT.fullmatch(v) for v in present):
                kinds.append("int")
                conv = int
            elif all(_is_float(v) for v in present):
                kinds.append("float")
                conv = float
            else:
                kinds.append("str")
                conv = str
            for r in rows:
                r[j] = None if r[j] is None else conv(r[j])
        return cls(columns, kinds, rows)

    def rows_of(self, speaker: str) -> str:
        """``df[df["ID"] == speaker].to_string(index=False)`` of pandas: a
        text ID column matches the name; a numeric one matches nothing."""
        j = self.columns.index("ID")
        picked = [r for r in self.rows if self.kinds[j] == "str" and r[j] == speaker]
        if not picked:
            return f"Empty DataFrame\nColumns: [{', '.join(self.columns)}]\nIndex: []"
        cols = []
        for k, (name, kind) in enumerate(zip(self.columns, self.kinds)):
            vals = [r[k] for r in picked]
            if kind == "float":
                cells = _float_strings(vals)
            else:
                cells = ["NaN" if v is None else str(v) for v in vals]
            head = name if kind == "str" else " " + name  # pandas pads a numeric column's header
            width = max(len(head), *(len(c) for c in cells))
            cols.append([head.rjust(width)] + [c.rjust(width) for c in cells])
        return "\n".join(" ".join(col[i] for col in cols) for i in range(len(picked) + 1))


def embed_speaker(
    apply_fn,
    mel_dir: str,
    speaker: str,
    rng: np.random.Generator,
    num_uttrs: int = SpeakerEncoderConfig.num_uttrs,
    len_crop: int = SpeakerEncoderConfig.len_crop,
) -> np.ndarray:
    """Mean d-vector over ``num_uttrs`` random ``len_crop`` crops
    (make_metadata.py:66-81), resampling utterances shorter than the crop.
    ``apply_fn`` maps a (1, len_crop, n_mels) float32 array to (1, dim_emb)."""
    files = sorted(f for f in os.listdir(os.path.join(mel_dir, speaker)) if f.endswith(".npy"))
    assert len(files) >= num_uttrs, f"{speaker}: need >= {num_uttrs} utterances"
    idx = rng.choice(len(files), size=num_uttrs, replace=False)
    embs = []
    candidates = np.delete(np.arange(len(files)), idx)
    for i in idx:
        mel = np.load(os.path.join(mel_dir, speaker, files[i]))
        while mel.shape[0] < len_crop and len(candidates):
            alt = int(rng.choice(candidates))
            candidates = np.delete(candidates, np.argwhere(candidates == alt))
            mel = np.load(os.path.join(mel_dir, speaker, files[alt]))
        if mel.shape[0] < len_crop:
            # every candidate exhausted and still short: zero-pad to the crop
            # as the training dataset does
            mel = np.pad(mel, ((0, len_crop - mel.shape[0]), (0, 0)))
        left = int(rng.integers(0, mel.shape[0] - len_crop + 1))
        crop = mel[None, left : left + len_crop].astype(np.float32)
        embs.append(np.asarray(apply_fn(crop))[0])
    return np.mean(embs, axis=0).astype(np.float32)


def one_hot_embeddings(speakers: list[str], dim: int | None = None) -> dict[str, np.ndarray]:
    """Legacy one-hot speaker encoding (old code/make_metadata_old.py:68-72)."""
    dim = dim or len(speakers)
    out = {}
    for i, s in enumerate(sorted(speakers)):
        v = np.zeros(dim, np.float32)
        v[i] = 1.0
        out[s] = v
    return out


def build_train_manifest(feature_dir: str, embeddings: dict[str, np.ndarray]) -> list[SpeakerEntry]:
    """train.pkl rows: [speaker, emb, relpaths...] (make_metadata.py:58-89)."""
    entries = []
    for speaker in sorted(os.listdir(feature_dir)):
        spk_dir = os.path.join(feature_dir, speaker)
        if not os.path.isdir(spk_dir) or speaker not in embeddings:
            continue
        files = sorted(f for f in os.listdir(spk_dir) if f.endswith(".npy"))
        entries.append(SpeakerEntry(speaker_id=speaker, embedding=embeddings[speaker],
                                    utterances=[os.path.join(speaker, f) for f in files]))
    return entries


def build_conversion_metadata(
    feature_dir: str,
    embeddings: dict[str, np.ndarray],
    subject_conversions: list[tuple[tuple[str, str], str]],
    txt_dir: str | None = None,
    speaker_info: SpeakerTable | None = None,
    log_path: str | None = None,
) -> list[ConversionSpec]:
    """metadata.pkl specs and the human-readable metadata.log
    (make_metadata.py:100-133).

    subject_conversions: [((src_speaker, sentence), trg_speaker), ...]
    """
    specs = []
    log_lines = []
    for i, ((src, sent), trg) in enumerate(subject_conversions):
        # prefer the _mic2 variant, as the reference's try/except does
        for suffix in ("_mic2", ""):
            p = os.path.join(feature_dir, src, f"{src}_{sent}{suffix}.npy")
            if os.path.exists(p):
                feats = np.load(p)
                break
        else:
            raise FileNotFoundError(f"features for {src}_{sent} under {feature_dir}")

        log_lines.append(f"CONVERSION FILENAME: {i} " + "#" * 40 + "\n")
        if txt_dir:
            tp = os.path.join(txt_dir, src, f"{src}_{sent}.txt")
            if os.path.exists(tp):
                with open(tp) as fh:
                    sentence = '"' + fh.readline().rstrip("\n").rstrip() + '"'
                log_lines.append(f"Converting from sentence no. {sent} : {sentence}")
        if speaker_info is not None:
            for label, spk in (("Uttered by the speaker:", src), ("To the speaker:", trg)):
                log_lines.append(label)
                log_lines.append(speaker_info.rows_of(spk))
        log_lines.append("")

        specs.append(ConversionSpec(conversion_id=i, src_name=f"{src}_{sent}", src_embedding=embeddings[src],
                                    src_features=feats, trg_speaker=trg, trg_embedding=embeddings[trg],
                                    src_speaker=src))
    if log_path:
        with open(log_path, "w") as fh:
            fh.write("\n".join(log_lines))
    return specs
