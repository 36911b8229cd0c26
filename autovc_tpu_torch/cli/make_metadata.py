"""Speaker embeddings and manifests (reference make_metadata.py + main.py:27-33).

    python -m autovc_tpu_torch.cli.make_metadata --main_dir DIR
        [--model_type spmel|stft|wav] [--dvector_ckpt GE2E.npz | --one_hot |
         --reuse train.pkl] [--dim_emb 256] [--seed 0]
        [--conversions src:sentence:trg,...] [--device cuda|cpu]

Writes <main_dir>/<model_type>/train.pkl, metadata.pkl and metadata.log, as
``autovc_tpu/cli/make_metadata.py`` does. The embedding source:

  --dvector_ckpt PATH  a GE2E checkpoint .npz (artifacts/ge2e.npz, or one the
                       JAX package's cli.train_speaker_encoder wrote): the mean
                       d-vector of 10 random 128-frame crops of each speaker,
                       on ``--device`` (default cuda: the LSTM kernels)
  --one_hot            legacy one-hot encoding
  --reuse PATH         the embeddings of an existing train.pkl
  (none)               <main_dir>/spmel/train.pkl's embeddings if it exists,
                       else one-hot

Embeddings always come from <main_dir>/spmel, whatever ``--model_type``.
A torch d-vector checkpoint (the reference's 3000000-BL.ckpt) does not load
here yet (ROADMAP Queue 1 #9). The speaker table is <main_dir>/speaker_info.txt
(or ./speaker_info.txt) and the transcripts <main_dir>/txt, where present.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from autovc_tpu_torch import exact_f32
from autovc_tpu_torch.data.manifest import load_train_manifest, save_conversion_metadata, save_train_manifest
from autovc_tpu_torch.data.metadata_builder import (SpeakerTable, build_conversion_metadata, build_train_manifest,
                                                    embed_speaker, one_hot_embeddings)

# default conversion list (make_metadata.py:25-34 active entry)
DEFAULT_CONVERSIONS = [(("p225", "001"), "p225")]


def parse_conversions(text: str) -> list[tuple[tuple[str, str], str]]:
    """'p225:001:p228,p227:003:p002' -> [((src, sent), trg), ...]"""
    out = []
    for item in text.split(","):
        src, sent, trg = item.strip().split(":")
        out.append(((src, sent), trg))
    return out


def fallback_conversions(feature_dir: str, speakers: list[str]):
    """Where the requested utterances do not exist: the first utterance of
    the first speaker, converted to the last speaker."""
    src = speakers[0]
    files = sorted(f for f in os.listdir(os.path.join(feature_dir, src)) if f.endswith(".npy"))
    sent = files[0][: -len(".npy")].split("_", 1)[1].removesuffix("_mic2")
    trg = speakers[-1] if len(speakers) > 1 else src
    return [((src, sent), trg)]


def dvector_apply_fn(dvector_ckpt: str, device: str | torch.device = "cuda"):
    """A GE2E ``.npz`` checkpoint -> ``apply_fn`` for ``embed_speaker``:
    a (1, 128, 80) float32 crop -> its (1, dim_emb) d-vector, computed on
    ``device``."""
    from autovc_tpu_torch.models import build_dvector
    from autovc_tpu_torch.train.ge2e import load_params

    if not dvector_ckpt.endswith(".npz"):
        raise ValueError(f"{dvector_ckpt}: only GE2E .npz checkpoints load here; the torch d-vector importer "
                         f"(the reference's 3000000-BL.ckpt) is not ported yet (ROADMAP Queue 1 #9)")
    model = build_dvector(load_params(dvector_ckpt)["dvector"], device=device)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def apply_fn(crop: np.ndarray) -> np.ndarray:
        with exact_f32(dev):
            return model(torch.from_numpy(crop).to(dev)).cpu().numpy()

    return apply_fn


def build_embeddings(main_dir: str, source: str, dvector_ckpt: str | None = None, reuse_path: str | None = None,
                     dim_emb: int = 256, seed: int = 0, device: str | torch.device = "cuda"
                     ) -> dict[str, np.ndarray]:
    mel_dir = os.path.join(main_dir, "spmel")  # always mel (make_metadata.py:53-54)
    speakers = sorted(d for d in os.listdir(mel_dir) if os.path.isdir(os.path.join(mel_dir, d)))
    if source == "one_hot":
        return one_hot_embeddings(speakers, dim_emb)
    if source == "reuse":
        return {e.speaker_id: e.embedding for e in load_train_manifest(reuse_path)}
    if source == "dvector":
        apply_fn = dvector_apply_fn(dvector_ckpt, device)
        rng = np.random.default_rng(seed)
        return {s: embed_speaker(apply_fn, mel_dir, s, rng) for s in speakers}
    raise ValueError(f"unknown embedding source {source!r}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--model_type", default="spmel", choices=["spmel", "stft", "wav"])
    ap.add_argument("--dvector_ckpt", default=None)
    ap.add_argument("--one_hot", action="store_true")
    ap.add_argument("--reuse", default=None, help="existing train.pkl to copy embeddings from")
    ap.add_argument("--dim_emb", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conversions", default=None,
                    help="comma-separated src:sentence:trg triples (default: the reference list, "
                         "with a fallback to available utterances)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.one_hot:
        source = "one_hot"
    elif args.reuse:
        source = "reuse"
    elif args.dvector_ckpt:
        source = "dvector"
    else:
        # auto: reuse the spmel dir's own train.pkl embeddings if present
        existing = os.path.join(args.main_dir, "spmel", "train.pkl")
        if os.path.exists(existing):
            source, args.reuse = "reuse", existing
        else:
            source = "one_hot"
            print("[make_metadata] no d-vector ckpt; falling back to one-hot embeddings")

    embeddings = build_embeddings(args.main_dir, source, args.dvector_ckpt, args.reuse, args.dim_emb, args.seed,
                                  args.device)

    feature_dir = os.path.join(args.main_dir, args.model_type)
    entries = build_train_manifest(feature_dir, embeddings)
    save_train_manifest(os.path.join(feature_dir, "train.pkl"), entries)

    speaker_info = None
    info_path = os.path.join(args.main_dir, "speaker_info.txt")
    if not os.path.exists(info_path):
        info_path = "speaker_info.txt"
    if os.path.exists(info_path):
        speaker_info = SpeakerTable.read(info_path)

    if args.conversions:
        conversions = parse_conversions(args.conversions)
    else:
        conversions = DEFAULT_CONVERSIONS
        ok = all(
            any(os.path.exists(os.path.join(feature_dir, s, f"{s}_{t}{suf}.npy")) for suf in ("_mic2", ""))
            for (s, t), _ in conversions
        )
        if not ok:
            speakers = sorted(e.speaker_id for e in entries)
            conversions = fallback_conversions(feature_dir, speakers)
            print(f"[make_metadata] default conversions unavailable; using {conversions}")

    txt_dir = os.path.join(args.main_dir, "txt")
    specs = build_conversion_metadata(
        feature_dir,
        embeddings,
        conversions,
        txt_dir=txt_dir if os.path.isdir(txt_dir) else None,
        speaker_info=speaker_info,
        log_path=os.path.join(feature_dir, "metadata.log"),
    )
    save_conversion_metadata(os.path.join(feature_dir, "metadata.pkl"), specs)
    print(f"[make_metadata] wrote train.pkl ({len(entries)} speakers) and metadata.pkl")


if __name__ == "__main__":
    main()
