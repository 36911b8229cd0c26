"""Speaker-encoder quality gate: verification EER and embedding separation.

    python -m autovc_tpu_torch.cli.evaluate_speaker_encoder --main_dir DIR
        --dvector_ckpt GE2E.npz [--holdout N] [--dim_cell H] [--dim_emb E]
        [--out report.json] [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/evaluate_speaker_encoder.py``: every
utterance of <main_dir>/spmel/train.pkl is embedded with the frozen encoder
(deterministic sliding windows, ``eval.SpeakerEmbedder``, on ``--device``,
default cuda), all utterance pairs are scored by cosine, and the equal error
rate and the intra/inter-speaker cosine separation are printed as one JSON
line with the JAX CLI's keys. With ``--holdout N`` only the last N
utterances of each speaker count, and a speaker with N or fewer is skipped.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--dvector_ckpt", required=True)
    ap.add_argument("--holdout", type=int, default=0,
                    help="use only the last N utterances per speaker (held-out set); 0 = all utterances")
    ap.add_argument("--dim_cell", type=int, default=None, help="override; inferred from the checkpoint by default")
    ap.add_argument("--dim_emb", type=int, default=None, help="override; inferred from the checkpoint by default")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def evaluate(embedder, ds, holdout: int = 0) -> tuple[dict, np.ndarray]:
    """(report, embeddings (N, dim_emb)) of the utterances of ``ds``
    (a ``data.UtteranceDataset``), embedded by ``embedder``."""
    from autovc_tpu_torch.eval import embedding_separation, verification_eer

    embeds, labels = [], []
    for sid, (entry, utts) in enumerate(zip(ds.entries, ds.features)):
        if holdout and len(utts) <= holdout:
            # such a speaker was trained on every utterance: scoring them as
            # held out would mix training trials into the EER
            print(f"[evaluate_speaker_encoder] skipping {entry.speaker_id}: {len(utts)} utterances <= holdout "
                  f"{holdout} (all were seen in training)")
            continue
        for mel in utts[-holdout:] if holdout else utts:
            embeds.append(embedder.embed(np.asarray(mel)))
            labels.append(sid)
    embeds = np.stack(embeds)
    labels = np.asarray(labels)
    n_speakers = len(set(labels.tolist()))
    print(f"[evaluate_speaker_encoder] {len(embeds)} utterances, {n_speakers} speakers"
          + (f" (held-out last {holdout}/speaker)" if holdout else ""))

    eer, thresh = verification_eer(embeds, labels)
    rep = {
        "eer": eer,
        "threshold": thresh,
        "utterances": len(embeds),
        "speakers": n_speakers,
        "holdout": holdout,
        **embedding_separation(embeds, labels),
    }
    return rep, embeds


def run(argv: list[str] | None = None) -> tuple[dict, np.ndarray]:
    """The CLI's work: (the report it prints and writes to ``--out``, the
    embeddings (N, dim_emb) it scored)."""
    args = build_parser().parse_args(argv)

    from autovc_tpu_torch.data import UtteranceDataset
    from autovc_tpu_torch.eval import SpeakerEmbedder
    from autovc_tpu_torch.train.ge2e import load_params

    ds = UtteranceDataset(os.path.join(args.main_dir, "spmel"))
    embedder = SpeakerEmbedder(load_params(args.dvector_ckpt), dim_cell=args.dim_cell, dim_emb=args.dim_emb,
                               device=args.device)
    rep, embeds = evaluate(embedder, ds, args.holdout)
    print(json.dumps(rep))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep, embeds


def main(argv: list[str] | None = None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
