"""Train the GE2E d-vector speaker encoder on a corpus's spmel features.

    python -m autovc_tpu_torch.cli.train_speaker_encoder --main_dir DIR
        [--num_iters N] [--n_speakers 0] [--m_utts 5] [--len_crop 128]
        [--dim_cell 768] [--dim_emb 256] [--lr LR] [--log_step N]
        [--out ge2e.npz] [--seed S] [--holdout N] [--ce_weight W]
        [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/train_speaker_encoder.py``, with its flags
and ``--device`` (default cuda, where the d-vector's LSTMs train on the
kernels with dW; cpu runs the plain versions). The speakers are
``<main_dir>/spmel/train.pkl``'s, or, without one, every
``<main_dir>/spmel/<speaker>/*.npy`` (an ad-hoc manifest). ``--n_speakers
0`` puts every speaker in each batch; ``--holdout N`` keeps each speaker's
last N utterances out of training (for ``cli.evaluate_speaker_encoder``);
``--ce_weight`` above 0 adds the speaker-ID cross-entropy head, which is
not saved. The checkpoint (default ``<main_dir>/ge2e.npz``) is what
``cli.make_metadata --dvector_ckpt`` reads in both packages.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.data import SpeakerEntry, UtteranceDataset


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--num_iters", type=int, default=50_000)
    ap.add_argument("--n_speakers", type=int, default=0, help="speakers a batch; 0 = every corpus speaker")
    ap.add_argument("--m_utts", type=int, default=5, help="utterances a speaker")
    ap.add_argument("--len_crop", type=int, default=128)
    ap.add_argument("--dim_cell", type=int, default=768)
    ap.add_argument("--dim_emb", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--log_step", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--holdout", type=int, default=0,
                    help="keep the last N utterances of every speaker out of training")
    ap.add_argument("--ce_weight", type=float, default=0.0,
                    help="weight of a speaker-ID cross-entropy head on the embedding (not saved); 0 = pure GE2E")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def speaker_dataset(mel_dir: str) -> UtteranceDataset:
    """``train.pkl``'s speakers, or every speaker directory's ``.npy`` files
    in sorted order."""
    if os.path.exists(os.path.join(mel_dir, "train.pkl")):
        return UtteranceDataset(mel_dir)
    entries = []
    for spk in sorted(os.listdir(mel_dir)):
        d = os.path.join(mel_dir, spk)
        if os.path.isdir(d):
            utts = [os.path.join(spk, f) for f in sorted(os.listdir(d)) if f.endswith(".npy")]
            entries.append(SpeakerEntry(spk, np.zeros(1, np.float32), utts))
    return UtteranceDataset(mel_dir, manifest=entries)


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from autovc_tpu_torch.train.ge2e import GE2ETrainer, sample_ge2e_batch

    ds = speaker_dataset(os.path.join(args.main_dir, "spmel"))
    features = ds.features
    if args.holdout:
        features = [u[: -args.holdout] if len(u) > args.holdout else u for u in features]
        print(f"[train_speaker_encoder] holding out last {args.holdout} utts/speaker")
    n = min(args.n_speakers or ds.num_speakers, ds.num_speakers)
    rng = np.random.default_rng(args.seed)
    use_ce = args.ce_weight > 0
    trainer = GE2ETrainer(dim_cell=args.dim_cell, dim_emb=args.dim_emb, lr=args.lr, seed=args.seed,
                          n_classes=len(features) if use_ce else 0, ce_weight=args.ce_weight, device=device)

    def batches():
        while True:
            yield sample_ge2e_batch(features, n, args.m_utts, args.len_crop, rng, return_labels=use_ce)

    with exact_f32(device):
        trainer.train(batches(), args.num_iters, log_step=args.log_step)
    out = args.out or os.path.join(args.main_dir, "ge2e.npz")
    trainer.save(out)
    print(f"[train_speaker_encoder] saved {out}")
    return trainer


if __name__ == "__main__":
    main()
