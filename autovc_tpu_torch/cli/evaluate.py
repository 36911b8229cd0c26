"""Evaluation CLI: reconstruction metrics of a trained generator on a corpus.

    python -m autovc_tpu_torch.cli.evaluate --main_dir DIR --run_dir RUNDIR
        [--model_type spmel|stft] [--use_ema] [--max_utts N] [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/evaluate.py``: every utterance of
``<main_dir>/<model_type>/train.pkl`` (or the first --max_utts) is
reconstructed in eval mode (source embedding = target embedding) through
``Converter.convert_batch(to_mel=False)``, 8 a call, 64 utterances loaded
at a time, and the mean and median MSE and L1 against the source features
are printed as one JSON line. --run_dir is a run of the port's Solver
(``cli.convert.load_solver_checkpoint``); --pallas sets
``ModelConfig.use_pallas_lstm`` as the JAX CLI does, which changes no number
in float32, where this runs. Runs on --device (default cuda, in exact float32 there).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.cli.convert import load_solver_checkpoint
from autovc_tpu_torch.config import AudioConfig, ModelConfig
from autovc_tpu_torch.convert import Converter
from autovc_tpu_torch.data.manifest import ConversionSpec, load_train_manifest
from autovc_tpu_torch.models import build_generator

CHUNK = 64  # utterances loaded at a time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--model_type", default="spmel", choices=["spmel", "stft"])
    ap.add_argument("--pallas", action="store_true",
                    help="ModelConfig.use_pallas_lstm, as the JAX CLI; the same numbers in float32")
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--max_utts", type=int, default=0, help="0 = all")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    tree, step = load_solver_checkpoint(args.run_dir)
    cfg = ModelConfig(model_type=args.model_type, use_pallas_lstm=args.pallas)
    gen = build_generator(cfg, device=device)
    gen.load_state_dict({**tree["ema_params" if args.use_ema else "params"], **tree["batch_stats"]})
    conv = Converter(gen, cfg, AudioConfig())

    feature_dir = os.path.join(args.main_dir, args.model_type)
    paths = [(rel, e) for e in load_train_manifest(os.path.join(feature_dir, "train.pkl")) for rel in e.utterances]
    if args.max_utts:
        paths = paths[: args.max_utts]

    mses, l1s = [], []
    with exact_f32(device):
        for off in range(0, len(paths), CHUNK):
            specs = [ConversionSpec(off + k, rel, e.embedding, np.load(os.path.join(feature_dir, rel)), e.speaker_id,
                                    e.embedding, src_speaker=e.speaker_id)
                     for k, (rel, e) in enumerate(paths[off : off + CHUNK])]
            for s, out in zip(specs, conv.convert_batch(specs, batch_size=8, to_mel=False)):
                mses.append(float(np.mean((out - s.src_features) ** 2)))
                l1s.append(float(np.mean(np.abs(out - s.src_features))))

    report = {
        "step": int(step),
        "utterances": len(paths),
        "recon_mse_mean": float(np.mean(mses)),
        "recon_mse_median": float(np.median(mses)),
        "recon_l1_mean": float(np.mean(l1s)),
        "recon_l1_median": float(np.median(l1s)),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
