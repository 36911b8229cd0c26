"""Import a reference-trained torch checkpoint as a run of the port's Solver.

    python -m autovc_tpu_torch.cli.import_torch --ckpt chkpnt_spmel_run.ckpt
        --out_run_dir runs/imported [--model_type spmel|stft|wav]

Counterpart of ``autovc_tpu/cli/import_torch.py``. It reads the reference's
``.ckpt`` (solver_encoder.py:334-346: ``{'epoch', 'state_dict', 'optimizer',
'loss'}``, or the upstream autovc.ckpt ``{'model'}``), maps the generator's
state dict onto the JAX parameter tree (``interop``), and writes the port's
Solver checkpoint ``<out_run_dir>/checkpoints/step_<epoch>.pt``:
``{params, batch_stats, opt_state, ema_params, step}`` with fresh Adam
moments (a torch optimizer's moments of the reference's parameter layout
do not carry over; the JAX CLI writes freshly initialised ones too), the EMA
equal to the parameters. ``cli.convert --run_dir`` and ``cli.train
--resume`` (its run directory as ``<main_dir>/runs/<run_name>``) read it.
The generator has the published widths (the wav variant's ConvTasNet depth
is read from the checkpoint).
"""

from __future__ import annotations

import argparse
import os

import torch

from autovc_tpu_torch.config import Config, ModelConfig
from autovc_tpu_torch.interop import generator_params_from_torch, generator_wav_params_from_torch
from autovc_tpu_torch.io import generator_state_from_jax
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.train.solver import checkpoint_file
from autovc_tpu_torch.train.step import make_optimizer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="torch .ckpt of the reference")
    ap.add_argument("--out_run_dir", required=True)
    ap.add_argument("--model_type", default="spmel", choices=["spmel", "stft", "wav"])
    return ap


def main(argv: list[str] | None = None) -> str:
    args = build_parser().parse_args(argv)
    # the reference's own checkpoint (its optimizer state and loss pickled)
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    step = int(ckpt.get("epoch", 0))
    if args.model_type == "wav":
        params, stats = generator_wav_params_from_torch(sd)
        cfg = ModelConfig(model_type="wav", convtas_depth=sum(k.startswith("conv") and k[4:].isdigit()
                                                               for k in params["tas_encoder"]))
    else:
        params, stats = generator_params_from_torch(sd)
        cfg = ModelConfig(model_type=args.model_type)
    model = build_generator(cfg, device="cpu", trainable=True)
    names = {n for n, _ in model.named_parameters()}
    state = generator_state_from_jax({"params": params, "batch_stats": stats})
    model.load_state_dict(state)
    tree = {
        "params": {k: v for k, v in state.items() if k in names},
        "batch_stats": {k: v for k, v in state.items() if k not in names},
        "opt_state": make_optimizer(model, Config(model=cfg)).state_dict(),
        "ema_params": {k: v.clone() for k, v in state.items() if k in names},
        "step": step,
    }
    ckpt_dir = os.path.abspath(os.path.join(args.out_run_dir, "checkpoints"))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_file(ckpt_dir, step)
    torch.save(tree, path)
    n = sum(v.numel() for v in tree["params"].values())
    print(f"[import_torch] step {step}, {n / 1e6:.1f}M params -> {path}")
    return path


if __name__ == "__main__":
    main()
