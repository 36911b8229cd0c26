"""Train the AutoVC generator (spmel, stft or wav) on one device.

    python -m autovc_tpu_torch.cli.train --main_dir DIR --run_name NAME
        [--model_type spmel|stft|wav] [--num_iters N] [--batch_size B]
        [--len_crop T] [--lr LR] [--lambda_cd W] [--lambda_SISNR W]
        [--lr_scheduler Cosine|CosineDecay|Plateau] [--depth D]
        [--ema DECAY] [--resume] [--log_step N] [--checkpoint_step N]
        [--watch_step N] [--seed S] [--bf16 [--pallas]] [--export OUT.npz] [--device cuda|cpu]
        [--lambda_spk W --spk_ckpt GE2E.npz [--spk_protocol windowed|crop]
         [--spk_margin M]]

The flags of ``autovc_tpu/cli/train.py`` for this slice, plus ``--device``
(default ``cuda``); the generator has the published widths (--depth sets
the wav variant's ConvTasNet depth). It reads
``<main_dir>/<model_type>/train.pkl`` and the ``.npy`` features it names:
``autovc_tpu_torch.cli.make_spect`` writes the features and
``autovc_tpu_torch.cli.make_metadata`` the manifest. ``--len_crop``
defaults to 128 frames, and for wav to 33536 samples (128 latent frames).
The wav loss adds ``--lambda_SISNR`` times the SI-SNR of the waveform.
``--lambda_spk`` above 0 adds the speaker-consistency auxiliary on the
frozen GE2E encoder of ``--spk_ckpt`` (``train.step.loss_fn``; spmel only:
stft raises, as the JAX loss asserts, and the wav loss ignores it).
``--bf16`` computes in bfloat16 with float32 parameters, Adam state and
losses; its LSTMs round as the JAX CLI's ``--bf16`` does (``lax.scan``: h
and c carried in bfloat16, the CUDA kernels' scan forms), or, with
``--pallas``, as its ``--bf16 --pallas`` (a float32 carry, the kernels'
bfloat16 forms). In float32 ``--pallas`` changes no number. ``--export`` writes the final parameters
and BatchNorm statistics as the JAX CLI does: a flat ``.npz`` of
``params/...`` and ``batch_stats/...`` in the JAX layouts, plus
``__step__``, which ``autovc_tpu`` and ``build_generator(artifact=...)``
both load.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

from autovc_tpu_torch.config import AudioConfig, Config, ModelConfig, TrainConfig, wav_len_crop
from autovc_tpu_torch.data import BatchIterator, UtteranceDataset
from autovc_tpu_torch.io import save_generator_artifact


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lambda_cd", type=float, default=1.0)
    ap.add_argument("--lambda_SISNR", type=float, default=1.0, help="the wav loss's SI-SNR weight")
    ap.add_argument("--lambda_spk", type=float, default=0.0,
                    help="speaker-consistency weight (0 = the reference objective); needs --spk_ckpt")
    ap.add_argument("--spk_ckpt", default=None, help="frozen GE2E encoder .npz for --lambda_spk")
    ap.add_argument("--spk_protocol", default="windowed", choices=["windowed", "crop"],
                    help="windowed: a hinge on the evaluation's margin to the speaker centroids; crop: a "
                         "single-window cosine pull toward the target embedding")
    ap.add_argument("--spk_margin", type=float, default=1.5, help="the windowed protocol's hinge margin")
    ap.add_argument("--dim_neck", type=int, default=32)
    ap.add_argument("--dim_emb", type=int, default=256)
    ap.add_argument("--dim_pre", type=int, default=512)
    ap.add_argument("--freq", type=int, default=32)
    ap.add_argument("--depth", type=int, default=1, help="ConvTasNet depth (wav model)")
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--num_iters", type=int, default=10_000_000)
    ap.add_argument("--len_crop", type=int, default=None,
                    help="the crop: 128 frames for spmel/stft (default); 33536 samples for wav (default)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--model_type", default="spmel", choices=["spmel", "stft", "wav"])
    ap.add_argument("--run_name", required=True)
    ap.add_argument("--lr_scheduler", default=None, choices=[None, "Cosine", "CosineDecay", "Plateau"])
    ap.add_argument("--ema", type=float, default=0.9999)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--run_id", default=None)
    ap.add_argument("--log_step", type=int, default=100)
    ap.add_argument("--checkpoint_step", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_parallel", type=int, default=1)
    ap.add_argument("--model_parallel", type=int, default=1)
    ap.add_argument("--multihost", action="store_true", help="not ported (ROADMAP Queue 1 #8)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute, float32 parameters, Adam state and losses; the LSTMs round as the JAX "
                         "CLI's lax.scan (a bfloat16 carry)")
    ap.add_argument("--pallas", action="store_true",
                    help="with --bf16, the LSTMs round as the JAX CLI's Pallas kernels (a float32 carry); in float32 "
                         "the same numbers")
    ap.add_argument("--watch_step", type=int, default=0)
    ap.add_argument("--export", default=None, help="after training, write the final parameters to this .npz")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.multihost:
        raise SystemExit("--multihost: multi-process training is not ported yet (ROADMAP Queue 1 #8)")
    if args.lambda_spk > 0 and not args.spk_ckpt:
        raise SystemExit("--lambda_spk > 0 requires --spk_ckpt (a frozen GE2E encoder .npz)")
    if args.lambda_spk > 0 and args.model_type == "stft":
        raise SystemExit("--lambda_spk requires mel-domain outputs (model_type spmel), not stft")
    manifest = os.path.join(args.main_dir, args.model_type, "train.pkl")
    if not os.path.exists(manifest):
        raise SystemExit(f"{manifest} not found: make the {args.model_type} features with "
                         f"autovc_tpu_torch.cli.make_spect and train.pkl with autovc_tpu_torch.cli.make_metadata")
    if args.len_crop is None:
        args.len_crop = wav_len_crop(AudioConfig()) if args.model_type == "wav" else 128

    run_name = args.run_name if args.resume else args.run_name + datetime.now().strftime("_%y%B%d_%H%M_%S")
    cfg = Config(
        model=ModelConfig(model_type=args.model_type, dim_neck=args.dim_neck, dim_emb=args.dim_emb,
                          dim_pre=args.dim_pre, freq=args.freq, convtas_depth=args.depth,
                          compute_dtype="bfloat16" if args.bf16 else "float32", use_pallas_lstm=args.pallas),
        train=TrainConfig(lambda_cd=args.lambda_cd, lambda_sisnr=args.lambda_SISNR, lambda_spk=args.lambda_spk,
                          spk_ckpt=args.spk_ckpt, spk_protocol=args.spk_protocol, spk_margin=args.spk_margin,
                          batch_size=args.batch_size,
                          num_iters=args.num_iters, len_crop=args.len_crop, lr=args.lr,
                          lr_scheduler=args.lr_scheduler, ema_decay=args.ema, log_step=args.log_step,
                          checkpoint_step=args.checkpoint_step, watch_step=args.watch_step, seed=args.seed,
                          data_parallel=args.data_parallel, model_parallel=args.model_parallel),
        main_dir=args.main_dir,
        run_name=run_name,
        run_id=args.run_id,
    )
    ds = UtteranceDataset(os.path.dirname(manifest))
    it = BatchIterator(ds, cfg.train.batch_size, cfg.train.len_crop, seed=cfg.train.seed)

    from autovc_tpu_torch.train import Solver

    solver = Solver(cfg, it, device=args.device)
    solver.train()
    if args.export:
        save_generator_artifact(solver.state.model.state_dict(), solver.state.step, args.export)
        print(f"[train] exported params -> {args.export}")


if __name__ == "__main__":
    main()
