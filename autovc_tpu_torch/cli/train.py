"""Train the AutoVC generator (spmel, stft or wav) on one device, or on the
ranks of a multi-process run.

    python -m autovc_tpu_torch.cli.train --main_dir DIR --run_name NAME
        [--model_type spmel|stft|wav] [--num_iters N] [--batch_size B]
        [--len_crop T] [--lr LR] [--lambda_cd W] [--lambda_SISNR W]
        [--lr_scheduler Cosine|CosineDecay|Plateau] [--depth D]
        [--ema DECAY] [--resume] [--log_step N] [--checkpoint_step N]
        [--watch_step N] [--seed S] [--bf16 [--pallas]] [--export OUT.npz] [--device cuda|cpu]
        [--lambda_spk W --spk_ckpt GE2E.npz [--spk_protocol windowed|crop]
         [--spk_margin M]] [--multihost [--data_parallel N] [--model_parallel M]]

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

``--multihost`` runs this process as one rank of a world: the process group
comes from ``AUTOVC_COORDINATOR`` (host:port of rank 0's TCP store),
``AUTOVC_NUM_PROCESSES`` and ``AUTOVC_PROCESS_ID``, as the JAX CLI's
``jax.distributed`` setup; start one process a rank with the same
arguments. Under NCCL (the card's default) each rank takes its own card;
ranks that share a card run with ``AUTOVC_DIST_BACKEND=gloo``, and on the
CPU gloo is the default. ``--data_parallel`` defaults to the world's size
over ``--model_parallel`` (printed as ``data_parallel -> N``); each rank
reads its rows of every global batch (``BatchIterator(host_index,
host_count)`` over the 'data' ranks); ``--export`` gathers the
tensor-parallel slices and rank 0 writes; every rank meets at an exit
barrier before it leaves the process group. ``--resume`` (a run name
without a timestamp) lets the ranks find the same run directory.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch
import torch.distributed as dist

from autovc_tpu_torch.config import AudioConfig, Config, ModelConfig, TrainConfig, wav_len_crop
from autovc_tpu_torch.data import BatchIterator, UtteranceDataset
from autovc_tpu_torch.io import save_generator_artifact
from autovc_tpu_torch.parallel.mesh import init_process_group


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
    ap.add_argument("--multihost", action="store_true",
                    help="one rank of a multi-process run (AUTOVC_COORDINATOR, AUTOVC_NUM_PROCESSES, "
                         "AUTOVC_PROCESS_ID); each rank feeds its rows of the global batch")
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
    if args.lambda_spk > 0 and not args.spk_ckpt:
        raise SystemExit("--lambda_spk > 0 requires --spk_ckpt (a frozen GE2E encoder .npz)")
    if args.lambda_spk > 0 and args.model_type == "stft":
        raise SystemExit("--lambda_spk requires mel-domain outputs (model_type spmel), not stft")
    device = join_world(args) if args.multihost else args.device
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
    rank = dist.get_rank() if args.multihost else 0
    # this rank's rows: the 'data' coordinate of rank = data * model_parallel + model
    it = BatchIterator(ds, cfg.train.batch_size, cfg.train.len_crop, seed=cfg.train.seed,
                       host_index=rank // args.model_parallel, host_count=args.data_parallel)

    from autovc_tpu_torch.train import Solver

    solver = Solver(cfg, it, device=device)
    solver.train()
    if args.export:
        state = solver.model_state()  # every rank: the tensor-parallel slices are gathered
        if rank == 0:
            save_generator_artifact(state, solver.state.step, args.export)
            print(f"[train] exported params -> {args.export}")
    if args.multihost:
        # every rank leaves together, its checkpoint work done (train ends
        # in finish_saves): no rank's exit aborts a peer's collective
        dist.barrier()
        dist.destroy_process_group()


def join_world(args: argparse.Namespace) -> torch.device:
    """Start this process's rank from AUTOVC_COORDINATOR,
    AUTOVC_NUM_PROCESSES and AUTOVC_PROCESS_ID; default ``data_parallel`` to
    the ranks that model parallelism leaves (the mesh must span every rank).
    Returns the rank's device."""
    try:
        coord = os.environ["AUTOVC_COORDINATOR"]
        world, rank = int(os.environ["AUTOVC_NUM_PROCESSES"]), int(os.environ["AUTOVC_PROCESS_ID"])
    except KeyError as exc:
        raise SystemExit(f"--multihost needs AUTOVC_COORDINATOR (host:port), AUTOVC_NUM_PROCESSES and "
                         f"AUTOVC_PROCESS_ID in the environment; {exc.args[0]} is not set") from exc
    device = init_process_group(f"tcp://{coord}", world, rank, args.device)
    if args.data_parallel == 1:
        args.data_parallel = world // args.model_parallel
        print(f"[train] multihost: data_parallel -> {args.data_parallel} ({world} processes, model_parallel "
              f"{args.model_parallel})", flush=True)
    return device


if __name__ == "__main__":
    main()
