"""Conversion CLI (reference conversion.py): a trained generator and
metadata.pkl -> every conversion -> results_<step>.pkl ([(id, mel)], the
vocoder's input) and, with --pdf, before/after spectrogram PDFs.

    python -m autovc_tpu_torch.cli.convert --main_dir DIR
        (--run_dir RUNDIR | --artifact FILE.npz)
        [--model_type spmel|stft|wav] [--use_ema] [--all_pairs] [--raw]
        [--out R.pkl] [--depth D] [--pdf] [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/convert.py``, with its flags. --run_dir
reads the newest ``checkpoints/step_*.pt`` that the port's ``train.Solver``
wrote (``load_solver_checkpoint``); --artifact an exported ``.npz`` (what
``cli.train --export`` or the JAX package's export writes). The specs come
from ``<main_dir>/<model_type>/metadata.pkl``, or, with --all_pairs, the
N x N matrix of ``train.pkl``'s speakers (batched 8 a call for spmel and
stft). stft outputs are projected onto the mel bands, unless --raw keeps
the model's own domain; wav outputs are waveforms whose mel is re-extracted
on --device (``convert.WavConverter``). --pallas sets
``ModelConfig.use_pallas_lstm`` as the JAX CLI does; conversion here runs in
float32, where both LSTM roundings are the same float32 kernels, so it
changes no number. --seq_devices above 1 raises (ROADMAP Queue 1 #8). --pdf needs matplotlib.

Everything runs on --device (default cuda, in exact float32 there; cpu runs
the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import AudioConfig, ModelConfig
from autovc_tpu_torch.convert import Converter, WavConverter, all_pairs_specs, run_conversions
from autovc_tpu_torch.data.manifest import load_conversion_metadata, load_train_manifest, save_results
from autovc_tpu_torch.io import load_artifact
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.train.solver import checkpoint_file, saved_steps


def load_solver_checkpoint(run_dir: str) -> tuple[dict, int]:
    """The newest checkpoint the port's ``train.Solver`` saved under
    ``<run_dir>/checkpoints``: ``({'params', 'ema_params', 'batch_stats',
    ...}, step)``, tensors on the CPU under the model's state-dict names.
    An orbax directory (the JAX package's Solver) raises and says so."""
    ckpt_dir = os.path.abspath(os.path.join(run_dir, "checkpoints"))
    steps = saved_steps(ckpt_dir) if os.path.isdir(ckpt_dir) else []
    if not steps:
        if os.path.isdir(ckpt_dir) and any(n.isdigit() for n in os.listdir(ckpt_dir)):
            raise ValueError(f"{ckpt_dir} holds orbax checkpoints of the JAX package's Solver, which the port "
                             f"does not read: export one with autovc_tpu.cli.export_ckpt and pass --artifact")
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    tree = torch.load(checkpoint_file(ckpt_dir, steps[-1]), map_location="cpu", weights_only=True)
    return tree, int(tree["step"])


def load_weights(args: argparse.Namespace) -> tuple[dict | None, int]:
    """(state dict, step) from --artifact or --run_dir (--use_ema choosing
    the run's EMA parameters)."""
    if args.artifact:
        if args.use_ema:
            print("[convert] note: artifacts carry one weight set; --use_ema ignored")
        return None, load_artifact(args.artifact)[1]
    tree, step = load_solver_checkpoint(args.run_dir)
    return {**tree["ema_params" if args.use_ema else "params"], **tree["batch_stats"]}, step


def build_converter(args: argparse.Namespace, device: torch.device) -> tuple[Converter | WavConverter, int]:
    """The variant's converter on the generator that --artifact or --run_dir
    holds, and its step."""
    cfg = ModelConfig(model_type=args.model_type, convtas_depth=args.depth, use_pallas_lstm=args.pallas)
    state, step = load_weights(args)
    gen = build_generator(cfg, artifact=args.artifact, device=device)
    if state is not None:
        gen.load_state_dict(state)
    if args.model_type == "wav":
        return WavConverter(gen, cfg, AudioConfig()), step
    return Converter(gen, cfg, AudioConfig()), step


def save_pdfs(args: argparse.Namespace, converter, results, specs, out_path: str) -> None:
    """One <id>_conversion.pdf per result beside ``out_path``: the source's
    mel over the converted one."""
    try:
        import matplotlib
    except ImportError as exc:
        raise SystemExit("--pdf needs matplotlib, which this Python does not have") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for (name, mel), spec in zip(results, specs):
        if args.model_type == "wav":  # the source is a waveform: its mel (conversion_nina.py:123-146)
            src = converter.frontend.mel_features(np.asarray(spec.src_features)[..., 0]).cpu().numpy()
        else:
            src = converter.project_mel(spec.src_features)
        fig, axs = plt.subplots(2, 1, sharex=True, figsize=(8, 6))
        axs[0].imshow(src.T * 100 - 100, origin="lower", aspect="auto")
        axs[0].set(title="Original spectrogram")
        axs[1].imshow(np.asarray(mel).T * 100 - 100, origin="lower", aspect="auto")
        axs[1].set(title="Converted spectrogram")
        fig.savefig(os.path.join(os.path.dirname(out_path), f"{name}_conversion.pdf"))
        plt.close(fig)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run_dir", default=None, help="a training run directory of the port's Solver")
    src.add_argument("--artifact", default=None, help="an exported generator .npz")
    ap.add_argument("--model_type", default="spmel", choices=["spmel", "stft", "wav"])
    ap.add_argument("--pallas", action="store_true",
                    help="ModelConfig.use_pallas_lstm, as the JAX CLI; the same numbers in float32")
    ap.add_argument("--use_ema", action="store_true", help="convert with the run's EMA weights")
    ap.add_argument("--pdf", action="store_true", help="save spectrogram PDFs (needs matplotlib)")
    ap.add_argument("--out", default=None, help="results pickle path")
    ap.add_argument("--depth", type=int, default=1, help="ConvTasNet depth (wav model)")
    ap.add_argument("--all_pairs", action="store_true",
                    help="the N x N conversion matrix over all speakers (conversion_temp.py mode)")
    ap.add_argument("--raw", action="store_true",
                    help="save the model-domain outputs (513-bin STFT for stft, the waveform for wav) instead "
                         "of mels")
    ap.add_argument("--seq_devices", type=int, default=0, help="not ported (ROADMAP Queue 1 #8)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv: list[str] | None = None) -> list[tuple[str, np.ndarray]]:
    args = build_parser().parse_args(argv)
    if args.seq_devices > 1:
        raise SystemExit("--seq_devices: sequence-parallel conversion is not ported yet (ROADMAP Queue 1 #8)")
    device = resolve_device(args.device)
    feature_dir = os.path.join(args.main_dir, args.model_type)
    with exact_f32(device):
        converter, step = build_converter(args, device)
        if args.all_pairs:
            specs = all_pairs_specs(load_train_manifest(os.path.join(feature_dir, "train.pkl")), feature_dir)
        else:
            specs = load_conversion_metadata(os.path.join(feature_dir, "metadata.pkl"))
        out_path = args.out or os.path.join(feature_dir, f"results_step{step}.pkl")
        if args.raw:
            results = [(str(s.conversion_id), converter.convert(s)) for s in specs]
            save_results(out_path, results)
        elif args.all_pairs and args.model_type != "wav":
            outs = converter.convert_batch(specs, batch_size=8)
            results = [(str(s.conversion_id), o) for s, o in zip(specs, outs)]
            save_results(out_path, results)
        else:
            results = run_conversions(converter, specs, out_path)
        if args.pdf:
            save_pdfs(args, converter, results, specs, out_path)
    print(f"[convert] wrote {out_path} ({len(results)} conversions, step {step})")
    return results


if __name__ == "__main__":
    main()
