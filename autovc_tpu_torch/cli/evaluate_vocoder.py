"""Vocoder fidelity: the mel L1 between the mel re-extracted from a
vocoder's waveform and the mel it was given.

    python -m autovc_tpu_torch.cli.evaluate_vocoder (--spmel_dir DIR | --results R.pkl)
        [--vocoder griffinlim|hifigan|hybrid|wavenet] [--vocoder_ckpt V.npz]
        [--gl_iters 60] [--hybrid_iters 2] [--max_utts N]
        [--wavenet_engine scan|pallas] [--wavenet_bucket 64] [--out LOG]
        [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/evaluate_vocoder.py``, with its flags and
``--device`` (default cuda, in exact float32 there; cpu runs the plain
versions). Each mel (a corpus tree's ``<speaker>/<utt>.npy``, or a
``cli.convert`` results pickle's) is vocoded one at a time, its waveform's
mel re-extracted by ``dsp.MelFrontend`` (no dither; on a card the
``sosfilt`` and ``mel_norm`` kernels), and scored by
``eval.fidelity.mel_fidelity_report``; the means and medians are printed as
one JSON line, which ``--out`` also appends to a file. ``hybrid`` is
HiFi-GAN refined by ``--hybrid_iters`` Griffin-Lim iterations on the mel's
magnitude (``vocoder.hybrid``); ``wavenet`` runs the generation kernel on
mels padded to a multiple of ``--wavenet_bucket`` frames, in bfloat16 with
``--wavenet_engine pallas``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import AudioConfig, HiFiGANConfig, WaveNetConfig


def _load_mels(args) -> list[tuple[str, np.ndarray]]:
    if args.results:
        from autovc_tpu_torch.data import load_results

        return [(name, np.asarray(mel)) for name, mel in load_results(args.results)]
    mels = []
    for spk in sorted(os.listdir(args.spmel_dir)):
        d = os.path.join(args.spmel_dir, spk)
        if os.path.isdir(d):
            mels += [(f"{spk}/{f[:-4]}", np.load(os.path.join(d, f))) for f in sorted(os.listdir(d))
                     if f.endswith(".npy")]
    return mels


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results", default=None, help="results_*.pkl from convert")
    ap.add_argument("--spmel_dir", default=None, help="corpus feature dir")
    ap.add_argument("--vocoder", default="griffinlim", choices=["griffinlim", "wavenet", "hifigan", "hybrid"])
    ap.add_argument("--vocoder_ckpt", default=None)
    ap.add_argument("--gl_iters", type=int, default=60)
    ap.add_argument("--hybrid_iters", type=int, default=2, help="GL refinement iterations for --vocoder hybrid")
    ap.add_argument("--max_utts", type=int, default=0, help="0 = all")
    ap.add_argument("--wavenet_engine", default="scan", choices=["scan", "pallas"],
                    help="the JAX CLI's engine names: scan runs float32, pallas the generation kernel's "
                         "bfloat16 form in the Pallas engine's rounding, as the JAX CLI does")
    ap.add_argument("--wavenet_bucket", type=int, default=64,
                    help="pad each mel (edge replication) to a multiple of this many frames before WaveNet "
                         "generation and trim the waveform back (0 = off)")
    ap.add_argument("--out", default=None, help="also append the JSON line here")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def make_vocoder(args, audio: AudioConfig, device: torch.device):
    """The chosen vocoder as a function of one (T, 80) mel to a waveform."""
    if args.vocoder == "griffinlim":
        from autovc_tpu_torch.vocoder.griffinlim import mel_to_waveform

        return lambda m: mel_to_waveform(torch.as_tensor(m, device=device), audio, n_iter=args.gl_iters)
    if args.vocoder in ("hifigan", "hybrid"):
        from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder

        voc = HiFiGANVocoder.from_checkpoint(HiFiGANConfig(), args.vocoder_ckpt, device=device)
        if args.vocoder == "hybrid":
            from autovc_tpu_torch.vocoder.hybrid import HybridVocoder

            voc = HybridVocoder(voc, audio, n_iter=args.hybrid_iters)
        return voc.generate
    from autovc_tpu_torch.vocoder.wavenet import WaveNetVocoder

    voc = WaveNetVocoder.from_checkpoint(WaveNetConfig(), args.vocoder_ckpt, device=device)
    dtype = torch.bfloat16 if args.wavenet_engine == "pallas" else torch.float32
    return lambda m: voc.generate_bucketed(m, bucket=args.wavenet_bucket, dtype=dtype, engine=args.wavenet_engine)


def main(argv: list[str] | None = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.results is None) == (args.spmel_dir is None):
        ap.error("exactly one of --results / --spmel_dir")
    if args.vocoder in ("hifigan", "wavenet", "hybrid") and not args.vocoder_ckpt:
        ap.error(f"--vocoder {args.vocoder} requires --vocoder_ckpt: without one the model is random-init and its "
                 f"mel-L1 is meaningless")
    from autovc_tpu_torch.dsp import MelFrontend
    from autovc_tpu_torch.eval.fidelity import mel_fidelity_report

    device = resolve_device(args.device)
    audio = AudioConfig()
    mels = _load_mels(args)
    if args.max_utts:
        mels = mels[: args.max_utts]
    if not mels:
        raise SystemExit("no input mels found")

    l1s, mses, mcds = [], [], []
    with exact_f32(device):
        frontend = MelFrontend(audio, device=device)
        synth = make_vocoder(args, audio, device)
        for _, mel in mels:
            wav = synth(mel)
            re_mel = frontend.mel_features(wav).cpu().numpy()
            rep = mel_fidelity_report(mel, re_mel)
            l1s.append(rep["mel_l1"])
            mses.append(rep["mel_mse"])
            mcds.append(rep["mcd_db"])

    rec = {
        "vocoder": args.vocoder,
        "ckpt": args.vocoder_ckpt,
        "utterances": len(l1s),
        "mel_l1_mean": float(np.mean(l1s)),
        "mel_l1_median": float(np.median(l1s)),
        "mel_mse_mean": float(np.mean(mses)),
        "mcd_db_mean": float(np.mean(mcds)),
        "mcd_db_median": float(np.median(mcds)),
    }
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
