"""Vocoder CLI (reference vocoder.py / synthesis.py): a results_*.pkl
([(name, mel)]) -> <out_dir>/<name>.wav per entry, and <out_dir>/readme.md.

    python -m autovc_tpu_torch.cli.synthesize --results R.pkl --out_dir DIR
        [--vocoder griffinlim|wavenet|hifigan] [--vocoder_ckpt ART.npz]
        [--gl_iters 60] [--bf16] [--wavenet_engine scan|pallas] [--batch N]
        [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/synthesize.py``, with its flags:
  --vocoder griffinlim  phase reconstruction from mel via the pseudo-inverse
                        mel basis (513-bin results take Griffin-Lim directly)
  --vocoder wavenet     autoregressive WaveNet, the CUDA generation kernel
  --vocoder hifigan     the parallel HiFi-GAN generator
Neural vocoders load an exported .npz artifact from --vocoder_ckpt (seeded
weights without it). --bf16 runs WaveNet with bfloat16 weights in the
rounding of the JAX engine --wavenet_engine names: scan (the default) as
JAX's lax.scan engine rounds, every op in bfloat16; pallas as its Pallas
kernel does (float32 accumulators), and it implies bfloat16 as there. Both
run the port's generation kernel, in its scan or its bfloat16 form. With
--batch N > 1 the neural vocoders synthesize N conversions a call, the mels padded to the
group's longest and each waveform trimmed to its own length; one at a time,
WaveNet pads each mel to a multiple of 64 frames and trims. The random
stream of WaveNet is seeded with 0 for every call (JAX's default key gives
other numbers). Waveforms above 0.999 in magnitude are rescaled to 0.999
(hparams.py:78-79) and written as 16-bit PCM at 16 kHz.

Everything runs on --device (default cuda, in exact float32 there; cpu runs
the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import AudioConfig, HiFiGANConfig, WaveNetConfig
from autovc_tpu_torch.data.manifest import load_results
from autovc_tpu_torch.dsp.audio_io import write_wav


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results", required=True, help="results_*.pkl from convert")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--vocoder", default="griffinlim", choices=["griffinlim", "wavenet", "hifigan"])
    ap.add_argument("--vocoder_ckpt", default=None, help="an exported .npz artifact (seeded weights without it)")
    ap.add_argument("--gl_iters", type=int, default=60)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 WaveNet weights (half the bytes a sample)")
    ap.add_argument("--wavenet_engine", default="scan", choices=["scan", "pallas"],
                    help="the JAX CLI's engine names: the bfloat16 rounding of JAX's scan engine (every op "
                         "rounded) or of its Pallas kernel (float32 accumulators; implies --bf16); float32 is "
                         "the same kernel for both")
    ap.add_argument("--batch", type=int, default=1,
                    help="synthesize N conversions per call (neural vocoders): mels padded to the group's "
                         "longest, each waveform trimmed to its own length")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def make_synth(args: argparse.Namespace, audio: AudioConfig, device: torch.device):
    """The chosen vocoder as a function of one (T, F) mel, or of a (B, T, F)
    batch for the neural vocoders, to a waveform tensor on ``device``."""
    if args.vocoder == "griffinlim":
        from autovc_tpu_torch.vocoder.griffinlim import mel_to_waveform, stft_to_waveform

        def synth(feat):
            feat = torch.as_tensor(feat, device=device)
            # 513-bin results (the stft variant's output) take Griffin-Lim
            # directly (vocoder_stft.ipynb); 80-bin ones go through the mel pinv
            if feat.shape[-1] == audio.n_stft_bins:
                return stft_to_waveform(feat, audio, n_iter=args.gl_iters)
            return mel_to_waveform(feat, audio, n_iter=args.gl_iters)
        return synth
    if args.vocoder == "wavenet":
        from autovc_tpu_torch.vocoder.wavenet import WaveNetVocoder

        voc = WaveNetVocoder.from_checkpoint(WaveNetConfig(), args.vocoder_ckpt, device=device)
        dt = torch.bfloat16 if (args.bf16 or args.wavenet_engine == "pallas") else torch.float32
        if args.batch > 1:
            return lambda mel: voc.generate(mel, dtype=dt, engine=args.wavenet_engine)
        # one utterance at a time: lengths bucketed (a causal core, so the trim is exact)
        return lambda mel: voc.generate_bucketed(mel, dtype=dt, engine=args.wavenet_engine)
    from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder

    voc = HiFiGANVocoder.from_checkpoint(HiFiGANConfig(), args.vocoder_ckpt, device=device)
    return voc.generate


def batched_synthesis(synth, results, batch: int, hop: int) -> list:
    """Group conversions, pad mels to the group max, synthesize one batched
    call per group, trim each waveform to its own Tc*hop length."""
    wavs: list = [None] * len(results)
    order = sorted(range(len(results)), key=lambda i: results[i][1].shape[0])
    for off in range(0, len(order), batch):
        group = order[off : off + batch]
        tmax = max(results[i][1].shape[0] for i in group)
        mels = np.zeros((len(group), tmax, results[group[0]][1].shape[1]), np.float32)
        for k, i in enumerate(group):
            m = results[i][1]
            mels[k, : m.shape[0]] = m
        out = np.asarray(synth(mels).cpu())
        for k, i in enumerate(group):
            wavs[i] = out[k, : results[i][1].shape[0] * hop]
    return wavs


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    audio = AudioConfig()
    os.makedirs(args.out_dir, exist_ok=True)
    results = load_results(args.results)

    with exact_f32(device):
        synth = make_synth(args, audio, device)
        if args.batch > 1 and args.vocoder in ("wavenet", "hifigan"):
            wavs = batched_synthesis(synth, results, args.batch, audio.hop_length)
        else:
            wavs = [np.asarray(synth(np.asarray(mel, np.float32)).cpu()) for _, mel in results]

    readme_lines = [
        "# Synthesized conversions",
        f"vocoder: {args.vocoder}; results: {os.path.abspath(args.results)}",
        "Cross-reference conversion ids against the metadata.log written by",
        "make_metadata (the reference's results/readme.md convention).",
        "",
    ]
    for (name, _), wav in zip(results, wavs):
        peak = np.abs(wav).max()
        if peak > 0.999:  # hparams.py:78-79 rescaling contract
            wav = wav / peak * 0.999
        path = os.path.join(args.out_dir, f"{name}.wav")
        write_wav(path, wav, audio.sample_rate)  # vocoder.py:22
        dur = wav.shape[-1] / audio.sample_rate
        readme_lines.append(f"- {name}.wav ({dur:.2f}s)")
        print(f"[synthesize] {path} ({dur:.2f}s)")
    with open(os.path.join(args.out_dir, "readme.md"), "w") as fh:
        fh.write("\n".join(readme_lines) + "\n")


if __name__ == "__main__":
    main()
