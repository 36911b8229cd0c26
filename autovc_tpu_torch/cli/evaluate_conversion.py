"""Conversion-quality evaluation: speaker similarity over the all-pairs matrix.

    python -m autovc_tpu_torch.cli.evaluate_conversion --main_dir DIR
        --artifact GEN.npz --dvector_ckpt GE2E.npz [--model_type spmel|stft]
        [--through mel|audio] [--vocoder griffinlim|hifigan|wavenet]
        [--vocoder_ckpt V.npz] [--gl_iters 60] [--wavenet_engine scan|pallas]
        [--utterance_index 0] [--centroid_utts 10] [--batch_size 8]
        [--out report.json] [--device cuda|cpu]

Counterpart of ``autovc_tpu/cli/evaluate_conversion.py``: the N x N
conversion matrix of ``<main_dir>/<model_type>/train.pkl`` (each speaker's
``--utterance_index``-th utterance to every speaker, through
``Converter.convert_batch(to_mel=True)``), every converted mel re-embedded
by the GE2E d-vector of --dvector_ckpt (``eval.SpeakerEmbedder``) and
scored by its cosine to the target and the source speaker's centroid (the
mean embedding of each speaker's first --centroid_utts utterances of
``<main_dir>/spmel``); a conversion succeeds when it is nearer the target.
Identity pairs also give the reconstruction L1 against the source's mel.

  --through mel    embed the converted mel (the generator alone)
  --through audio  converted mel -> vocoder -> waveform -> re-extracted mel
                   -> embedding (the whole production path); WaveNet runs
                   bucketed, in bfloat16 with --wavenet_engine pallas;
                   hybrid is HiFi-GAN refined by 2 Griffin-Lim iterations
                   on the mel's magnitude (``vocoder.hybrid``)
Prints the summary as
one JSON line; --out writes it with every record. Runs on --device
(default cuda, in exact float32 there).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.cli.synthesize import make_synth
from autovc_tpu_torch.config import AudioConfig, HiFiGANConfig, ModelConfig
from autovc_tpu_torch.convert import Converter, all_pairs_specs
from autovc_tpu_torch.data.manifest import load_train_manifest
from autovc_tpu_torch.dsp.features import MelFrontend
from autovc_tpu_torch.eval import (SpeakerEmbedder, load_speaker_mels, similarity_record, speaker_centroids,
                                   summarize_similarity)
from autovc_tpu_torch.io import load_artifact
from autovc_tpu_torch.models import build_generator
from autovc_tpu_torch.train.ge2e import load_params


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--artifact", required=True, help="an exported generator .npz")
    ap.add_argument("--dvector_ckpt", required=True, help="a GE2E .npz")
    ap.add_argument("--model_type", default="spmel", choices=["spmel", "stft"])
    ap.add_argument("--through", default="mel", choices=["mel", "audio"])
    ap.add_argument("--vocoder", default="hifigan", choices=["griffinlim", "hifigan", "hybrid", "wavenet"])
    ap.add_argument("--vocoder_ckpt", default=None)
    ap.add_argument("--gl_iters", type=int, default=60)
    ap.add_argument("--wavenet_engine", default="pallas", choices=["scan", "pallas"],
                    help="the JAX CLI's engine names; both run the port's generation kernel, pallas in bfloat16")
    ap.add_argument("--utterance_index", type=int, default=0)
    ap.add_argument("--centroid_utts", type=int, default=10, help="utterances per centroid")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--out", default=None, help="write the full JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.through == "audio" and args.vocoder in ("hifigan", "hybrid", "wavenet") and not args.vocoder_ckpt:
        ap.error(f"--through audio with --vocoder {args.vocoder} requires --vocoder_ckpt")
    device = resolve_device(args.device)
    audio = AudioConfig()
    feature_dir = os.path.join(args.main_dir, args.model_type)
    mel_dir = os.path.join(args.main_dir, "spmel")  # embeddings are always of mels
    entries = load_train_manifest(os.path.join(mel_dir, "train.pkl"))

    with exact_f32(device):
        embedder = SpeakerEmbedder(load_params(args.dvector_ckpt), device=device)
        print(f"[evaluate_conversion] building centroids for {len(entries)} speakers")
        centroids = speaker_centroids(embedder, load_speaker_mels(mel_dir, entries, args.centroid_utts))

        cfg = ModelConfig(model_type=args.model_type)
        step = load_artifact(args.artifact)[1]
        converter = Converter(build_generator(cfg, artifact=args.artifact, device=device), cfg, audio)
        specs = all_pairs_specs(entries, feature_dir, args.utterance_index)
        print(f"[evaluate_conversion] converting {len(specs)} pairs (generator step {step})")
        converted = converter.convert_batch(specs, batch_size=args.batch_size, to_mel=True)

        if args.through == "audio":
            args.bf16, args.batch = False, 1  # cli.synthesize's one-at-a-time path (WaveNet bucketed)
            if args.vocoder == "hybrid":
                from autovc_tpu_torch.vocoder.hifigan import HiFiGANVocoder
                from autovc_tpu_torch.vocoder.hybrid import HybridVocoder

                synth = HybridVocoder(HiFiGANVocoder.from_checkpoint(HiFiGANConfig(), args.vocoder_ckpt,
                                                                     device=device), audio).generate
            else:
                synth = make_synth(args, audio, device)
            frontend = MelFrontend(audio, device=device)
            print(f"[evaluate_conversion] audio path via {args.vocoder}")
            converted = [frontend.mel_features(synth(m)).cpu().numpy() for m in converted]

        # outputs are mels (stft projected), so stft sources go through the
        # same basis before any comparison
        records, recon_l1 = [], []
        for spec, mel_out in zip(specs, converted):
            src_mel = converter.project_mel(spec.src_features)
            src = spec.src_speaker
            if spec.trg_speaker == src:
                n = min(mel_out.shape[0], src_mel.shape[0])
                recon_l1.append(float(np.abs(mel_out[:n] - src_mel[:n]).mean()))
            records.append(similarity_record(embedder, centroids, mel_out, src=src, trg=spec.trg_speaker,
                                             orig_mel=src_mel))

    summary = summarize_similarity(records)
    summary.update({
        "through": args.through,
        "vocoder": args.vocoder if args.through == "audio" else None,
        "generator_step": step,
        "identity_recon_l1_mean": float(np.mean(recon_l1)) if recon_l1 else None,
    })
    report = {"summary": summary, "records": records}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[evaluate_conversion] report -> {args.out}")
    return report


if __name__ == "__main__":
    main()
