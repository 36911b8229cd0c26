"""Ground-truth-aligned (GTA) features for vocoder fine-tuning: the trained
generator in identity mode (source embedding as the target's, eval-mode
BatchNorm) over every utterance of a corpus, each reconstructed mel saved
under the original's name.

    python -m autovc_tpu_torch.cli.make_gta_features --main_dir DIR
        --artifact FILE.npz --out_dir OUT [--device cuda|cpu]

Counterpart of ``scripts/make_gta_features.py``, with its flags (--device
in place of --platform). It reads ``<main_dir>/spmel/train.pkl`` for each
speaker's embedding and every ``<main_dir>/spmel/<speaker>/*.npy`` of a
speaker listed there, pads each mel with zero frames to a multiple of the
generator's freq (32), as the dense ``Converter`` does, so that the
backward LSTM sees the tail it sees at conversion, runs the default
``ModelConfig`` generator on the weights of --artifact (as
``io.load_artifact`` reads them), cuts the postnet's output back to the
mel's length and writes it as float32 to ``<out_dir>/<speaker>/<name>``.
Fine-tuning a vocoder on (GTA mel, original wav) pairs closes the gap
between the features it was trained on and the ones conversion gives it.

Everything runs on --device (default cuda, in exact float32 there; cpu runs
the plain PyTorch versions), one utterance a call.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from autovc_tpu_torch import exact_f32, resolve_device
from autovc_tpu_torch.config import ModelConfig
from autovc_tpu_torch.data.manifest import load_train_manifest
from autovc_tpu_torch.io import load_artifact
from autovc_tpu_torch.models import build_generator


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--main_dir", required=True)
    ap.add_argument("--artifact", required=True, help="an exported generator .npz")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def reconstruct(gen: torch.nn.Module, mel: np.ndarray, emb: torch.Tensor, freq: int) -> np.ndarray:
    """One utterance's identity pass: the mel (T, n_bins) padded with zero
    frames to a multiple of ``freq``, the postnet's output cut back to T."""
    t = mel.shape[0]
    x = np.pad(mel, ((0, (-t) % freq), (0, 0)))[None]
    with torch.inference_mode():
        out = gen(torch.from_numpy(x).to(emb.device), emb, emb)[1]
    return out[0, :t].float().cpu().numpy().astype(np.float32)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = ModelConfig()  # the default Config's generator, as the JAX script builds it
    spmel = os.path.join(args.main_dir, "spmel")
    emb_by_spk = {e.speaker_id: e.embedding for e in load_train_manifest(os.path.join(spmel, "train.pkl"))}
    n = 0
    with exact_f32(device):
        gen = build_generator(cfg, artifact=args.artifact, device=device)
        print(f"[gta] generator step {load_artifact(args.artifact)[1]}")
        for spk in sorted(os.listdir(spmel)):
            d = os.path.join(spmel, spk)
            if not os.path.isdir(d) or spk not in emb_by_spk:
                continue
            os.makedirs(os.path.join(args.out_dir, spk), exist_ok=True)
            emb = torch.from_numpy(np.asarray(emb_by_spk[spk], np.float32)[None]).to(device)
            for fn in sorted(os.listdir(d)):
                if not fn.endswith(".npy"):
                    continue
                mel = np.load(os.path.join(d, fn))
                np.save(os.path.join(args.out_dir, spk, fn), reconstruct(gen, mel, emb, cfg.freq))
                n += 1
    print(f"[gta] wrote {n} reconstructions -> {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
