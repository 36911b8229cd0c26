"""Device times of WaveNet generation's three kernel forms, on the card: the
float32 kernel, the bfloat16 form in the Pallas engine's rounding and the
bfloat16 form in the scan engine's rounding (``ops.wavenet.generate`` with
float32 or bfloat16 packed weights, ``scan`` False or True), at full width
on seeded weights, B = 1, 8 and 32, T = 2048:

    python3 scripts/wavenet_times.py [--root DIR] [--batches 1 8 32] [--samples 2048] [--reps 2]

``--root`` imports ``autovc_tpu_torch`` from another checkout (a parent
commit unpacked with ``git archive``), so that two trees' kernels are timed
by one method in one call (run parent, change, change, parent). A time is
CUDA events around ``--reps`` calls after a warm one (one cooperative
launch a call: the host does not pace the card); the line gives us a
sample, the launch plan, the bytes bound of a sample (every weight read
once) and the card's name and power limit, as JSON. Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose autovc_tpu_torch is timed")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wavenet_times: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from autovc_tpu_torch.config import WaveNetConfig
    from autovc_tpu_torch.ops import wavenet as wavenet_ops
    from autovc_tpu_torch.vocoder import WaveNetVocoder

    dev, cfg = torch.device("cuda"), WaveNetConfig()
    name = card()
    print(f"card: {name}; torch {torch.__version__}; package {Path(wavenet_ops.__file__).resolve()}", flush=True)
    frames = -(-args.samples // cfg.hop_size)
    forms = (("float32", torch.float32, False), ("bfloat16", torch.bfloat16, False), ("scan", torch.bfloat16, True))
    for b in args.batches:
        voc = WaveNetVocoder(cfg, device=dev, seed=3)
        mel = torch.from_numpy(np.random.RandomState(b).rand(b, frames, 80).astype(np.float32)).to(dev)
        with torch.inference_mode():
            cond = voc.model.upsample_conditioning(mel)[:, :args.samples].contiguous()
            u = voc.uniforms(b, cond.shape[1], torch.Generator().manual_seed(5))
            t = cond.shape[1]
            for form, dtype, scan in forms:
                packed = voc.packed_for(dtype)
                call = lambda: wavenet_ops.generate(packed, cfg.dilations(), cond, u, cfg.log_scale_min, scan)
                call()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / args.reps
                plan = wavenet_ops.last_launch[0]
                weight_bytes = sum(v.numel() * v.element_size() for v in packed.values())
                print(json.dumps({"tree": str(root), "form": form, "B": b, "T": t, "ms": ms, "us_a_sample": ms / t * 1e3,
                                  "bytes_bound_us_a_sample": weight_bytes / HBM_BYTES_PER_S * 1e6,
                                  "plan": {k: getattr(plan, k) for k in plan.__dataclass_fields__}, "card": name}),
                      flush=True)
    print(f"card: {card()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
