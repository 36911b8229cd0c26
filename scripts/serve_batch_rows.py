"""Where a batched row of the Generator parts from the same row run alone,
on the card: the float32 spmel Generator (published widths, seeded) on 8
rows of T=512 and on the first of them alone, every module's output and
every LSTM call's input projection and hidden sequence for that row, with
the LSTM launch plan of each call:

    python3 scripts/serve_batch_rows.py [--batch 8] [--seed 1]

It says why ``cli.serve``'s micro-batched responses are held to a
tolerance against their solo calls (``chip_smoke.py`` 12c), not bit for
bit. Prints the card's name and power limit first. Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from autovc_tpu_torch import exact_f32  # noqa: E402
from autovc_tpu_torch.config import ModelConfig  # noqa: E402
from autovc_tpu_torch.models import build_generator  # noqa: E402
from autovc_tpu_torch.ops import lstm as lstm_ops  # noqa: E402


def first_row(gen, x, e) -> tuple[dict, list]:
    """Row 0 of every named module's output, and (xproj, h_seq, plan) of
    every LSTM call, for a forward over x's rows."""
    outs: dict = {}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: outs.__setitem__(
        n, (o[1] if isinstance(o, tuple) else o)[0].float().clone())) for n, m in gen.named_modules() if n]
    calls = []
    real = lstm_ops.lstm_sequence

    def recorded(xproj, w_hh, reverse=False, scan=False):
        y = real(xproj, w_hh, reverse, scan)
        calls.append((xproj[0].clone(), y[0].clone(), lstm_ops.last_launch.get("fwd", (None,))[0]))
        return y

    lstm_ops.lstm_sequence = recorded
    try:
        with torch.inference_mode(), exact_f32(x.device):
            gen(x, e, e)
    finally:
        lstm_ops.lstm_sequence = real
        for h in hooks:
            h.remove()
    return outs, calls


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = build_generator(ModelConfig(), device=dev, seed=args.seed)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(args.batch, 512, 80).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.rand(args.batch, 256).astype(np.float32)).to(dev)
    solo, solo_calls = first_row(gen, x[:1], e[:1])
    batch, batch_calls = first_row(gen, x, e)
    for name, out in solo.items():
        print(f"module {name}: max abs {float((out - batch[name]).abs().max()):.3e}")
    for i, ((xs, ys, ps), (xb, yb, pb)) in enumerate(zip(solo_calls, batch_calls)):
        print(f"lstm call {i}: xproj max abs {float((xs - xb).abs().max()):.3e}, h_seq "
              f"{float((ys - yb).abs().max()):.3e}; plan alone {ps}, batched {pb}")


if __name__ == "__main__":
    main()
