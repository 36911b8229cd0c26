"""Device times of the scan rounding's two training kernels, on the card: the
scan backward (``ops.lstm.lstm_scan_backward_cuda``) and the scan dW
(``ops.lstm.lstm_scan_weight_grad_cuda``), beside cuDNN's bfloat16 LSTM
backward at the same shapes (a yardstick the port never calls):

    python3 scripts/scan_train_times.py [--root DIR] [--reps N]

``--root`` imports ``autovc_tpu_torch`` from another checkout (a parent
commit unpacked with ``git archive``), so that two trees' kernels are timed
by one method in one call; their wrappers take the same arguments. Shapes:
the Generator's training sequences (B=7, T=128, H = 32, 512, 1024, both
directions: backward and dW) and the frozen d-vector's (T=128, H = 768 and
256 at B = 1, 7, 8: the backward alone). The residuals come from the scan
forward's kernel on seeded inputs, as ``LSTMSequenceFn`` feeds them.

A time is the card's: the calls are queued behind ``torch.cuda._sleep``, so
that the host's wrapper never paces the card, and CUDA events around
``--reps`` of them give the device's time a call (the launches back to back;
the profiler drops the cooperative kernels' records). Each line is JSON with
the card's name and power limit. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

GENERATOR = [(7, 128, 32), (7, 128, 512), (7, 128, 1024)]
DVECTOR = [(b, 128, h) for h in (768, 256) for b in (1, 7, 8)]
BF16_TC_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12  # H100 SXM: bfloat16 tensor cores (dense), HBM3


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def queued_ms(fn, reps: int) -> float:
    """The card's ms a call of ``fn``: ``reps`` calls enqueued while the card
    sleeps (for 1.5x the host's time to enqueue them), timed by CUDA events
    from the first to the last."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * host_s * 2e9) + 1_000_000)  # cycles, at up to 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    ops, byt = flops / BF16_TC_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= byt else (byt, "bytes")


def bwd_work(b: int, t: int, h: int) -> tuple[float, float]:
    """The scan backward without dW: the dh product's 2*B*T*4H*H flops of
    bfloat16 operands; act and c_seq (float32 residuals) read, dy and w_hh
    (bfloat16) read, dxproj (bfloat16) written."""
    return 2.0 * b * t * 4 * h * h, 4.0 * (b * t * 4 * h + b * t * h) + 2.0 * (b * t * h + h * 4 * h + b * t * 4 * h)


def dw_work(b: int, t: int, h: int) -> tuple[float, float]:
    """The scan dW: 2*B*T*H*4H flops of bfloat16 operands; h_seq and dxproj
    read, dW written, bfloat16."""
    return 2.0 * b * t * h * 4 * h, 2.0 * (b * t * h + b * t * 4 * h + h * 4 * h)


def cudnn_bwd_ms(dev: torch.device, b: int, t: int, h: int, reps: int) -> float:
    """Yardstick: torch.nn.LSTM (cuDNN) in bfloat16, one layer of H units on
    a (B, T, H) input that requires grad, the backward alone (its data and
    weight gradients over one retained graph)."""
    net = torch.nn.LSTM(h, h, batch_first=True).to(dev, torch.bfloat16)
    x = torch.randn(b, t, h, device=dev, dtype=torch.bfloat16, requires_grad=True)
    out, _ = net(x)
    dy = torch.randn_like(out)
    return queued_ms(lambda: out.backward(dy, retain_graph=True), reps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose autovc_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from autovc_tpu_torch.ops import lstm as lstm_ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card()}; torch {torch.__version__}; package {Path(lstm_ops.__file__).resolve()}", flush=True)
    cases = [(s, r, True) for s in GENERATOR for r in (False, True)] + [(s, False, False) for s in DVECTOR]
    for (b, t, h), reverse, with_dw in cases:
        rng = np.random.RandomState(b * 10_000 + h)
        lim = 1.0 / np.sqrt(h)
        x = torch.from_numpy((rng.randn(b, t, 4 * h) * 0.5).astype(np.float32)).to(dev).bfloat16()
        w = torch.from_numpy(rng.uniform(-lim, lim, (h, 4 * h)).astype(np.float32)).to(dev).bfloat16()
        dy = torch.from_numpy(rng.randn(b, t, h).astype(np.float32)).to(dev).bfloat16()
        h_seq, c_seq, act, _, _ = lstm_ops.lstm_scan_forward_cuda(x, w, reverse=reverse, with_residuals=True)
        dx = lstm_ops.lstm_scan_backward_cuda(w, act, c_seq, None, dy, reverse=reverse)[0]
        bwd_ms = queued_ms(lambda: lstm_ops.lstm_scan_backward_cuda(w, act, c_seq, None, dy, reverse=reverse),
                           args.reps)
        line = {"B": b, "T": t, "H": h, "reverse": reverse, "bwd_ms": bwd_ms, "bwd_us_a_step": bwd_ms / t * 1e3}
        line["bwd_bound_ms"], line["bwd_bound_by"] = bound_ms(*bwd_work(b, t, h))
        if with_dw:
            line["dw_ms"] = queued_ms(lambda: lstm_ops.lstm_scan_weight_grad_cuda(h_seq, None, dx, reverse),
                                      args.reps)
            line["dw_bound_ms"], line["dw_bound_by"] = bound_ms(*dw_work(b, t, h))
        if not reverse:
            line["cudnn_bf16_bwd_ms"] = cudnn_bwd_ms(dev, b, t, h, max(3, args.reps // 4))
        print(json.dumps(line), flush=True)
    print(f"card: {card()}", flush=True)


if __name__ == "__main__":
    main()
