"""Where the LSTM scan backward (``ops.lstm.lstm_scan_backward_cuda``,
``autovc_tpu_torch/ops/csrc/lstm_scan_bwd.cu``) spends a step, on the card:
an instrumented copy built under ``build/scan_bwd_phases/`` in which each
block's first thread reads the SM clock around the parts of a step and adds
their cycles up over the sequence:

    python3 scripts/scan_bwd_phases.py

Regime (b) (the persistent kernel), a step's parts as thread 0 sees them:
the issue of the TMA copies of dgates_{t_next} ("copies"), the prefetch of
the cell's residuals ("prefetch"), the wait for the copies ("copy_wait"),
warp 0's k16 steps of the dh product on mma.sync ("product"), the block
barrier that completes the warps' sums ("sums_barrier"), the cell of warp
0's pairs with dxproj's stores ("cell"), the barrier that frees the tile
("tile_barrier") and the grid barrier ("grid_barrier"); regime (a): the
prefetch, the product, the cell with the tile's stores, the block barrier.
At the Generator's training sequences (B=7, T=128, H = 32, 512, 1024) and
the d-vector's H=768, B=7, it prints the cycles of each part a step (mean
over the blocks and the slowest block), their sum against the kernel's time
a step (CUDA events), and the card's largest SM clock. The kernel's gates
and times are ``chip_smoke.py`` 8d's and 10b's. Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import scan_stamps
from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import lstm as lstm_ops

CASES = [(7, 128, 1024), (7, 128, 512), (7, 128, 768), (7, 128, 32)]
PARTS = {"b": ("copies", "prefetch", "copy_wait", "product", "sums_barrier", "cell", "tile_barrier",
               "grid_barrier"),
         "a": ("prefetch", "product", "cell", "barrier")}
MAX_BLOCKS, SLOTS = 512, 8
EDITS = [
    # regime (a)
    ("    p = next;\n    if (s + 1 < a.T) prefetch(next, a, b, u, step_t(a, s + 1));\n    if (s > 0) {\n",
     "    const long long A0 = clock64();\n    p = next;\n    if (s + 1 < a.T) prefetch(next, a, b, u, step_t(a, s + 1));\n"
     "    const long long A1 = clock64();\n    if (s > 0) {\n"),
    ("      carry[1] = rb(acc[1]);\n    }\n    if (s == a.T) {\n",
     "      carry[1] = rb(acc[1]);\n    }\n    const long long A2 = clock64();\n    if (s == a.T) {\n"),
    ("    __syncthreads();  // dgates_t in the tile before the next product\n  }\n",
     "    const long long A3 = clock64();\n    __syncthreads();  // dgates_t in the tile before the next product\n"
     "    if (threadIdx.x == 0) {\n      g_prof[blockIdx.x][0] += A1 - A0;\n      g_prof[blockIdx.x][1] += A2 - A1;\n"
     "      g_prof[blockIdx.x][2] += A3 - A2;\n      g_prof[blockIdx.x][3] += clock64() - A3;\n    }\n  }\n"),
    # regime (b)
    ("      const int b0 = tl * R, b = b0 + 8 * warp + g;\n",
     "      const int b0 = tl * R, b = b0 + 8 * warp + g;\n      const long long T0 = clock64();\n"
     "      long long Tw = 0, Tp = 0;\n"),
    ("      if (cell_warp && s < a.T) prefetch(p, a, b, u, t);\n",
     "      const long long T1 = clock64();\n      if (cell_warp && s < a.T) prefetch(p, a, b, u, t);\n"
     "      const long long T2 = clock64();\n"),
    ("          product(acc, st, tile, R, zero_line);\n",
     "          Tw = clock64();\n          product(acc, st, tile, R, zero_line);\n          Tp = clock64();\n"),
    ("      __syncthreads();  // the warps' sums complete\n",
     "      __syncthreads();  // the warps' sums complete\n      const long long T3 = clock64();\n"),
    ("      __syncthreads();  // the tile and the sums free for the next tile\n    }\n",
     "      const long long T4 = clock64();\n      __syncthreads();  // the tile and the sums free for the next tile\n"
     "      if (threadIdx.x == 0) {\n        g_prof[blockIdx.x][0] += T1 - T0;\n        g_prof[blockIdx.x][1] += T2 - T1;\n"
     "        if (Tp > 0) {\n          g_prof[blockIdx.x][2] += Tw - T2;\n          g_prof[blockIdx.x][3] += Tp - Tw;\n"
     "        }\n        g_prof[blockIdx.x][4] += T3 - (Tp > 0 ? Tp : T2);\n        g_prof[blockIdx.x][5] += T4 - T3;\n"
     "        g_prof[blockIdx.x][6] += clock64() - T4;\n      }\n    }\n    const long long T6 = clock64();\n"),
    ("    if (s < a.T) grid.sync();  // every dxproj_t written before any block reads it\n",
     "    if (s < a.T) grid.sync();  // every dxproj_t written before any block reads it\n"
     "    if (threadIdx.x == 0) g_prof[blockIdx.x][7] += clock64() - T6;\n"),
]


def main() -> None:
    dev = torch.device("cuda")
    source = _build.CSRC / "lstm_scan_bwd.cu"
    dll = scan_stamps.build(scan_stamps.instrument(source.read_text(), EDITS, source.name, MAX_BLOCKS, SLOTS),
                            "scan_bwd_phases")
    _build._loaded["lstm_scan_bwd"] = dll  # the wrapper launches the instrumented copy
    mhz = scan_stamps.sm_clock_mhz()
    print(f"card: {scan_stamps.card()}; largest SM clock {mhz:.0f} MHz", flush=True)
    for b, t, hidden in CASES:
        rng = np.random.RandomState(hidden)
        lim = 1.0 / np.sqrt(hidden)
        x = torch.from_numpy((rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)).to(dev).bfloat16()
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).bfloat16()
        dy = torch.from_numpy(rng.randn(b, t, hidden).astype(np.float32)).to(dev).bfloat16()
        _, c_seq, act, _, _ = lstm_ops.lstm_scan_forward_cuda(x, w, with_residuals=True)
        prof, ms = scan_stamps.stamped(dll, lambda: lstm_ops.lstm_scan_backward_cuda(w, act, c_seq, None, dy),
                                       MAX_BLOCKS, SLOTS)
        plan = lstm_ops.last_launch["scan_bwd"][0]
        names = PARTS[plan.regime]
        parts = scan_stamps.parts(prof[:plan.blocks, :len(names)] / t, names)
        total = sum(v["mean"] for v in parts.values())
        us = ms / t * 1e3
        print(json.dumps({"B": b, "T": t, "H": hidden, "plan": plan.__dict__, "cycles_a_step": parts,
                          "sum_cycles": total, "kernel_us_a_step": us, "cycles_per_us": total / us}), flush=True)


if __name__ == "__main__":
    main()
