"""Where the LSTM scan forward (``ops.lstm.lstm_scan_forward_cuda``,
``autovc_tpu_torch/ops/csrc/lstm_scan_fwd.cu``) spends a step, on the card:
an instrumented copy built under ``build/scan_fwd_phases/`` in which each
block's first thread reads the SM clock around the parts of a step and adds
their cycles up over the sequence:

    python3 scripts/scan_fwd_phases.py

Regime (b) (the persistent kernel): the proxy fence before the copies
("fence"), the issue of the TMA copies of h_{t-1} from the exchange buffer
("copies"), the prefetch of the next iteration's xproj ("prefetch"), the
tensor-core product as the copies land, with the K parts' sums written to
shared memory ("copy_product"), the cell update ("cell"), the proxy fence
after it and the grid barrier ("barrier");
regime (a): the prefetch, the product, the cell update with the h tile's
barrier. At the Generator's B=32, T=512 (H = 32, 512, 1024; at H=1024 also
16 units a block, the plan ``ops.lstm.scan_plan`` makes for a card of 64 SMs) and the training shapes' B=7, T=128 (H=1024), prints the
cycles of each part a step (mean over the blocks and the slowest block),
their sum against the kernel's time a step (CUDA events; the parts' cycles
over it give the clock the run held), and the card's largest SM clock. The kernel's times, bound and its gates are
``chip_smoke.py`` 10a and 10b. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import scan_stamps
from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import lstm as lstm_ops

# (B, T, H, SMs to plan for: None the card's; H / 16 forces 16 units a block)
CASES = [(32, 512, 1024, None), (32, 512, 1024, 64), (32, 512, 512, None), (32, 512, 32, None), (7, 128, 1024, None)]
PARTS = {"b": ("fence", "copies", "prefetch", "copy_product", "cell", "barrier"), "a": ("prefetch", "product", "cell")}
MAX_BLOCKS, SLOTS = 512, 6


def instrumented_source() -> str:
    """lstm_scan_fwd.cu with clock stamps (see the module's notes)."""
    src = (_build.CSRC / "lstm_scan_fwd.cu").read_text()
    edits = [
        # regime (b)
        ("      const int b0 = tile * N, rows = min(N, a.B - b0);\n",
         "      const int b0 = tile * N, rows = min(N, a.B - b0);\n"
         "      const long long T0 = clock64();\n      long long T1 = T0, T2 = T0, Tf = T0, Tc = T0;\n"),
        ("        asm volatile(\"fence.proxy.async.global;\\n\" ::: \"memory\");  // the other blocks' h_{t-1}, for the copy\n",
         "        asm volatile(\"fence.proxy.async.global;\\n\" ::: \"memory\");  // the other blocks' h_{t-1}, for the copy\n"
         "        Tf = clock64();\n"),
        ("          tma_load_4d(sm.h + part * a.kh * N * 128, &a.map_h, sm.bar + part, 0, b0, part * a.kh, (s - 1) & 1);\n"
         "        }\n",
         "          tma_load_4d(sm.h + part * a.kh * N * 128, &a.map_h, sm.bar + part, 0, b0, part * a.kh, (s - 1) & 1);\n"
         "        }\n        Tc = clock64();\n"),
        ("      if (prod) product<N>(a, sm, copies++ & 1u);\n",
         "      T1 = clock64();\n      if (prod) product<N>(a, sm, copies++ & 1u);\n      T2 = clock64();\n"),
        ("      __syncthreads();  // the h tile and the sums free for the next tile; h_t written\n    }\n",
         "      __syncthreads();  // the h tile and the sums free for the next tile; h_t written\n"
         "      if (threadIdx.x == 0) {\n        g_prof[blockIdx.x][0] += Tf - T0;\n"
         "        g_prof[blockIdx.x][1] += Tc - Tf;\n        g_prof[blockIdx.x][2] += T1 - Tc;\n"
         "        g_prof[blockIdx.x][3] += T2 - T1;\n        g_prof[blockIdx.x][4] += clock64() - T2;\n      }\n"
         "    }\n    const long long T4 = clock64();\n"),
        ("    if (s + 1 < a.T) grid.sync();  // every h_t written before any block reads it\n",
         "    if (s + 1 < a.T) grid.sync();  // every h_t written before any block reads it\n"
         "    if (threadIdx.x == 0) g_prof[blockIdx.x][5] += clock64() - T4;\n"),
        # regime (a)
        ("    p = next;\n    if (s + 1 < a.T) prefetch(next, a, sl, npairs, b0, rows, 0,",
         "    const long long T0 = clock64();\n    p = next;\n    if (s + 1 < a.T) prefetch(next, a, sl, npairs, b0, rows, 0,"),
        ("    if (prod) product_mma(a, sm, af);  // ends synchronised: the h tile is free to overwrite\n",
         "    const long long T1 = clock64();\n"
         "    if (prod) product_mma(a, sm, af);  // ends synchronised: the h tile is free to overwrite\n"
         "    const long long T2 = clock64();\n"),
        ("    __syncthreads();  // h_t in the tile before the next product\n  }\n",
         "    __syncthreads();  // h_t in the tile before the next product\n"
         "    if (threadIdx.x == 0) {\n      g_prof[blockIdx.x][0] += T1 - T0;\n"
         "      g_prof[blockIdx.x][1] += T2 - T1;\n      g_prof[blockIdx.x][2] += clock64() - T2;\n    }\n  }\n"),
    ]
    return scan_stamps.instrument(src, edits, "lstm_scan_fwd.cu", MAX_BLOCKS, SLOTS)


def main() -> None:
    dev = torch.device("cuda")
    dll = scan_stamps.build(instrumented_source(), "scan_fwd_phases")
    _build._loaded["lstm_scan_fwd"] = dll  # the wrapper launches the instrumented copy
    mhz = scan_stamps.sm_clock_mhz()
    print(f"card: {scan_stamps.card()}; largest SM clock {mhz:.0f} MHz", flush=True)
    card_plan = lstm_ops.scan_plan
    for b, t, hidden, sms in CASES:
        rng = np.random.RandomState(hidden)
        x = torch.from_numpy((rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)).to(dev).bfloat16()
        lim = 1.0 / np.sqrt(hidden)
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).bfloat16()
        plan = card_plan(b, hidden, sms or lstm_ops._card_sms(0))
        lstm_ops.scan_plan = lambda *_, plan=plan: plan  # the wrapper launches this plan
        prof, ms = scan_stamps.stamped(dll, lambda: lstm_ops.lstm_scan_forward_cuda(x, w), MAX_BLOCKS, SLOTS)
        names = PARTS[plan.regime]
        parts = scan_stamps.parts(prof[:plan.blocks, :len(names)] / t, names)
        total = sum(v["mean"] for v in parts.values())
        us = ms / t * 1e3
        print(json.dumps({"B": b, "T": t, "H": hidden, "plan": plan.__dict__, "cycles_a_step": parts,
                          "sum_cycles": total, "kernel_us_a_step": us, "cycles_per_us": total / us}), flush=True)


if __name__ == "__main__":
    main()
