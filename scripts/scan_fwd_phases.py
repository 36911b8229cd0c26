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

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import lstm as lstm_ops  # noqa: E402

# (B, T, H, SMs to plan for: None the card's; H / 16 forces 16 units a block)
CASES = [(32, 512, 1024, None), (32, 512, 1024, 64), (32, 512, 512, None), (32, 512, 32, None), (7, 128, 1024, None)]
PARTS = {"b": ("fence", "copies", "prefetch", "copy_product", "cell", "barrier"), "a": ("prefetch", "product", "cell")}
MAX_BLOCKS, SLOTS = 512, 6


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's largest SM clock (nvidia-smi reads the current one idle)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return float(out)


def instrumented_source() -> str:
    """lstm_scan_fwd.cu with clock stamps (see the module's notes)."""
    src = (_build.CSRC / "lstm_scan_fwd.cu").read_text()
    edits = [
        ('#include "lstm_common.cuh"\n',
         f'#include "lstm_common.cuh"\n\n__device__ long long g_prof[{MAX_BLOCKS}][SLOTS];\n'),
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
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"lstm_scan_fwd.cu has changed: the stamp anchor {old!r} is not there once")
        src = src.replace(old, new)
    src = src.replace("SLOTS", str(SLOTS))
    return src + f"""
extern "C" int autovc_scan_prof(long long* out, int zero) {{
  if (zero) {{
    static long long z[{MAX_BLOCKS}][{SLOTS}] = {{}};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}}
"""


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "scan_fwd_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "lstm_scan_fwd_phases.cu"
    cu.write_text(instrumented_source())
    lib = out / "lstm_scan_fwd_phases.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-I", str(_build.CSRC), "-o", str(lib), str(cu)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.autovc_scan_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.autovc_scan_prof.restype = ctypes.c_int
    return dll


def main() -> None:
    dev = torch.device("cuda")
    dll = build()
    _build._loaded["lstm_scan_fwd"] = dll  # the wrapper launches the instrumented copy
    mhz = sm_clock_mhz()
    print(f"card: {card()}; largest SM clock {mhz:.0f} MHz", flush=True)
    prof = np.zeros((MAX_BLOCKS, SLOTS), dtype=np.int64)
    card_plan = lstm_ops.scan_plan
    for b, t, hidden, sms in CASES:
        rng = np.random.RandomState(hidden)
        x = torch.from_numpy((rng.randn(b, t, 4 * hidden) * 0.5).astype(np.float32)).to(dev).bfloat16()
        lim = 1.0 / np.sqrt(hidden)
        w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).bfloat16()
        plan = card_plan(b, hidden, sms or lstm_ops._card_sms(0))
        lstm_ops.scan_plan = lambda *_, plan=plan: plan  # the wrapper launches this plan
        lstm_ops.lstm_scan_forward_cuda(x, w)  # warm
        torch.cuda.synchronize()
        if dll.autovc_scan_prof(None, 1) != 0:
            raise RuntimeError("could not zero the stamps")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lstm_ops.lstm_scan_forward_cuda(x, w)
        end.record()
        torch.cuda.synchronize()
        if dll.autovc_scan_prof(prof.ctypes.data, 0) != 0:
            raise RuntimeError("could not read the stamps")
        names = PARTS[plan.regime]
        per_step = prof[:plan.blocks, :len(names)] / t
        ms = start.elapsed_time(end)
        parts = {n: {"mean": float(per_step[:, i].mean()), "max": float(per_step[:, i].max())}
                 for i, n in enumerate(names)}
        total = sum(v["mean"] for v in parts.values())
        us = ms / t * 1e3
        print(json.dumps({"B": b, "T": t, "H": hidden, "plan": plan.__dict__, "cycles_a_step": parts,
                          "sum_cycles": total, "kernel_us_a_step": us, "cycles_per_us": total / us}), flush=True)


if __name__ == "__main__":
    main()
