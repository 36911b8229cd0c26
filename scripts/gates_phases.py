"""Where the bf16 backward's gate-recompute kernel (``ops.lstm.lstm_gates_cuda``,
``autovc_tpu_torch/ops/csrc/lstm_gates.cu``) spends its time, on the card:
an instrumented copy built under ``build/gates_phases/`` in which each
block's first thread reads the SM clock at the kernel's start, when the
first stage has landed, when the product is done, when the accumulators are
in shared memory, when xproj's tile is there, and at the end:

    python3 scripts/gates_phases.py

At the training shapes (B=7, T=128; H = 32, 512, 1024, the generator's
widths) prints the cycles of each phase (mean and largest over the blocks),
the spread of the blocks' starts and the kernel's span, and the clock rate
nvidia-smi reports. The kernel's times, bound and ``torch.matmul``'s are
phase 8a of ``chip_smoke.py``. Needs a CUDA card and ``nvcc``.
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

HIDDEN, B, T = (32, 512, 1024), 7, 128


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def inputs(hidden: int, dev: torch.device):
    rng = np.random.RandomState(hidden)
    x = torch.from_numpy((rng.randn(B, T, 4 * hidden) * 0.5).astype(np.float32)).to(dev).bfloat16()
    lim = 1.0 / np.sqrt(hidden)
    w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).bfloat16()
    h = torch.from_numpy((rng.randn(B, T, hidden) * 0.3).astype(np.float32)).to(dev).bfloat16()
    h0 = torch.from_numpy((rng.randn(B, hidden) * 0.5).astype(np.float32)).to(dev)
    return x, w, h, h0


def phases() -> None:
    """The instrumented copy's clock stamps (see the module's notes)."""
    src = (_build.CSRC / "lstm_gates.cu").read_text()
    stamps = [
        ("  const int tid = threadIdx.x;\n", "  const long long T0 = clock64();\n"),
        ("    bar_wait(&full[s], (ks / S) & 1);\n", "    if (ks == 0) T1 = clock64();\n"),
        ("  __shared__ float h0s[SPLIT][NCOL];\n", "  const long long T2 = clock64();\n"),
        ("  bar_wait(x_full, 0);\n", "  const long long T4 = clock64();\n"),
    ]
    for anchor, stamp in stamps:
        if src.count(anchor) != 1:
            raise SystemExit(f"the kernel's source changed: {anchor!r} not found once")
        src = src.replace(anchor, anchor + stamp if "T2" not in stamp else stamp + anchor)
    src = src.replace("  for (int ks = 0; ks < nk; ++ks) {\n    const int s = ks % S;\n",
                      "  long long T1 = 0;\n  for (int ks = 0; ks < nk; ++ks) {\n    const int s = ks % S;\n", 1)
    src = src.replace("  bar_wait(x_full, 0);\n", "  const long long T3 = clock64();\n  bar_wait(x_full, 0);\n", 1)
    end = src.index("}\n\n// cuTensorMapEncodeTiled")
    src = (src[:end] + "  if (tid == 0) {\n    long long* d = g_stamps[blockIdx.y * gridDim.x + blockIdx.x];\n"
           "    d[0] = T0; d[1] = T1; d[2] = T2; d[3] = T3; d[4] = T4; d[5] = clock64();\n  }\n" + src[end:])
    src = src.replace("namespace {\n\nusing bf16", "__device__ long long g_stamps[4096][6];\n\nnamespace {\n\nusing bf16", 1)
    src += ('\nextern "C" int gates_stamps(long long* dst) {\n'
            '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n}\n')
    out = _build.BUILD_DIR.parent / "gates_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "gates.cu").write_text(src)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(out / "gates.so"),
                    str(out / "gates.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "gates.so"))
    lib.autovc_lstm_gates.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.gates_stamps.argtypes = [ctypes.c_void_p]
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    names = ("first stage landed", "product done", "accumulators staged", "xproj tile there", "end")
    for hidden in HIDDEN:
        x, w, h, _ = inputs(hidden, dev)
        act = torch.empty(B, T, 4 * hidden, device=dev)
        plan = lstm_ops.gates_plan(B, T, hidden)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            err = lib.autovc_lstm_gates(x.data_ptr(), w.data_ptr(), None, h.data_ptr(), act.data_ptr(), B, T, hidden,
                                        0, plan.nsub, stream)
            if err:
                raise SystemExit(f"the instrumented kernel returned {err}")
        torch.cuda.synchronize()
        d = np.zeros((4096, 6), dtype=np.int64)
        if lib.gates_stamps(d.ctypes.data):
            raise SystemExit("could not read the stamps")
        d = d[:plan.blocks]
        rel = d[:, 1:] - d[:, :-1]
        print(json.dumps({"H": hidden, "plan": str(plan), "sm_clocks_mhz (now, max)": clocks,
                          "cycles (mean, max over blocks)": {n: [float(rel[:, i].mean()), int(rel[:, i].max())]
                                                              for i, n in enumerate(names)},
                          "block starts spread": int(d[:, 0].max() - d[:, 0].min()),
                          "kernel span": int(d[:, 5].max() - d[:, 0].min())}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gates_phases: no CUDA device")
    print(card(), flush=True)
    phases()


if __name__ == "__main__":
    main()
