"""Where the scan dW kernel (``ops.lstm.lstm_scan_weight_grad_cuda``,
``autovc_tpu_torch/ops/csrc/lstm_scan_dw.cu``) spends a step, on the card:
an instrumented copy built under ``build/scan_dw_phases/`` in which each
block's first thread reads the SM clock around the parts of its walk over
the T steps and adds their cycles up:

    python3 scripts/scan_dw_phases.py

The parts: the loads of a step's operands ("load": the wait on the ring's
mbarrier, the barrier that frees a buffer and the next copies' issue), the
product of a step's B-sums ("product") and the rounded add of each B-sum to
its accumulator ("rounded_add"). The product and the rounded add
interleave, so "product" is read from a second copy whose rounded add is an
integer xor, and "rounded_add" is the difference. At B=7, T=128 (the
Generator's training batch) and H = 32, 512, 1024, forward, it prints for
each part its cycles a step (mean over the blocks and the slowest block),
their sum against the kernel's time a step (CUDA events), the card's
largest SM clock, and the latency bound: T times one rounded add's
dependent chain, in cycles of a chain of 4096 of them timed alone (one
add.rn.bf16x2, and for comparison a float32 add with a packing
conversion). The kernel's gates and times are ``chip_smoke.py`` 10b's.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

import scan_stamps
from autovc_tpu_torch.ops import _build
from autovc_tpu_torch.ops import lstm as lstm_ops

CASES = [(7, 128, 32), (7, 128, 512), (7, 128, 1024)]
PARTS = ("load", "product", "rounded_add")
MAX_BLOCKS, SLOTS = 4096, 4
STORE = ("if (threadIdx.x == 0) {{ const int bid = blockIdx.x + gridDim.x * blockIdx.y; "
         "g_prof[bid][0] += {load}; g_prof[bid][1] += {prod}; g_prof[bid][2] += {add}; g_prof[bid][3] += {n}; }}")
# the step's cycles go to "product"; a second copy whose rounded add is an
# integer xor (ROUND_FREE) gives the product alone
EDITS = [
    ("    mbar_wait(bar + (c & 1), (c >> 1) & 1);  // chunk c in its buffer\n",
     "    const long long T0 = clock64();\n    mbar_wait(bar + (c & 1), (c >> 1) & 1);  // chunk c in its buffer\n"
     "    const long long T1 = clock64();\n"),
    ("    __syncthreads();  // buffer c % 2 read by every thread\n"
     "    if (threadIdx.x < 32 && c + 2 < nchunks) issue(c + 2);\n",
     "    const long long T2 = clock64();\n    __syncthreads();  // buffer c % 2 read by every thread\n"
     "    if (threadIdx.x < 32 && c + 2 < nchunks) issue(c + 2);\n    "
     + STORE.format(load="T1 - T0 + clock64() - T2", prod="T2 - T1", add="0", n="ns") + "\n"),
]
ROUND_FREE = ('  asm("add.rn.bf16x2 %0, %0, %1;\\n" : "+r"(acc) : "r"(*reinterpret_cast<const unsigned*>(&p)));\n',
              "  acc ^= __float_as_uint(lo) ^ __float_as_uint(hi);\n")

# the dependent chain of one rounded add, each design's: acc = rb(acc + p)
# (float32 add, a packing conversion) and acc = add.rn.bf16x2(acc, p)
CHAIN_SRC = r"""
#include <cuda_bf16.h>
__global__ void chain_kernel(unsigned* out, long long* cycles, int n, unsigned p, float pf) {
  unsigned acc = 0x3f803f80u;
  float facc = 1.0f;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) asm volatile("add.rn.bf16x2 %0, %0, %1;\n" : "+r"(acc) : "r"(p));
  long long t1 = clock64();
  for (int i = 0; i < n; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(0.0f, facc + pf);
    facc = __uint_as_float(*reinterpret_cast<const unsigned*>(&v));
  }
  long long t2 = clock64();
  out[0] = acc ^ __float_as_uint(facc);
  cycles[0] = t1 - t0;
  cycles[1] = t2 - t1;
}
extern "C" int chain_cycles(long long* host, int n) {
  unsigned* out; long long* cyc;
  cudaMalloc(&out, 4); cudaMalloc(&cyc, 16);
  chain_kernel<<<1, 1>>>(out, cyc, n, 0x3b803b80u, 0x1p-8f);
  const int err = (int)cudaMemcpy(host, cyc, 16, cudaMemcpyDeviceToHost);
  cudaFree(out); cudaFree(cyc);
  return err;
}
"""


def chain_cycles(n: int = 4096) -> dict[str, float]:
    """Cycles of one rounded add in a dependent chain of n."""
    dll = scan_stamps.build(CHAIN_SRC, "rounded_add_chain")
    dll.chain_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.chain_cycles.restype = ctypes.c_int
    out = np.zeros(2, dtype=np.int64)
    if dll.chain_cycles(out.ctypes.data, n) != 0:
        raise RuntimeError("the chain kernel failed")
    return {"add.rn.bf16x2": float(out[0]) / n, "float32 add + rb": float(out[1]) / n}


def per_step(dll, h_seq: torch.Tensor, dx: torch.Tensor) -> tuple[np.ndarray, float]:
    """One stamped call on the instrumented copy ``dll``: each stamped
    block's (load, product, rounded add) cycles a step, and its events us."""
    _build._loaded["lstm_scan_dw"] = dll  # the wrapper launches the instrumented copy
    prof, ms = scan_stamps.stamped(dll, lambda: lstm_ops.lstm_scan_weight_grad_cuda(h_seq, None, dx),
                                   MAX_BLOCKS, SLOTS)
    used = prof[prof[:, 3] > 0]
    return used[:, :3] / used[:, 3:4].astype(np.float64), ms * 1e3


def main() -> None:
    dev = torch.device("cuda")
    source = _build.CSRC / "lstm_scan_dw.cu"
    src = source.read_text()
    dll = scan_stamps.build(scan_stamps.instrument(src, EDITS, source.name, MAX_BLOCKS, SLOTS), "scan_dw_phases")
    free = scan_stamps.build(scan_stamps.instrument(src, EDITS + [ROUND_FREE], source.name, MAX_BLOCKS, SLOTS),
                             "scan_dw_phases_round_free")
    mhz = scan_stamps.sm_clock_mhz()
    chain = chain_cycles()
    print(f"card: {scan_stamps.card()}; largest SM clock {mhz:.0f} MHz; a rounded add's dependent chain, cycles: "
          f"{json.dumps(chain)}", flush=True)
    for b, t, hidden in CASES:
        rng = np.random.RandomState(hidden)
        h_seq = torch.from_numpy(rng.randn(b, t, hidden).astype(np.float32) * 0.3).to(dev).bfloat16()
        dx = torch.from_numpy(rng.randn(b, t, 4 * hidden).astype(np.float32) * 0.1).to(dev).bfloat16()
        steps, us = per_step(dll, h_seq, dx)
        alone, _ = per_step(free, h_seq, dx)  # the product alone; the rounded add the rest
        steps[:, 2] = steps[:, 1] - alone[:, 1]
        steps[:, 1] = alone[:, 1]
        parts = scan_stamps.parts(steps, PARTS)
        print(json.dumps({"B": b, "T": t, "H": hidden, "blocks_stamped": len(steps), "cycles_a_step": parts,
                          "sum_cycles_a_step": sum(v["mean"] for v in parts.values()), "kernel_us": us,
                          "kernel_cycles_at_max_clock": us * mhz,
                          "latency_bound_us": t * chain["add.rn.bf16x2"] / mhz}), flush=True)


if __name__ == "__main__":
    main()
