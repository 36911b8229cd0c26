"""Where a WaveNet generation call's time goes, on the card: an instrumented
copy of ``autovc_tpu_torch/ops/csrc/wavenet_gen.cu`` in which block 0's
thread 0 reads the global timer at the segments of each phase, and three
copies that each leave one part out (their waveforms are wrong; only their
time is read) to attribute it:

    nosync   the grid barriers replaced by block barriers
    nodot    the lanes' products skipped (the reductions kept)
    nostage  the staging of a phase's first batch tile skipped

    python3 scripts/wavenet_phases.py [--batches 1 8] [--samples 256] [--variants base nosync nodot nostage]

Prints, for each variant and B, the wall time of one warm call and the
microseconds a sample of each segment (full width, seeded weights): the
start of a phase (its weight copy issued; at a sample's first phase also
the previous sample's last2 and sampling), the wait for its weight slot,
the phases, their grid barriers, last1 and its barrier.
Needs a CUDA card and ``nvcc``; builds under ``build/wavenet_phases/``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from autovc_tpu_torch.config import WaveNetConfig  # noqa: E402
from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import wavenet as wavenet_ops  # noqa: E402
from autovc_tpu_torch.vocoder import WaveNetVocoder  # noqa: E402

CSRC = ROOT / "autovc_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "wavenet_phases"
# segment 0 also holds the head's last2 and sampling, which end a sample
SEGMENTS = ("phase start", "weight wait", "phase", "phase barrier", "head1", "head1 barrier")


def instrumented(src: str) -> str:
    """The kernel with MARK(i) adding the time since the last mark to
    segment i, and an exported ``prof_read`` to copy the sums out."""
    def sub(old: str, new: str, count: int = 1) -> str:
        if src.count(old) != count:
            raise SystemExit(f"wavenet_gen.cu changed: {old!r} found {src.count(old)} times, not {count}")
        return src.replace(old, new)

    src = sub("namespace cg = cooperative_groups;", """namespace cg = cooperative_groups;
__device__ unsigned long long g_prof[8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define MARK(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { const unsigned long long n_ = gtime(); \\
  prof[i] += n_ - last_t; last_t = n_; } } while (0)""")
    src = sub("  for (int t = 0; t < a.T; ++t) {",
              "  unsigned long long prof[8] = {}, last_t = gtime();\n  for (int t = 0; t < a.T; ++t) {")
    src = sub("      mbar_wait(&wbar[q]", "      MARK(0);\n      mbar_wait(&wbar[q]")
    src = sub("      const float* wg = smem + q * Y.slot;",
              "      MARK(1);\n      const float* wg = smem + q * Y.slot;")
    first, second, rest = src.split("grid.sync();")
    src = first + "MARK(2); grid.sync(); MARK(3);" + second + "MARK(4); grid.sync(); MARK(5);" + rest
    src = sub("\n}\n\n}  // namespace", """
  MARK(6);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) g_prof[i] = prof[i];
}

}  // namespace
extern "C" void prof_read(unsigned long long* out) { cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }""")
    return src


def variants(src: str) -> dict[str, str]:
    cut = {
        "nosync": ("grid.sync();", "__syncthreads();"),
        "nodot": ("  for (int k = threadIdx.x; k < n; k += NT) {", "  for (int k = n; k < n; k += NT) {"),
        "nostage": ("  fetch(v, n / 4, 0, B, src);\n  put(xs, n, v);", "  (void)v;"),
    }
    out = {"base": src}
    for name, (old, new) in cut.items():
        if old not in src:
            raise SystemExit(f"wavenet_gen.cu changed: {name} cannot be made")
        out[name] = src.replace(old, new)
    return out


def build(names: dict[str, str]) -> dict[str, ctypes.CDLL]:
    nvcc = _build.find_nvcc()
    procs = {}
    for name, code in names.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wavenet_gen.cu").write_text(code)
        (d / "coop.cuh").write_text((CSRC / "coop.cuh").read_text())
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "wavenet_gen.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = lib.autovc_wavenet_gen
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.autovc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.autovc_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--variants", nargs="+", default=["base", "nosync", "nodot", "nostage"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wavenet_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build({k: v for k, v in variants(instrumented((CSRC / "wavenet_gen.cu").read_text())).items()
                  if k in args.variants})
    dev, cfg = torch.device("cuda"), WaveNetConfig()
    frames = -(-args.samples // cfg.hop_size)
    for name, lib in libs.items():
        wavenet_ops._library = lambda lib=lib: lib
        for b in args.batches:
            voc = WaveNetVocoder(cfg, device=dev, seed=b)
            mel = torch.from_numpy(np.random.RandomState(b).rand(b, frames, 80).astype(np.float32)).to(dev)
            with torch.inference_mode():
                cond = voc.model.upsample_conditioning(mel)
                u = voc.uniforms(b, cond.shape[1], torch.Generator().manual_seed(b))
                wavenet_ops.generate(voc.packed, cfg.dilations(), cond, u)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                wavenet_ops.generate(voc.packed, cfg.dilations(), cond, u)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            sums = (ctypes.c_ulonglong * 8)()
            lib.prof_read(sums)
            t = cond.shape[1]
            print(f"{name} B={b} T={t}: {wall / t * 1e6:.1f} us a sample wall; "
                  + ", ".join(f"{seg} {sums[i] / t / 1e3:.2f}" for i, seg in enumerate(SEGMENTS))
                  + f" (us a sample, block 0) (card: {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
