"""Where the feature kernels' time goes, on the card: instrumented copies of
``autovc_tpu_torch/ops/csrc/sosfilt.cu`` and ``mel_norm.cu`` in which each
block's thread 0 reads the SM clock (``clock64``) at the borders of its
phases, and copies of the sosfilt kernel that each leave one part out
(their outputs are wrong; only their time is read):

    nocompute  phase 1's FMAs and phase 3's cascade skipped (the loads kept)
    nostage    the copies between device and shared memory skipped

    python3 scripts/feature_phases.py [--variants base nocompute nostage]

Prints, for sosfilt at (1, 80036) (a 5-s file with its odd extension) and
(32, 131072), the device time of one pass (torch.profiler) and the mean
cycles a block of phase 1, the carry scan and phase 3; for mel_norm at 311
frames (a 4.97-s file) and 16416 (32 rows of 513), its device time beside
``torch.matmul`` of the projection alone and the mean cycles a block of the
start of the tile copy, the spans and offsets, the wait for the filters'
weights and the tile, the products with the dB step, and the store.
Needs a CUDA card and ``nvcc``; builds under ``build/feature_phases/``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from autovc_tpu_torch.dsp import butter_highpass_sos, mel_filterbank  # noqa: E402
from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import mel as mel_ops  # noqa: E402
from autovc_tpu_torch.ops import sosfilt as sosfilt_ops  # noqa: E402

CSRC = ROOT / "autovc_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "feature_phases"
VARIANTS = {"base": [], "nocompute": ["-DNO_COMPUTE"], "nostage": ["-DNO_STAGE"]}
SOS_PHASES = ("phase 1", "scan", "phase 3")
MEL_PHASES = ("tile copy start", "spans+offsets", "weights+tile wait", "products+dB", "store")


def substitute(src: str, name: str, pairs: list[tuple[str, str]]) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"{name} changed: {old[:60]!r} found {src.count(old)} times, not once")
        src = src.replace(old, new)
    return src + ('\nextern "C" int prof_read(long long* out, int n) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_prof, n * sizeof(long long));\n}\n')


def instrumented_sosfilt() -> str:
    """sosfilt.cu with g_prof[4 b + i] the cycles of phase i of block b."""
    return substitute((CSRC / "sosfilt.cu").read_text(), "sosfilt.cu", [
        ('#include "coop.cuh"', '#include "coop.cuh"\n__device__ long long g_prof[4096];'),
        ("  for (int i = tid; i < levels * N * N; i += threads) pw[i] = powers[i];\n",
         "  const long long t0 = clock64();\n  for (int i = tid; i < levels * N * N; i += threads) pw[i] = powers[i];\n"),
        ("  // phase 2: the carries, a Kogge-Stone scan in float64 over the chunks",
         "  __syncthreads();\n  const long long t1 = clock64();\n"
         "  // phase 2: the carries, a Kogge-Stone scan in float64 over the chunks"),
        ("  // phase 3: the cascade over each chunk from where its predecessor ended:",
         "  const long long t2 = clock64();\n  // phase 3: the cascade over each chunk from where its predecessor ended:"),
        ("    unstage(tile_buf(smem, r, threads, N), yr, L, chunk, r);\n  }\n}",
         "    unstage(tile_buf(smem, r, threads, N), yr, L, chunk, r);\n  }\n  __syncthreads();\n"
         "  if (tid == 0 && b < 1024) {\n    const long long t3 = clock64();\n"
         "    g_prof[4 * b] = t1 - t0;\n    g_prof[4 * b + 1] = t2 - t1;\n    g_prof[4 * b + 2] = t3 - t2;\n  }\n}"),
        ("            e[2 * m2] = fma(gg.x, v, e[2 * m2]);\n            e[2 * m2 + 1] = fma(gg.y, v, e[2 * m2 + 1]);",
         "#ifndef NO_COMPUTE\n            e[2 * m2] = fma(gg.x, v, e[2 * m2]);\n"
         "            e[2 * m2 + 1] = fma(gg.y, v, e[2 * m2 + 1]);\n#else\n"
         "            if (gg.x == 1234.5) e[0] += v;  // keeps the loads\n#endif"),
        ("        if (4 * q + 0 < n) v.x = __double2float_rn(cascade64<S>(v.x, c64, z0, z1));",
         "#ifndef NO_COMPUTE\n        if (4 * q + 0 < n) v.x = __double2float_rn(cascade64<S>(v.x, c64, z0, z1));"),
        ("        if (4 * q + 3 < n) v.w = __double2float_rn(cascade64<S>(v.w, c64, z0, z1));",
         "        if (4 * q + 3 < n) v.w = __double2float_rn(cascade64<S>(v.w, c64, z0, z1));\n#endif"),
        ("                                      int chunk, int r) {",
         "                                      int chunk, int r) {\n#ifdef NO_STAGE\n  cp_async_commit();\n"
         "  return;\n#endif"),
        ("__device__ __forceinline__ void unstage(const float* tile, float* yr, long long L, int chunk, int r) {",
         "__device__ __forceinline__ void unstage(const float* tile, float* yr, long long L, int chunk, int r) {\n"
         "#ifdef NO_STAGE\n  if (threadIdx.x == 0) yr[0] = tile[0];\n  return;\n#endif"),
    ])


def instrumented_mel() -> str:
    """mel_norm.cu with g_prof[5 b + i] the cycles of segment i of block b."""
    return substitute((CSRC / "mel_norm.cu").read_text(), "mel_norm.cu", [
        ('#include "coop.cuh"', '#include "coop.cuh"\n__device__ long long g_prof[8192];'),
        ("  const int rows = T - f0 < TT ? T - f0 : TT;\n",
         "  const int rows = T - f0 < TT ? T - f0 : TT;\n  long long t[6] = {clock64(), 0, 0, 0, 0, 0};\n"),
        ("  // 2. the spans and the packed offsets", "  t[1] = clock64();\n  // 2. the spans and the packed offsets"),
        ("  // 3-4. the filters, a group", "  t[2] = clock64();\n  // 3-4. the filters, a group"),
        ("      tile_in = true;\n    }\n    __syncthreads();\n",
         "      tile_in = true;\n    }\n    __syncthreads();\n    if (!t[3]) t[3] = clock64();\n"),
        ("  // 5. the tile's outputs", "  t[4] = clock64();\n  // 5. the tile's outputs"),
        ("    dst[e] = outs[f * l.mpitch + (e - f * M)];\n  }\n}",
         "    dst[e] = outs[f * l.mpitch + (e - f * M)];\n  }\n  __syncthreads();\n"
         "  if (tid == 0 && blockIdx.x < 1024) {\n    t[5] = clock64();\n"
         "    for (int i = 0; i < 5; ++i) g_prof[5 * blockIdx.x + i] = t[i + 1] - t[i];\n  }\n}"),
    ])


def build(jobs: dict[str, tuple[str, list[str]]]) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in jobs.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", *flags, "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in jobs}


def profile(lib: ctypes.CDLL, blocks: int, width: int) -> np.ndarray:
    buf = (ctypes.c_longlong * (blocks * width))()
    if lib.prof_read(buf, blocks * width):
        raise SystemExit("prof_read failed")
    return np.array(buf).reshape(blocks, width)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("feature_phases: no CUDA device", file=sys.stderr)
        return 1
    jobs = {f"sosfilt_{v}": (instrumented_sosfilt(), VARIANTS[v]) for v in args.variants}
    jobs["mel_norm"] = (instrumented_mel(), [])
    libs = build(jobs)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sos = torch.from_numpy(butter_highpass_sos().astype(np.float32)).to(dev)
    for v in args.variants:
        lib = libs[f"sosfilt_{v}"]
        lib.autovc_sosfilt.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for b, length in ((1, 80_036), (32, 131_072)):
            x = torch.randn(b, length, device=dev)
            zi, y = torch.zeros(b, 3, 2, device=dev), torch.empty_like(x)
            plan = sosfilt_ops.scan_plan(length)
            powers, response = sosfilt_ops._device_tables(sos, plan)

            def launch():
                err = lib.autovc_sosfilt(x.data_ptr(), y.data_ptr(), sos.data_ptr(), zi.data_ptr(),
                                         powers.data_ptr(), response.data_ptr(), b, length, length, 3, plan.chunk,
                                         plan.threads, plan.levels, plan.smem, stream)
                if err:
                    raise SystemExit(f"sosfilt launch failed: {err}")

            us = chip_smoke.device_ms(launch, 20) * 1e3
            cycles = profile(lib, b, 4)[:, :3].mean(axis=0)
            print(f"sosfilt {v} ({b}, {length}), C={plan.chunk}: {us:.2f} us a pass; cycles a block: "
                  + ", ".join(f"{n} {c:.0f}" for n, c in zip(SOS_PHASES, cycles)), flush=True)
    lib = libs["mel_norm"]
    lib.autovc_mel_norm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    basis = torch.from_numpy(np.ascontiguousarray(mel_filterbank())).to(dev)
    basis_t, spans = basis.t().contiguous(), mel_ops.filter_spans(basis)
    for t in (311, 16_416):
        mag, out = torch.rand(t, 513, device=dev) * 10, torch.empty(t, 80, device=dev)
        plan = mel_ops.tile_plan(t, 513, 80)

        def launch():
            err = lib.autovc_mel_norm(mag.data_ptr(), basis_t.data_ptr(), spans.data_ptr(), out.data_ptr(), t, 513,
                                      80, 16.0, -100.0, plan.weights, plan.smem, stream)
            if err:
                raise SystemExit(f"mel launch failed: {err}")

        us = chip_smoke.device_ms(launch, 50) * 1e3
        lib_us = chip_smoke.device_ms(lambda: torch.matmul(mag, basis), 50) * 1e3
        cycles = profile(lib, min(plan.blocks, 1024), 5).mean(axis=0)
        print(f"mel_norm T={t} ({plan.blocks} blocks): {us:.2f} us, torch.matmul {lib_us:.2f} us; cycles a block: "
              + ", ".join(f"{n} {c:.0f}" for n, c in zip(MEL_PHASES, cycles)), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
