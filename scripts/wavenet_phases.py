"""Where a WaveNet generation call's time goes, on the card: an instrumented
copy of a tree's ``autovc_tpu_torch/ops/csrc/wavenet_gen.cu`` in which block
0's first thread adds the SM-clock cycles of each part of its walk to a
table, and copies that each leave one part out (their waveforms are wrong;
only their time is read) to attribute it:

    nosync    the grid barriers replaced by block barriers
    nodot     the products skipped (the reductions kept)
    nostage   the staging of the activation rows skipped (in the CUDA-core
              forms a phase's first tile, in the redesigned bf16 forms the copies)
    noreduce  the sums across warps (and, in the CUDA-core forms, lanes) skipped

    python3 scripts/wavenet_phases.py [--root TREE] [--dtype float32|bfloat16] [--engine pallas|scan]
        [--batches 1 8 32] [--samples 256] [--variants base nosync nodot nostage noreduce]

The parts, as microseconds a sample at the call's own clock (the stamped
cycles over the kernel's time by CUDA events) and as cycles a sample:

    head2     last2 and the MoL sample that end a sample (the preamble at t=0)
    start     a phase's start: in the CUDA-core forms its weight copy issued; in
              the redesigned bf16 forms its row copies issued (proxy fences,
              TMA boxes) and, at layer 0, the first conv written
    wait      the wait for its weight slot
    stage     staging the activation rows (the redesigned bf16 forms: the wait
              for their copies)
    product   the products (in the CUDA-core forms: a thread's FMA loop)
    reduce    the sums across lanes and warps
    act       activation, rounding and the writes of the phase's outputs
    barrier   the phase's grid barrier
    head1     last1 over the blocks' head columns
    head1bar  its grid barrier

``--root`` instruments and imports another checkout (a parent commit
unpacked with ``git archive``). The hooks and variants are inserted at fixed
anchors of the source, which ships without them: those of the float32
kernel and its CUDA-core helpers (which the bf16 forms also used before
their Hopper redesign, so an older tree's bf16 forms take the same ones),
and those of the redesigned bf16 kernel. Needs a CUDA card and ``nvcc``;
builds under ``build/wavenet_phases/``. Prints one JSON line a (variant, B)
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

OUT = Path(__file__).resolve().parents[1] / "build" / "wavenet_phases"
PARTS = ("head2", "start", "wait", "stage", "product", "reduce", "act", "barrier", "head1", "head1bar")

# Declared after `namespace cg = cooperative_groups;`: the stamps of block 0's
# first thread in shared memory, copied out at the kernel's end.
PRELUDE = """
enum { P_HEAD2, P_START, P_WAIT, P_STAGE, P_PRODUCT, P_REDUCE, P_ACT, P_BARRIER, P_HEAD1, P_HEAD1BAR, P_N };
__device__ long long g_prof[P_N];
__shared__ long long s_prof_[P_N];
__shared__ long long s_last_;
__shared__ int s_on_;
#define STAMP_FIRST (blockIdx.x == 0 && threadIdx.x == 0)
#define STAMP(i) do { if (STAMP_FIRST) { const long long n_ = clock64(); s_prof_[i] += n_ - s_last_; \\
  s_last_ = n_; } } while (0)
#define TD_STAMP(i) do { if (STAMP_FIRST && s_on_) { const long long n_ = clock64(); s_prof_[i] += n_ - s_last_; \\
  s_last_ = n_; } } while (0)
#define STAMP_ON(v) do { if (STAMP_FIRST) s_on_ = (v); } while (0)
#define STAMP_BEGIN() do { if (STAMP_FIRST) { for (int i_ = 0; i_ < P_N; ++i_) s_prof_[i_] = 0; s_on_ = 0; \\
  s_last_ = clock64(); } } while (0)
#define STAMP_END() do { STAMP(P_HEAD2); if (STAMP_FIRST) for (int i_ = 0; i_ < P_N; ++i_) \\
  g_prof[i_] = s_prof_[i_]; } while (0)
template <class... T> __device__ __forceinline__ void no_copy_(T...) {}
"""
EPILOGUE = """
extern "C" int autovc_prof(long long* out) { return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * P_N); }
"""


def _sub(text: str, old: str, new: str, what: str, times: int = 1) -> str:
    if text.count(old) != times:
        raise SystemExit(f"wavenet_gen.cu has changed: {what}: {old!r} found {text.count(old)} times, not {times}")
    return text.replace(old, new)


def _resub(text: str, pattern: str, new: str, what: str, times: int = 1) -> str:
    out, n = re.subn(pattern, new, text)
    if n != times:
        raise SystemExit(f"wavenet_gen.cu has changed: {what}: {pattern!r} found {n} times, not {times}")
    return out


def _kernel_span(src: str, kernel: str) -> tuple[int, int]:
    """The text of the __global__ function ``kernel`` (to its closing brace at column 0)."""
    m = re.search(r"__global__ void __launch_bounds__\(NT, 1\) " + kernel + r"\(", src)
    if m is None:
        raise SystemExit(f"wavenet_gen.cu has changed: no kernel {kernel}")
    return m.start(), src.index("\n}\n", m.start()) + 3


def _head_and_prelude(src: str) -> str:
    """The prelude, and the stamps around emit_sample()'s barrier."""
    src = _sub(src, "namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + PRELUDE, "prelude")
    return _sub(src, "      });\n  grid.sync();\n  phase(", "      });\n  STAMP(P_HEAD1);\n  grid.sync();\n"
                "  STAMP(P_HEAD1BAR);\n  phase(", "emit_sample's barrier")


def anchored(src: str, kernel: str) -> str:
    """Hooks inserted into the CUDA-core helpers phase() and tile_dot(),
    emit_sample() and ``kernel``'s body (the float32 wavenet_kernel, or the
    bf16 form's CUDA-core wavenet_kernel_bf16 of the trees before its
    redesign)."""
    src = _head_and_prelude(src)
    src = _sub(src, "  put(xs, n, v);\n  __syncthreads();\n  for (int b0", "  put(xs, n, v);\n  __syncthreads();\n"
               "  TD_STAMP(P_STAGE);\n  for (int b0", "phase's first staging")
    src = _sub(src, "    body(b0);\n    __syncthreads();\n",
               "    body(b0);\n    __syncthreads();\n    TD_STAMP(P_ACT);\n", "phase's body")
    src = _sub(src, "      put(xs, n, v);\n      __syncthreads();\n    }",
               "      put(xs, n, v);\n      __syncthreads();\n      TD_STAMP(P_STAGE);\n    }", "phase's next tile")
    src = _sub(src, "  if constexpr (V >= 32) {\n    halve",
               "  TD_STAMP(P_PRODUCT);\n  if constexpr (V >= 32) {\n    halve", "tile_dot's loop")
    src = _sub(src, "  __syncthreads();\n}\n\ntemplate <int NC4, class TX, class TW>",
               "  __syncthreads();\n  TD_STAMP(P_REDUCE);\n}\n\ntemplate <int NC4, class TX, class TW>",
               "tile_dot's end")
    lo, hi = _kernel_span(src, kernel)
    body = src[lo:hi]
    body = _sub(body, "cg::grid_group grid = cg::this_grid();\n", "cg::grid_group grid = cg::this_grid();\n"
                "  STAMP_BEGIN();\n", "kernel start")
    body = _sub(body, "    for (int p = 0; p < phases; ++p) {\n", "    STAMP(P_HEAD2);\n"
                "    for (int p = 0; p < phases; ++p) {\n", "sample loop")
    m = re.search(r"\n( *)mbar_wait\(&wbar\[q\][^\n]*\n", body)
    if m is None:
        raise SystemExit("wavenet_gen.cu has changed: no weight wait")
    ind = m.group(1)
    body = (body[:m.start()] + f"\n{ind}STAMP(P_START);" + m.group(0) + f"{ind}STAMP(P_WAIT);\n{ind}STAMP_ON(1);\n"
            + body[m.end():])
    body = _sub(body, "      grid.sync();\n", "      STAMP(P_ACT);\n      grid.sync();\n      STAMP(P_BARRIER);\n",
                "phase barrier")
    body = _sub(body, "    emit_sample(", "    STAMP_ON(0);\n    emit_sample(", "the head")
    body = body[:-3] + "\n  STAMP_END();\n}\n"
    return src[:lo] + body + src[hi:] + EPILOGUE


# The stamps of the redesigned bf16 kernel's body: (anchor, replacement,
# times; a regex where the anchor starts with "re:"), each phase kind's
# parts in turn, the two kinds sharing an anchor where their code does.
BF16_STAMPS = (
    ("  cg::grid_group grid = cg::this_grid();\n", "  cg::grid_group grid = cg::this_grid();\n  STAMP_BEGIN();\n", 1),
    ("    for (int l = 0; l < L; ++l) {\n", "    STAMP(P_HEAD2);\n    for (int l = 0; l < L; ++l) {\n", 1),
    (r"re:( +)if \(b0 == 0\) \{\n( +)(mbar_wait\(&[gr]bar\[q\], par\);\n)",
     r"\1STAMP(P_START);\n\1if (b0 == 0) {\n\2\3\2STAMP(P_WAIT);\n", 2),
    ("          const Rows<NTL> crows(", "          STAMP(P_STAGE);\n          const Rows<NTL> crows(", 1),
    ("          mbar_wait(&zbar, zuse++ & 1u);\n",
     "          mbar_wait(&zbar, zuse++ & 1u);\n          STAMP(P_STAGE);\n", 1),
    ("          __syncthreads();  // every warp done with the staged rows\n",
     "          STAMP(P_PRODUCT);\n          __syncthreads();  // every warp done with the staged rows\n", 1),
    ("          product<NTL>(acc, w, zrows, 0, rlo, rhi, lane);\n",
     "          product<NTL>(acc, w, zrows, 0, rlo, rhi, lane);\n          STAMP(P_PRODUCT);\n", 1),
    (r"re:(ds\[seg\] = gpart\[\(\(NW \+ 3\) \* NTL \+ 4 \* rt \+ seg\) \* 32 \+ lane\];\n"
     r"|v = add4\(v, [gr]part\[\(w8 \* NTL \+ rt\) \* 32 \+ lane\]\);\n)", r"\1            STAMP(P_REDUCE);\n", 3),
    ("          if (b0 + ROWS < B) __syncthreads();",
     "          STAMP(P_ACT);\n          if (b0 + ROWS < B) __syncthreads();", 2),
    ("      grid.sync();\n", "      grid.sync();\n      STAMP(P_BARRIER);\n", 2),
)


def anchored_bf16(src: str) -> str:
    """Hooks inserted into the redesigned bf16 kernel (wavenet_kernel_bf16
    on mma.sync and TMA boxes) and emit_sample()."""
    src = _head_and_prelude(src)
    lo, hi = _kernel_span(src, "wavenet_kernel_bf16")
    body = src[lo:hi]
    for old, new, times in BF16_STAMPS:
        if old.startswith("re:"):
            body = _resub(body, old[3:], new, "a bf16 stamp", times)
        else:
            body = _sub(body, old, new, "a bf16 stamp", times)
    body = body[:-3] + "\n  STAMP_END();\n}\n"
    return src[:lo] + body + src[hi:] + EPILOGUE


# The variants: an edit of the CUDA-core helpers (the float32 kernel, and the
# bf16 forms before their redesign), and edits of the redesigned bf16 kernel
# and its helpers, from LayoutBF to the kernel's end ((regex, replacement,
# times) each).
NOREDUCE_OLD = re.compile(r"  if constexpr \(V >= 32\) \{\n    halve.*?\n  \}\n(?=  __syncthreads\(\);\n  TD_STAMP)",
                          re.S)
VARIANTS = {
    "nodot": (("  for (int k = threadIdx.x; k < n; k += NT) {", "  for (int k = n; k < n; k += NT) {"),
              ((r"(  if constexpr \(NTL == 1\) \{\n    float odd)", r"  hi = lo;\n\1", 1),)),
    "nostage": (("  fetch(v, n / 4, 0, B, src);\n  put(xs, n, v);", "  (void)v;"),
                ((r"tma_load_[34]d\(", "no_copy_(", 5),
                 (r"mbar_expect\((&?\w+), [^;]*\);", r"mbar_expect(\1, 0u);", 3))),
    "noreduce": ((NOREDUCE_OLD, "#pragma unroll\n  for (int i = 0; i < V; ++i)\n"
                  "    if (v[i] == 1.2345e-30f) red[warp] = v[i];\n"),
                 ((r"for \(int w8 = 0; w8 < NW; \+\+w8\)( v = add4|\n +if \(crosses)",
                   r"for (int w8 = 0; w8 < 1; ++w8)\1", 3),)),
}


def variant(src: str, name: str, redesigned: bool) -> str:
    if name == "base":
        return src
    if name == "nosync":
        return src.replace("grid.sync();", "__syncthreads();")
    (old, new), edits = VARIANTS[name]
    if redesigned:
        lo = src.index("struct LayoutBF {")
        hi = _kernel_span(src, "wavenet_kernel_bf16")[1]
        part = src[lo:hi]
        for pattern, repl, times in edits:
            part = _resub(part, pattern, repl, f"variant {name}", times)
        return src[:lo] + part + src[hi:]
    if isinstance(old, re.Pattern):
        if old.search(src):
            return old.sub(new, src, count=1)
    elif old in src:
        return src.replace(old, new)
    raise SystemExit(f"wavenet_gen.cu has changed: variant {name} cannot be made")


def build(root: Path, sources: dict[str, str], flags: list[str]) -> dict[str, ctypes.CDLL]:
    from autovc_tpu_torch.ops import _build

    csrc = root / "autovc_tpu_torch" / "ops" / "csrc"
    procs = {}
    for name, code in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wavenet_gen.cu").write_text(code)
        cmd = [_build.find_nvcc(), *flags, "-I", str(csrc), "-o", str(d / "lib.so"), str(d / "wavenet_gen.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.autovc_prof.argtypes = [ctypes.c_void_p]
        lib.autovc_prof.restype = ctypes.c_int
        libs[name] = lib
    return libs


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose kernel and wrapper are instrumented")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--engine", choices=["pallas", "scan"], default="pallas", help="the bfloat16 rounding")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--variants", nargs="+", default=["base", "nosync", "nodot", "nostage", "noreduce"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wavenet_phases: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from autovc_tpu_torch.config import WaveNetConfig
    from autovc_tpu_torch.ops import _build
    from autovc_tpu_torch.ops import wavenet as wavenet_ops
    from autovc_tpu_torch.vocoder import WaveNetVocoder

    bf16 = args.dtype == "bfloat16"
    scan = bf16 and args.engine == "scan"
    kernel = "wavenet_kernel_bf16" if bf16 else "wavenet_kernel"
    src = (root / "autovc_tpu_torch" / "ops" / "csrc" / "wavenet_gen.cu").read_text()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    redesigned = bf16 and "struct LayoutBF" in src
    base = anchored_bf16(src) if redesigned else anchored(src, kernel)
    tag = f"{'scan' if scan else args.dtype}-{hashlib.sha256(str(root).encode()).hexdigest()[:8]}"
    libs = build(root, {f"{tag}-{v}": variant(base, v, redesigned) for v in args.variants}, flags)
    dev, cfg = torch.device("cuda"), WaveNetConfig()
    frames = -(-args.samples // cfg.hop_size)
    real_load = _build.load
    name = card()
    for (lib_name, lib), var in zip(libs.items(), args.variants):
        _build.load = lambda n, lib=lib: lib if n == "wavenet_gen" else real_load(n)
        for b in args.batches:
            voc = WaveNetVocoder(cfg, device=dev, seed=b)
            mel = torch.from_numpy(np.random.RandomState(b).rand(b, frames, 80).astype(np.float32)).to(dev)
            packed = voc.packed_for(torch.bfloat16 if bf16 else torch.float32)
            with torch.inference_mode():
                cond = voc.model.upsample_conditioning(mel)
                u = voc.uniforms(b, cond.shape[1], torch.Generator().manual_seed(b))
                call = lambda: wavenet_ops.generate(packed, cfg.dilations(), cond, u, cfg.log_scale_min,
                                                    **({"scan": True} if scan else {}))
                call()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            prof = np.zeros(len(PARTS), dtype=np.int64)
            if lib.autovc_prof(prof.ctypes.data) != 0:
                raise SystemExit("could not read the stamps")
            t = cond.shape[1]
            mhz = prof.sum() / (ms * 1e3)  # the call's own clock: its cycles over its time
            plan = wavenet_ops.last_launch[0]
            print(json.dumps({
                "tree": str(root), "form": "scan" if scan else args.dtype, "variant": var, "B": b, "T": t,
                "us_a_sample": ms / t * 1e3, "clock_mhz": mhz,
                "us": {p: float(prof[i]) / t / mhz for i, p in enumerate(PARTS)},
                "cycles": {p: float(prof[i]) / t for i, p in enumerate(PARTS)},
                "plan": {k: getattr(plan, k) for k in plan.__dataclass_fields__}, "card": name}), flush=True)
    _build.load = real_load
    return 0


if __name__ == "__main__":
    sys.exit(main())
