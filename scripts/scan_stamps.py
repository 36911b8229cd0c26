"""Clock stamps for the scan kernels' phase scripts (``scan_fwd_phases.py``,
``scan_bwd_phases.py``, ``scan_dw_phases.py``): an instrumented copy of a
kernel's source in which each block's first thread adds the SM-clock cycles
of the parts of its walk into ``g_prof[block][part]``, built with the
package's ``nvcc`` flags under ``build/<name>/`` and bound with ``ctypes``;
one stamped call of a wrapper on it; the card's name, power limit and
largest SM clock. Imported by those scripts, not run alone."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Callable

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from autovc_tpu_torch.ops import _build  # noqa: E402


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's largest SM clock (nvidia-smi reads the current one idle)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return float(out)


def instrument(src: str, edits: list[tuple[str, str]], what: str, blocks: int, slots: int) -> str:
    """``src`` with each (old, new) edit made (each ``old`` must be there
    once), the table ``g_prof[blocks][slots]`` declared before its first
    anonymous namespace and ``autovc_prof(out, zero)`` appended: it zeroes
    the table, or copies it to ``out``."""
    for old, new in [("\nnamespace {\n", f"\n__device__ long long g_prof[{blocks}][{slots}];\n\nnamespace {{\n")] + edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{what} has changed: the stamp anchor {old!r} is not there once")
        src = src.replace(old, new)
    return src + f"""
extern "C" int autovc_prof(long long* out, int zero) {{
  if (zero) {{
    static long long z[{blocks}][{slots}] = {{}};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}}
"""


def build(text: str, name: str) -> ctypes.CDLL:
    """``text`` compiled with the package's flags (without ptxas' report)
    into ``build/<name>/<name>.so`` and loaded."""
    out = ROOT / "build" / name
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-I", str(_build.CSRC), "-o", str(lib), str(cu)], check=True)
    dll = ctypes.CDLL(str(lib))
    if hasattr(dll, "autovc_prof"):
        dll.autovc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
        dll.autovc_prof.restype = ctypes.c_int
    return dll


def stamped(dll: ctypes.CDLL, run: Callable[[], object], blocks: int, slots: int) -> tuple[np.ndarray, float]:
    """One warm call of ``run`` (a wrapper launching the instrumented copy),
    then one stamped: its table (blocks x slots cycles) and its ms by CUDA
    events."""
    run()
    torch.cuda.synchronize()
    if dll.autovc_prof(None, 1) != 0:
        raise RuntimeError("could not zero the stamps")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    prof = np.zeros((blocks, slots), dtype=np.int64)
    if dll.autovc_prof(prof.ctypes.data, 0) != 0:
        raise RuntimeError("could not read the stamps")
    return prof, start.elapsed_time(end)


def parts(per_step: np.ndarray, names: tuple[str, ...]) -> dict[str, dict[str, float]]:
    """Each part's cycles a step: the mean over the stamped blocks and the
    slowest block."""
    return {n: {"mean": float(per_step[:, i].mean()), "max": float(per_step[:, i].max())} for i, n in enumerate(names)}
