"""Build and load the CUDA kernels: plain ``nvcc`` into a shared library with
a C interface, loaded with ``ctypes``.

A library is built at first use into ``build/kernels/`` at the root of the
checkout (git-ignored), under a name keyed by a hash of its source and the
compiler flags, so an edited source is rebuilt and an unchanged one is not.
The build writes a temporary file and renames it, so an interrupted build
leaves no half-written library. No PyTorch headers, no
``torch.utils.cpp_extension``, no ``ninja``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name -> what nvcc printed (ptxas registers, spills)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found (on PATH or at /usr/local/cuda/bin/nvcc)")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` goes."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if needed."""
    if name in _loaded:
        return _loaded[name]
    out = library_path(name)
    if not out.exists():
        nvcc = find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{build_log[name]}")
        os.replace(tmp, out)
    _loaded[name] = ctypes.CDLL(str(out))
    return _loaded[name]
