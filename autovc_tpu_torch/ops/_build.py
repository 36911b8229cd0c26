"""Build and load the CUDA kernels: plain ``nvcc`` into a shared library with
a C interface, loaded with ``ctypes``.

A library is built at first use into ``build/kernels/`` at the root of the
checkout (git-ignored), under a name keyed by a hash of its source and the
compiler flags, so an edited source is rebuilt and an unchanged one is not.
The build writes a temporary file and renames it, so an interrupted build
leaves no half-written library; ``build`` compiles several sources at once,
one ``nvcc`` each. No PyTorch headers, no
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
# sm_90a, the Hopper-specific target (wgmma), as SASS only: "-arch=sm_90a"
# alone also emits compute_90 PTX, which ptxas refuses for wgmma
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
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
    """Where the library built from ``csrc/<name>.cu`` goes; the key covers
    the headers of ``csrc/`` too."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> None:
    """Build the libraries of ``csrc/<name>.cu`` that are missing, one nvcc
    process per source, all started together."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        try:
            out, _ = proc.communicate(timeout=max(1.0, BUILD_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}.cu:\n{build_log[n]}" for n in failed))


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
