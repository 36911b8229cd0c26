"""ctypes bindings of the native runtime (``loader.cc``).

The library is built at first use with ``g++`` into ``build/runtime/`` at
the root of the checkout (git-ignored), under a name keyed by a hash of the
source and the flags; the build writes a temporary file and renames it, so
processes building at once never load a half-written library.
``native_available()`` is False where no ``g++`` builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libautovc_runtime-{digest}.so"


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.avc_read_wavs.restype = ctypes.c_int64
    lib.avc_store_create.restype = ctypes.c_void_p
    lib.avc_store_rows.restype = ctypes.c_int64
    lib.avc_store_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.avc_store_cols.restype = ctypes.c_int64
    lib.avc_store_cols.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.avc_store_destroy.argtypes = [ctypes.c_void_p]
    lib.avc_store_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.avc_store_data.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library loads (built now if it was not)."""
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native runtime did not build (g++ on {SOURCE})")
    return lib


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_wavs(paths: Sequence[str], max_len: int, threads: int = 8) -> tuple[np.ndarray, np.ndarray, int]:
    """Decode 16-bit PCM WAVs in parallel -> (out (N, max_len) float32 with
    zeros past each file's end, lengths (N,) int64 (0: the file did not
    decode), the number decoded)."""
    lib = _lib_or_raise()
    n = len(paths)
    out = np.zeros((n, max_len), np.float32)
    lengths = np.zeros((n,), np.int64)
    ok = lib.avc_read_wavs(_paths_array(paths), ctypes.c_int64(n), _ptr(out, ctypes.c_float),
                           ctypes.c_int64(max_len), _ptr(lengths, ctypes.c_int64), ctypes.c_int(threads))
    return out, lengths, int(ok)


class FeatureStore:
    """Resident float32 feature buffers read by the native loader, and
    batches packed from them."""

    def __init__(self):
        self._lib = _lib_or_raise()
        self._store = self._lib.avc_store_create()

    def load_npy_batch(self, paths: Sequence[str], threads: int = 8) -> np.ndarray:
        """Read ``.npy`` files (float32, C order, 1-D or 2-D) in parallel ->
        their ids in the store (-1 where a file was not read)."""
        ids = np.zeros((len(paths),), np.int64)
        self._lib.avc_store_load_npy_batch(ctypes.c_void_p(self._store), _paths_array(paths),
                                           ctypes.c_int64(len(paths)), _ptr(ids, ctypes.c_int64),
                                           ctypes.c_int(threads))
        return ids

    def rows(self, idx: int) -> int:
        return int(self._lib.avc_store_rows(ctypes.c_void_p(self._store), ctypes.c_int64(idx)))

    def cols(self, idx: int) -> int:
        return int(self._lib.avc_store_cols(ctypes.c_void_p(self._store), ctypes.c_int64(idx)))

    def view(self, idx: int) -> np.ndarray:
        """A read-only (rows, cols) view of a resident buffer, without a copy
        (take views after the last load: a load may move the buffers)."""
        ptr = self._lib.avc_store_data(ctypes.c_void_p(self._store), ctypes.c_int64(idx))
        arr = np.ctypeslib.as_array(ptr, shape=(self.rows(idx), self.cols(idx)))
        arr.flags.writeable = False
        return arr

    def pack(self, ids: np.ndarray, offsets: np.ndarray, len_crop: int, threads: int = 4) -> np.ndarray:
        """Crops of ``len_crop`` rows from ``offsets`` of the buffers ``ids``
        -> (B, len_crop, cols) float32, zero-padded past a buffer's end."""
        ids = np.ascontiguousarray(ids, np.int64)
        offsets = np.ascontiguousarray(offsets, np.int64)
        out = np.empty((ids.shape[0], len_crop, self.cols(int(ids[0]))), np.float32)
        self._lib.avc_store_pack(ctypes.c_void_p(self._store), _ptr(ids, ctypes.c_int64),
                                 _ptr(offsets, ctypes.c_int64), ctypes.c_int64(ids.shape[0]),
                                 ctypes.c_int64(len_crop), _ptr(out, ctypes.c_float), ctypes.c_int(threads))
        return out

    def __del__(self):
        store, lib = getattr(self, "_store", None), getattr(self, "_lib", None)
        if store and lib is not None:
            try:
                lib.avc_store_destroy(ctypes.c_void_p(store))
            except TypeError:  # interpreter shutdown already tore down ctypes
                pass
            self._store = None
