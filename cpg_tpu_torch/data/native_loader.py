"""ctypes wrapper over the native prefetching batch loader (native/loader.cc).

The counterpart of `cpg_tpu.data.native_loader`, over the same C source and
C API: a C++ prefetch thread assembles shuffled uint8 batches into
contiguous buffers while the card computes, reading the arrays through the
borrowed pointer (a memmap is paged in on demand, never copied whole).
Epochs wrap inside the loader: it reshuffles when its cursor passes the
last row, so the order does not depend on the caller's epoch length.

The library is built at first use with g++ (the flags of native/Makefile)
into `build/native/libcpgloader-<hash>.so` at the repository root, the hash
covering the source and the flags; nothing is written under `native/`. A
failed build raises with the compiler's output: there is no NumPy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "loader.cc"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def cxx_path() -> Optional[str]:
    """The C++ compiler the loader is built with (g++ on PATH), or None."""
    return shutil.which("g++")


def lib_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcpgloader-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the loader unless it is built; returns the library's path.
    Several processes may build at once: each writes its own temporary
    file and renames it into place."""
    out = lib_path()
    if out.exists():
        return out
    cxx = cxx_path()
    if cxx is None:
        raise RuntimeError("native loader: g++ not found on PATH; it builds "
                           f"{SOURCE} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"native loader: {cxx} exited {r.returncode} "
                           f"building {SOURCE}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cpg_loader_create.restype = ctypes.c_void_p
            lib.cpg_loader_create.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_int]
            lib.cpg_loader_next.restype = ctypes.c_int
            lib.cpg_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p]
            lib.cpg_loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class NativeBatcher:
    """Prefetching batch iterator over (x uint8 (N, ...), y int32 (N,)),
    in memory or memory-mapped."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 seed: int = 0, shuffle: bool = True, capacity: int = 3):
        if x.dtype != np.uint8 or x.ndim < 2:
            raise ValueError(f"NativeBatcher: x must be uint8 (N, ...), got "
                             f"{x.dtype} {x.shape}")
        # a memmap stays a memmap: only a non-contiguous array is copied
        self.x = x if x.flags["C_CONTIGUOUS"] else np.ascontiguousarray(x)
        y = y if y.dtype == np.int32 else y.astype(np.int32)
        self.y = y if y.flags["C_CONTIGUOUS"] else np.ascontiguousarray(y)
        self.batch_size, self.seed, self.shuffle = batch_size, seed, shuffle
        self.item_shape = x.shape[1:]
        self._lib = _load_lib()
        self._h = self._lib.cpg_loader_create(
            self.x.ctypes.data_as(ctypes.c_void_p),
            self.y.ctypes.data_as(ctypes.c_void_p), len(self.x),
            int(np.prod(self.item_shape)), batch_size, capacity, seed,
            1 if shuffle else 0)
        if not self._h:
            raise RuntimeError("cpg_loader_create failed")
        self._bx = np.empty((batch_size, *self.item_shape), np.uint8)
        self._by = np.empty((batch_size,), np.int32)

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        rc = self._lib.cpg_loader_next(
            self._h, self._bx.ctypes.data_as(ctypes.c_void_p),
            self._by.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"cpg_loader_next rc={rc}")
        # copies, so that a caller may hold batches across next() calls
        return self._bx.copy(), self._by.copy()

    def batches(self, steps: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(steps):
            yield self.next()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.cpg_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
