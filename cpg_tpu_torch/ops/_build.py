"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (device pointers, ints and the
stream in; `cudaGetLastError()` out), so it compiles with nvcc alone, without
PyTorch's headers, into `build/cuda/lib<name>-<hash>.so` at the repository
root, and loads with ctypes. The hash covers the source and the shared
headers, so an edited kernel is rebuilt and a built one is reused. All missing
libraries compile in parallel, one nvcc process each. Nothing here runs at
import: the first kernel launch (or `build_all()`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
KERNELS = ("masked_conv_fwd", "masked_conv_stem", "masked_conv_bwd_dx",
           "masked_conv_bwd_dw",
           "fused_chain_fwd", "fused_chain_bwd_dx", "fused_chain_bwd_dw",
           "flash_fwd", "flash_bwd", "flash_bwd_wgmma", "masked_matmul",
           "masked_matmul_wgrad")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> Optional[str]:
    """nvcc on PATH, else the CUDA toolkit's default place; None when
    neither exists."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return found if os.path.exists(found) else None


def _nvcc() -> str:
    found = nvcc_path()
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, in parallel.
    Returns the seconds it took; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in KERNELS if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode}) ---\n{log}")
        else:
            if log.strip():
                print(f"[nvcc {name}]\n{log}", flush=True)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed (one
    builder at a time: serving threads may reach a kernel together)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path = _lib_path(name)
                if not path.exists():
                    build_all()
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def launch(fn, t: "torch.Tensor", *args) -> int:
    """`fn(*args, stream)` with `t`'s card current in this thread and its
    current stream last: a launcher runs on the thread's current device
    (runtime state is per host thread), so a thread that launched on one
    card can launch on another. Returns the launcher's CUDA error code."""
    with torch.cuda.device(t.device):
        return fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
