"""Environment diagnostics: `python -m cpg_tpu_torch doctor`.

The counterpart of `cpg_tpu.utils.doctor` for the port on one NVIDIA H100.
A run needs PyTorch built for CUDA, a Hopper card (capability 9.0: the
kernels are built for sm_90a), nvcc to build the kernels and g++ to build
the batch loader, both into `build/` at first use. `doctor` checks each,
one line a check, and probes the card in a subprocess under a timeout (a
wedged driver can hang any in-process CUDA call). It exits 1 when the card,
nvcc or g++ is missing: a CPU-only environment is never reported healthy.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
# run by the probe subprocess: one JSON line about the card
PROBE_CODE = (
    "import json, torch\n"
    "ok = torch.cuda.is_available()\n"
    "n = torch.cuda.device_count() if ok else 0\n"
    "print(json.dumps({'cuda_available': ok, 'torch_cuda': "
    "torch.version.cuda, 'count': n, 'name': torch.cuda.get_device_name(0) "
    "if n else None, 'capability': list(torch.cuda.get_device_capability(0))"
    " if n else None}))\n")


def _check_imports():
    out = {}
    for mod in ("torch", "numpy"):
        try:
            m = __import__(mod)
            out[mod] = getattr(m, "__version__", "ok")
        except ImportError as e:
            out[mod] = f"MISSING ({e})"
    if not out["torch"].startswith("MISSING"):
        import torch

        out["torch_cuda"] = torch.version.cuda or "none (a CPU-only build)"
    return out


def _tool(path, version_args, line):
    """{"path", "version"} of a compiler, or {"path": None} when absent."""
    if not path or not os.path.exists(path):
        return {"path": None}
    r = subprocess.run([path, *version_args], capture_output=True, text=True,
                       timeout=60)
    lines = (r.stdout or r.stderr).strip().splitlines()
    return {"path": path, "version": lines[line] if lines else ""}


def _check_toolchains():
    from ..data.native_loader import cxx_path
    from ..ops._build import nvcc_path

    return {"nvcc": _tool(nvcc_path(), ["--version"], -1),
            "g++": _tool(cxx_path(), ["--version"], 0)}


def _check_build_dir():
    """Whether `build/` (where kernels and the loader are built) takes a
    file."""
    d = ROOT / "build"
    try:
        d.mkdir(exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=d):
            pass
        return {"dir": str(d), "writable": True}
    except OSError as e:
        return {"dir": str(d), "writable": False, "error": str(e)}


def _probe_device(timeout_s: float):
    """The card as a fresh interpreter sees it, killed after `timeout_s`,
    with nvidia-smi's name and power limit."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", PROBE_CODE],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"ok": False, "seconds": round(timeout_s, 1),
                "error": f"the CUDA probe hung for {timeout_s:g} s and was "
                         "killed: the driver or the card is not answering"}
    out = {"seconds": round(time.perf_counter() - t0, 1)}
    if r.returncode != 0:
        return {**out, "ok": False,
                "error": (r.stderr or "").strip()[-400:]}
    out.update(json.loads(r.stdout.strip().splitlines()[-1]))
    if shutil.which("nvidia-smi"):
        try:
            s = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                               timeout=timeout_s)
            out["nvidia_smi"] = s.stdout.strip().splitlines()
        except subprocess.TimeoutExpired:
            out["nvidia_smi"] = f"hung for {timeout_s:g} s"
    else:
        out["nvidia_smi"] = None
    out["ok"] = bool(out["cuda_available"] and out["count"]
                     and out["capability"] == [9, 0])
    if not out["ok"]:
        out["error"] = ("CUDA is not available to torch" if not
                        out["cuda_available"] else
                        f"capability {out['capability']}: the kernels are "
                        "built for sm_90a (a Hopper card, 9.0)")
    return out


def run_doctor(timeout_s: float = 90.0, as_json: bool = False,
               _print=print) -> int:
    data_dir = os.environ.get("CPG_DATA_DIR", "")
    report = {
        "python": sys.executable,
        "imports": _check_imports(),
        "toolchains": _check_toolchains(),
        "build": _check_build_dir(),
        "data_dir": {"env": data_dir,
                     "present": bool(data_dir) and os.path.isdir(data_dir),
                     "note": "synthetic generators are used when unset"},
        "host": {"cpus": os.cpu_count(),
                 "disk_free_gb": round(
                     shutil.disk_usage(os.getcwd()).free / 1e9, 1)},
    }
    problems = [f"missing {k}" for k, v in report["imports"].items()
                if v.startswith("MISSING")]
    if not problems:
        report["device"] = _probe_device(timeout_s)
        if not report["device"]["ok"]:
            problems.append("no usable CUDA card ("
                            + report["device"]["error"] + ")")
    problems += [f"{k} not found" for k, v in report["toolchains"].items()
                 if v["path"] is None]
    if not report["build"]["writable"]:
        problems.append("build/ is not writable")
    report["verdict"] = ("OK" if not problems
                         else "UNHEALTHY: " + "; ".join(problems))
    if as_json:
        _print(json.dumps(report))
    else:
        _print(f"{'python':18} {report['python']}")
        for mod, v in report["imports"].items():
            _print(f"{'import ' + mod:18} {v}")
        for tool, v in report["toolchains"].items():
            _print(f"{tool:18} " + (f"{v['path']} ({v['version']})"
                                    if v["path"] else "NOT FOUND"))
        b = report["build"]
        _print(f"{'build dir':18} {b['dir']} "
               + ("(writable)" if b["writable"] else f"NOT WRITABLE: "
                                                     f"{b['error']}"))
        dd = report["data_dir"]
        _print(f"{'CPG_DATA_DIR':18} "
               + (dd["env"] if dd["present"]
                  else f"{dd['env'] or '(unset)'}: {dd['note']}"))
        if "device" in report:
            d = report["device"]
            _print(f"{'device':18} "
                   + (f"{d['count']} x {d['name']} capability "
                      f"{d['capability']}, nvidia-smi {d['nvidia_smi']} "
                      f"({d['seconds']} s probe)" if d["ok"]
                      else f"FAILED after {d['seconds']} s: {d['error']}"))
        _print(f"{'verdict':18} {report['verdict']}")
    return 0 if not problems else 1
