"""One roofline model for the port's measuring scripts, on the H100.

The counterpart of `cpg_tpu.utils.roofline`, with the same output keys and
clamping rules and the NVIDIA H100 SXM data-sheet figures in `SPEC`, the
one home of the figures that `chip_smoke.py`'s `bound()` and the kernels'
launch planners read. Conventions:

* Two ceilings: the data sheet (`SPEC`) always, and a measured one when a
  probe file is given (`load_measured(path)`), each reported beside the
  other as `fraction_of_spec_floor` and `fraction_of_measured_floor`.
* Two floors per ceiling: bytes / memory rate and FLOPs / the bf16 tensor
  peak; the binding floor is the larger.
* No fraction above 1.0 is emitted. When the byte floor alone pushes a
  fraction past 1.0, the byte model is flagged (`byte_model_suspect`), the
  fraction is recomputed against the FLOP floor alone and clamped, and the
  raw value is kept under `*_raw`.

`cost_of(fn, *args)` counts FLOPs with PyTorch's `FlopCounterMode`, which
sees aten operators only: a step whose products run the port's own CUDA
kernels (ctypes launches) counts close to nothing. Count the default step
(cuDNN, cuBLAS, SDPA) or the plain versions at the same shapes instead; it
does the same work. `bytes` is None: eager PyTorch has no byte model.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet: HBM3 rate; dense (no sparsity) tensor-core
# peaks for bf16 and int8, and the f32 rate outside the tensor cores
SPEC = {"hbm_gbps": 3350.0, "bf16_tflops": 989.0, "int8_tops": 1979.0,
        "f32_tflops": 67.0}


def load_measured(path: Optional[str] = None) -> Optional[Dict]:
    """Measured ceilings from the probe file at `path` (JSON with
    `hbm.gbps` and `mxu_bf16.tflops`, and optionally `mxu_bf16_trace`, a
    higher rate seen inside a real step, which then wins). Returns
    {"hbm_gbps", "bf16_tflops", "source"}, or None without a path; a
    malformed file raises."""
    if path is None:
        return None
    with open(path) as f:
        d = json.load(f)
    tflops = float(d["mxu_bf16"]["tflops"])
    src = os.path.basename(path)
    tr = d.get("mxu_bf16_trace")
    if tr and float(tr["tflops"]) > tflops:
        tflops = float(tr["tflops"])
        src = f"{src} (mxu from {tr['source']})"
    return {"hbm_gbps": float(d["hbm"]["gbps"]), "bf16_tflops": tflops,
            "source": src}


def cost_of(fn, *args, **kwargs) -> Optional[Dict]:
    """{"bytes": None, "flops"} of one call `fn(*args, **kwargs)`, counted
    by `torch.utils.flop_counter.FlopCounterMode` (forward and, when fn
    runs one, backward operators alike), or None when it counts nothing.
    Kernel launches through ctypes are invisible to it: see the module
    docstring."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return {"bytes": None, "flops": flops} if flops else None


def _floors_ms(cost: Dict, hbm_gbps: float, tflops: float):
    byte_ms = (cost["bytes"] / 1e9 / hbm_gbps * 1e3
               if cost.get("bytes") else 0.0)
    flop_ms = (cost["flops"] / (tflops * 1e12) * 1e3
               if cost.get("flops") else 0.0)
    return byte_ms, flop_ms


def _fraction(step_ms: float, byte_ms: float, flop_ms: float):
    """(fraction <= 1, raw fraction, suspect?): see the module docstring."""
    floor = max(byte_ms, flop_ms)
    if not floor:
        return None, None, False
    raw = floor / step_ms
    if raw <= 1.0:
        return round(raw, 3), round(raw, 3), False
    # the byte floor says the step beat the memory: distrust the bytes and
    # fall back to the FLOP floor, still clamped
    fallback = min(flop_ms / step_ms, 1.0) if flop_ms else 1.0
    return round(fallback, 3), round(raw, 3), True


def roofline(step_ms: float, cost: Optional[Dict],
             measured: Optional[Dict] = None,
             spec: Dict = SPEC) -> Dict:
    """The roofline block of a step that took `step_ms`: always
    `fraction_of_spec_floor` (and `mfu_vs_spec` with FLOPs); with
    `measured` (from `load_measured`) also `fraction_of_measured_floor`.
    Fractions are clamped to <= 1.0, with `byte_model_suspect` and the
    `*_raw` values kept when the byte model overcounted. {} without a cost
    or a time."""
    if not cost or not step_ms:
        return {}
    out = {}
    if cost.get("bytes"):
        out["bytes_per_step_gb"] = round(cost["bytes"] / 1e9, 2)
    if cost.get("flops"):
        out["tflop_per_step"] = round(cost["flops"] / 1e12, 2)
        out["mfu_vs_spec"] = round(
            cost["flops"] / (step_ms * 1e-3) / (spec["bf16_tflops"] * 1e12),
            3)
    byte_ms, flop_ms = _floors_ms(cost, spec["hbm_gbps"],
                                  spec["bf16_tflops"])
    out["spec"] = {"hbm_gbps": spec["hbm_gbps"],
                   "bf16_tflops": spec["bf16_tflops"],
                   "hbm_floor_ms": round(byte_ms, 2),
                   "flop_floor_ms": round(flop_ms, 2),
                   "bound": "mxu" if flop_ms > byte_ms else "hbm"}
    frac, raw, suspect = _fraction(step_ms, byte_ms, flop_ms)
    out["fraction_of_spec_floor"] = frac
    if suspect:
        out["fraction_of_spec_floor_raw"] = raw
    if measured:
        mbyte_ms, mflop_ms = _floors_ms(cost, measured["hbm_gbps"],
                                        measured["bf16_tflops"])
        out["measured"] = {
            "hbm_gbps": measured["hbm_gbps"],
            "bf16_tflops": measured["bf16_tflops"],
            "source": measured.get("source"),
            "hbm_floor_ms": round(mbyte_ms, 2),
            "flop_floor_ms": round(mflop_ms, 2),
            "bound": "mxu" if mflop_ms > mbyte_ms else "hbm"}
        mfrac, mraw, msuspect = _fraction(step_ms, mbyte_ms, mflop_ms)
        out["fraction_of_measured_floor"] = mfrac
        if msuspect:
            out["fraction_of_measured_floor_raw"] = mraw
        suspect = suspect or msuspect
    if suspect:
        out["byte_model_suspect"] = (
            "the byte floor says the step moved its bytes faster than the "
            "memory can: the byte count overstates the traffic (data that "
            "stays in cache or registers), so the fraction is recomputed "
            "against the FLOP floor and clamped (raw kept)")
    return out
