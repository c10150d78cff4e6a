"""The power of `chip_smoke.py`'s train-phase rules, on the card.

Runs `chip_smoke.train_phase` (three steps of task 2: f32 default, bf16
default, bf16 kernels, f32 kernels) with its limits lifted, on sound
kernels for VGG16-BN, vit_cifar and ResNet-50 (the damped state of
`build_state`, and the same state at unit residual BN scales), and on the
damped ResNet-50 with a fault injected at run time into a kernel wrapper:

- `k2_s2_edge`: K2 (`masked_conv.launch_bwd_dx`) zeroes the first row of
  every stride-2 dx;
- `k2_x1.02`: every K2 dx scaled by 1.02;
- `k3_s2_x1.1`: K3 (`masked_conv.launch_bwd_dw`) scales dw and dpm by 1.1
  at stride 2;
- `k3_bf16`: K3's dw and dpm rounded to bf16 (a precision change, not a
  fault: it should pass).

For each run it prints the readings and whether each rule would pass:
the bf16 loss rule (`LOSS_RTOL`), the bf16 update rule (`UPDATE_RATIO` x
the default step's distance from the f32 step), and the f32 update rule
(`F32_UPDATE_RTOL` x the f32 update's norm). The JSON goes to
`chiprun_out/train_controls.json`.

    python3 scripts/torch_train_controls.py     # needs one card and nvcc
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cpg_tpu_torch.ops import _build  # noqa: E402
from cpg_tpu_torch.ops import masked_conv as mc  # noqa: E402

_DX, _DW = mc.launch_bwd_dx, mc.launch_bwd_dw


def k2_s2_edge(g, x, w, own, pm, tid, stride, *rest):
    dx = _DX(g, x, w, own, pm, tid, stride, *rest)
    if stride == 2:
        dx[:, 0] = 0
    return dx


def k2_x102(*args):
    return _DX(*args) * 1.02


def k3_s2_x11(g, x, w, own, tid, stride, padding):
    dw, dpm = _DW(g, x, w, own, tid, stride, padding)
    return (dw * 1.1, dpm * 1.1) if stride == 2 else (dw, dpm)


def k3_bf16(*args):
    dw, dpm = _DW(*args)
    return dw.bfloat16().float(), dpm.bfloat16().float()


FAULTS = {"k2_s2_edge": ("launch_bwd_dx", k2_s2_edge),
          "k2_x1.02": ("launch_bwd_dx", k2_x102),
          "k3_s2_x1.1": ("launch_bwd_dw", k3_s2_x11),
          "k3_bf16": ("launch_bwd_dw", k3_bf16)}


def readings(res, loss_rtol, update_ratio, f32_update_rtol):
    """Each rule's reading and verdict at chip_smoke's limits."""
    dist, norm = res["update_dist_to_f32"], res["f32_update_norm"]
    bf16_ratio = {k: dist["kernels"][k] / dist["default"][k] for k in norm}
    f32_rel = {k: dist["kernels_f32"][k] / norm[k] for k in norm}
    return dict(
        loss_max_rel=res["loss_max_rel"],
        f32_loss_max_rel=res["f32_loss_max_rel"],
        bf16_update_ratio=bf16_ratio, f32_update_rel=f32_rel,
        bf16_loss_rule=res["loss_max_rel"] <= loss_rtol,
        bf16_update_rule=all(v <= update_ratio for v in bf16_ratio.values()),
        f32_update_rule=all(f32_rel[k] <= f32_update_rtol
                            for k in ("shared", "private")))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_controls: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    limits = (cs.LOSS_RTOL, cs.UPDATE_RATIO, cs.F32_UPDATE_RTOL)
    cs.LOSS_RTOL = cs.UPDATE_RATIO = cs.F32_UPDATE_RTOL = float("inf")
    cs.TRAIN_TIMING = {"resnet50": ((cs.RESNET_BATCH,), 1)}
    cs.TRAIN_TIMING_DEFAULT = ((cs.BATCH,), 1)
    counts = cs.Counts()
    out = {"card": cs.card_line()}
    runs = []
    for arch in ("vgg16_bn_cifar", "vit_cifar"):
        runs.append((arch, cs.build_state(torch, dev, arch), None))
    damped = cs.build_state(torch, dev, "resnet50")
    unit = damped.map_arrays(lambda t: t.clone())
    for t in unit.tasks.values():
        for k, v in t.private.items():
            if k.endswith("/bn3/scale"):
                t.private[k] = torch.ones_like(v)
    runs += [("resnet50", damped, None), ("resnet50_unit_bn3", unit, None)]
    runs += [(f"resnet50_{name}", damped, fault)
             for name, fault in FAULTS.items()]
    for name, state, fault in runs:
        if fault:
            setattr(mc, *fault)
        t = time.perf_counter()
        try:
            res, _ = cs.train_phase(torch, dev, state, counts)
        finally:
            mc.launch_bwd_dx, mc.launch_bwd_dw = _DX, _DW
        out[name] = dict(readings(res, *limits), s=time.perf_counter() - t)
        print(name, json.dumps(out[name]), flush=True)
    cs.LOSS_RTOL, cs.UPDATE_RATIO, cs.F32_UPDATE_RTOL = limits
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "train_controls.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
