#!/usr/bin/env python3
"""Where the port's train-step time goes on the card.

    python scripts/torch_train_profile.py
        [--arch vgg16_bn_cifar|vit_cifar|textcls|vit_moe_cifar|resnet50|
                spherenet20] [--batch 256] [--steps 10]

Builds the seeded two-task state of the architecture at width 1.0 with
chip_smoke.py's `build_state` (its input shape, augmentation and draws
from `_arch_io`: 224 px for ResNet-50, 112x96 with flips for SphereNet-20,
64 token ids for textcls; `train_batch` makes the batch),
then for the bf16 train step of task 2 without the kernels (the default
step: effective weights, cuDNN/cuBLAS, autograd) and with them
(chip_smoke.py's `KERNEL_FLAGS`: VGG16-BN and ResNet-50
`use_pallas_conv`, `use_fused_chain`; vit_cifar, textcls and
vit_moe_cifar `use_pallas`, `flash_attention`; SphereNet-20
`use_pallas_conv`, `use_pallas`): times the step (host clock around steps
that end in a synchronize), and profiles the same steps with
torch.profiler: device time by kernel, grouped (the port's kernels,
cuDNN/cuBLAS, elementwise and reductions, optimizer), the device's busy
share (summed kernel time over wall time) and the peak device memory.
Needs one CUDA card. Prints one JSON line and writes it beside
chip_smoke.py's results, as torch_train_profile_<arch>_b<batch>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ARCHS = ("vgg16_bn_cifar", "vit_cifar", "textcls", "vit_moe_cifar",
         "resnet50", "spherenet20")
# kernel-name fragments -> group (first match wins)
GROUPS = (
    ("port kernels", ("masked_conv_fwd_", "fused_chain_fwd_", "cpg::bwd::",
                      "flash_fwd_", "flash_bwd_", "k6::dw_bf16_kernel",
                      "namespace)::gate_kernel", "namespace)::sum_kernel",
                      "namespace)::colsum_kernel",
                      "namespace)::gemm_tn_bf16_kernel",
                      "cpg::gemm::gemm_tn_bf16_kernel",
                      "cpg::gemm::conv_im2col_kernel", "k4::fwd_wgmma_kernel",
                      "namespace)::select_bf16_kernel",
                      "namespace)::wgrad_wgmma_kernel",
                      "namespace)::wgrad_gate_kernel",
                      "namespace)::im2col_bf16_kernel")),
    ("cudnn/cublas", ("cudnn", "conv", "gemm", "xmma", "sm90", "cutlass",
                      "nvjet", "implicit_", "dgrad", "wgrad", "nchw", "nhwc")),
    ("optimizer", ("multi_tensor", "foreach", "_amp_")),
    ("elementwise/reduce", ("elementwise", "reduce", "Reduce", "index",
                            "max_pool", "softmax", "fill", "copy", "where",
                            "cat", "scatter", "gather")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def profile(torch, run, steps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for i in range(3):
        run(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        run(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.reset_peak_memory_stats()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # device-side kernels only: user annotations (the optimizers'
    # `Optimizer.step#...` ranges) span kernels and would count them twice
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    groups = {}
    for k, t, c in rows:
        g = groups.setdefault(group_of(k), [0.0, 0])
        g[0] += t / 1e3 / steps
        g[1] += c / steps
    return {
        "ms_per_step": ms,
        "profiled_wall_ms_per_step": wall * 1e3 / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_busy_share": device_us / 1e6 / wall,
        "kernel_launches_per_step": sum(r[2] for r in rows) / steps,
        "peak_device_mib": peak / 2**20,
        "groups": {k: {"ms_per_step": v[0], "launches_per_step": v[1]}
                   for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": k[:90], "ms_per_step": t / 1e3 / steps,
                         "launches_per_step": c / steps}
                        for k, t, c in rows[:15]],
    }


def train_batch(torch, arch, n, seed=1):
    """(x, y, draws) of one host-side train batch of `arch`: n random
    examples of `chip_smoke._arch_io`'s per-example shape as its `_inputs`
    makes them (uint8 images, int32 token ids), labels below 5, and the
    augmentation's draws."""
    from chip_smoke import _arch_io, _inputs

    shape, _, _, draw_fn, _ = _arch_io(arch)
    gen = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(_inputs(shape, n, np.random.RandomState(seed)))
    y = torch.randint(0, 5, (n,), generator=gen)
    return x, y, draw_fn(n, gen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="vgg16_bn_cifar", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import KERNEL_FLAGS, _arch_io, build_state, card_line
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train.step import TrainConfig, make_train_step

    dev = torch.device("cuda")
    card = card_line()
    state = build_state(torch, dev, args.arch)
    model_fn, _ = get_model(args.arch)
    augment = _arch_io(args.arch)[2]
    x, y, draws = train_batch(torch, args.arch, args.batch)
    x, y = x.to(dev), y.to(dev)
    out = {"card": card, "arch": args.arch, "batch": args.batch,
           "steps": args.steps}
    for label, kernels in (("default", False), ("kernels", True)):
        st = state.map_arrays(lambda t: t.clone())
        task = st.tasks[2]
        step, (opt_w, opt_pm) = make_train_step(
            model_fn, num_classes=5, mult=st.width_mult, has_piggymask=True,
            cfg=TrainConfig(**(KERNEL_FLAGS[args.arch] if kernels else {})),
            augment_fn=augment, model_kwargs=st.forward_kwargs(2),
            device=dev)
        carry = [st.shared, task.piggymask, task.private, task.bn_state,
                 opt_w.init({"shared": st.shared, "private": task.private}),
                 opt_pm.init(task.piggymask)]

        def run(i):
            res = step(*carry, st.ownership, 2, x, y, draws, i)
            carry[:] = res[:6]

        out[label] = profile(torch, run, args.steps)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out",
                           f"torch_train_profile_{args.arch}_b{args.batch}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
