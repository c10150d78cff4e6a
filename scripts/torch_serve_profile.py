#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python scripts/torch_serve_profile.py [--arch vgg16_bn_cifar|vit_cifar]
        [--bucket 256] [--calls 10]

Builds the seeded two-task state of the architecture at width 1.0 with
chip_smoke.py's `build_state`, then for the bf16 `TaskServer` (VGG16-BN:
without and with the fused chain; vit_cifar: the effective-params path,
which runs no port kernel): times `predict` on one bucket (host clock, p50
of the calls), and profiles the same calls with torch.profiler: device
time by kernel and the device's busy share (summed kernel time over wall
time). Needs one CUDA card. Prints one JSON line and writes it to
chiprun_out/torch_serve_profile_<arch>.json.
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


def profile(torch, srv, x, calls):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        srv.predict(2, x)
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        srv.predict(2, x)
        ts.append(time.perf_counter() - t0)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            srv.predict(2, x)
        wall = time.perf_counter() - t0
    # device-side events only (the kernels); host ops repeat their time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    return {
        "p50_ms": float(np.median(ts)) * 1e3,
        "img_per_s": len(x) / float(np.median(ts)),
        "profiled_wall_ms_per_call": wall * 1e3 / calls,
        "device_ms_per_call": device_us / 1e3 / calls,
        "device_busy_share": device_us / 1e6 / wall,
        "top_kernels": [{"name": k[:90], "ms_per_call": t / 1e3 / calls,
                         "launches_per_call": c / calls}
                        for k, t, c in rows[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="vgg16_bn_cifar",
                    choices=("vgg16_bn_cifar", "vit_cifar"))
    ap.add_argument("--bucket", type=int, default=256)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess
    from chip_smoke import build_state, card_line
    from cpg_tpu_torch.serve import TaskServer

    dev = torch.device("cuda")
    card = card_line()
    state = build_state(torch, dev, args.arch)
    x = np.random.RandomState(1).randint(
        0, 256, (args.bucket, 32, 32, 3)).astype(np.uint8)
    out = {"card": card, "arch": args.arch, "bucket": args.bucket,
           "calls": args.calls}
    for fused in (False, True) if args.arch == "vgg16_bn_cifar" else (False,):
        srv = TaskServer(state, cifar_eval_preprocess,
                         compute_dtype=torch.bfloat16, fused_chain=fused,
                         min_bucket=args.bucket, device=dev)
        out["fused" if fused else "unfused"] = profile(torch, srv, x, args.calls)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out",
                           f"torch_serve_profile_{args.arch}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
