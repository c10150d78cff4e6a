#!/usr/bin/env python3
"""The dense route's TN GEMM under every launch plan, on the card.

    python scripts/torch_dense_gemm_plans.py

For the products of chip_smoke.py's bf16 DENSE_SHAPES (each forward,
C = x @ w_eff with R = K, Nout = N, and each dx, R = N, Nout = K) times
`csrc/masked_matmul.cu`'s GEMM by torch.profiler's device time under each
tile width of `masked_matmul.GEMM_BNS`, at the deepest ring that fits and at
two blocks an SM where two fit, beside `torch.matmul` on the same operands
(cuBLAS) and the plan `masked_matmul.gemm_plan` picks. Every plan's result
is held against the plain version first. This is what `gemm_plan`'s cost
model is checked against. Needs one CUDA card. Prints one JSON line a
product and writes them to chiprun_out/torch_dense_gemm_plans.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

SMEM_PER_SM = 233472  # 228 KB, of which 1 KB is reserved per block


def plans(mm, sms):
    """(bn, stages, grid): per tile width the deepest ring at one block an
    SM, and the deepest at two blocks an SM where two fit."""
    out = []
    for bn in mm.GEMM_BNS:
        for per_sm in (1, 2):
            stages = mm.GEMM_MAX_STAGES
            while stages >= 2 and (
                    mm.gemm_smem_bytes(bn, stages) > mm.SMEM_PER_BLOCK
                    or per_sm * (mm.gemm_smem_bytes(bn, stages) + 1024)
                    > SMEM_PER_SM):
                stages -= 1
            if stages >= 2:
                out.append((bn, stages, per_sm * sms))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_dense_gemm_plans: needs a CUDA card", file=sys.stderr)
        return 1
    from cpg_tpu_torch.ops import masked_matmul as mm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = mm._lib()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(cs.SEED)

    def gemm(a, bt, plan):
        c = torch.empty((a.shape[0], bt.shape[0]), dtype=torch.bfloat16,
                        device=dev)
        err = lib.masked_matmul_gemm_tn_bf16(
            a.data_ptr(), bt.data_ptr(), c.data_ptr(), a.shape[0],
            a.shape[1], bt.shape[0], *plan, stream)
        if err:
            raise RuntimeError(f"plan {plan}: CUDA error {err}")
        return c

    # GEMM shape (m, r, nout) -> the products that run it and their
    # launches per vit_cifar train step (fc2's forward is fc1's dx)
    products = {}
    for name, m, kd, nd, dname, mode, per_step, _ in cs.DENSE_SHAPES:
        if dname != "bfloat16" or mode != "binary":
            continue
        for what, shape in (("fwd", (m, kd, nd)), ("dx", (m, nd, kd))):
            names, n = products.get(shape, ([], 0))
            products[shape] = (names + [f"{name} {what}"], n + per_step)
    rows = []
    for (m, r, nout), (name, per_step) in products.items():
        a = torch.randn((m, r), generator=gen).to(dev, torch.bfloat16)
        bt = (torch.randn((nout, r), generator=gen) / r ** 0.5).to(
            dev, torch.bfloat16)
        ref = mm.gemm_tn_plain(a, bt)
        row = dict(product=name, shape=[m, r, nout], per_step=per_step,
                   picked=list(mm.gemm_plan(m, r, nout, sms)),
                   cublas_device_us=cs.device_ms(lambda: a @ bt.t()) * 1e3,
                   plans={})
        for plan in plans(mm, sms):
            cs.compare(gemm(a, bt, plan), ref, "bfloat16",
                       f"gemm {name} plan {plan}")
            row["plans"][str(list(plan))] = cs.device_ms(
                lambda: gemm(a, bt, plan)) * 1e3
        row["card"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_dense_gemm_plans.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
