#!/usr/bin/env python3
"""The weight-gradient GEMM (K3) under every launch plan, on the card.

    python scripts/torch_wgrad_plans.py

For K3's products on the main path (vit_cifar's q/k/v/proj, fc1 and fc2 at
batch 256, vit_b16's q/k/v at 64, and VGG16-BN's conv0 patches and conv2,
4, 7 and 10 at batch 256) times `csrc/masked_matmul_wgrad.cu` by
torch.profiler's device time under each tile width of
`masked_matmul.WGRAD_BNS` and a ladder of split counts (each at the deepest
ring that fits and one block an SM; more than one split adds the gate
pass), beside the plan `wgrad_plan` picks and the library product alone
(`torch.matmul` x^T g, or cuDNN's conv2d_weight). Every plan's result is
held against the plain version first (`max_rel_err`, max|diff| / max|ref|;
a plan outside chip_smoke.py's SUM_TOL is marked and not timed). This is
what `wgrad_plan`'s cost model is checked against.
Needs one CUDA card. Prints one JSON line a product and writes them to
chiprun_out/torch_wgrad_plans.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

def plans(mm, m, k, n, rows, sms):
    """(bn, splits, stages, grid) over the sweep: each distinct split of the
    steps once."""
    steps = -(-m // rows)
    out = []
    for bn in mm.WGRAD_BNS:
        stages = mm.WGRAD_MAX_STAGES
        while mm.wgrad_smem_bytes(bn, rows, stages) > mm.SMEM_PER_BLOCK - 1024:
            stages -= 1
        tiles = -(-k // mm.WGRAD_BK) * -(-n // bn)
        seen = set()
        for want in mm.WGRAD_SPLITS:
            if want > steps:
                break
            per = -(-steps // want)
            splits = -(-steps // per)
            if splits in seen:
                continue
            seen.add(splits)
            out.append((bn, splits, stages, min(tiles * splits, sms)))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_wgrad_plans: needs a CUDA card", file=sys.stderr)
        return 1
    from cpg_tpu_torch.ops import masked_conv as mc
    from cpg_tpu_torch.ops import masked_matmul as mm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(cs.SEED)

    def weights(k, n):
        w = torch.randn((k, n), generator=gen).to(dev)
        own = torch.randint(0, 4, (k, n), generator=gen,
                            dtype=torch.int8).to(dev)
        return w, own

    # (name, launches per train step at batch 256, m, k, n, rows, launch(plan),
    # plain(), library product alone)
    cases = []
    for name, m, kd, nd, dname, mode, per_step, _ in cs.DENSE_SHAPES:
        if dname != "bfloat16" or mode != "binary":
            continue
        x = torch.randn((m, kd), generator=gen).to(dev, torch.bfloat16)
        g = (torch.randn((m, nd), generator=gen) * 0.1).to(dev, torch.bfloat16)
        w, own = weights(kd, nd)
        cases.append((name, per_step, m, kd, nd, mm.WGRAD_DENSE_ROWS,
                      lambda p, x=x, g=g, w=w, own=own:
                      mm.launch_wgrad(x, g, w, own, 2, p),
                      lambda x=x, g=g, w=w, own=own:
                      mm.masked_matmul_bwd_dw_plain(g, x, w, own, 2),
                      lambda x=x, g=g: x.t() @ g))
    for name, hw, cin, cout in cs.MASKED_CONV_SHAPES:
        x = torch.randn((cs.BATCH, hw, hw, cin), generator=gen).to(
            dev, torch.bfloat16)
        g = (torch.randn((cs.BATCH, hw, hw, cout), generator=gen)
             * 0.1).to(dev, torch.bfloat16)
        w, own = weights(9 * cin, cout)
        w4, own4 = w.reshape(3, 3, cin, cout), own.reshape(3, 3, cin, cout)
        xt, gt = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        cudnn = (lambda xt=xt, gt=gt, cin=cin, cout=cout:
                 torch.nn.grad.conv2d_weight(xt, (cout, cin, 3, 3), gt, 1, 1))
        plain = (lambda x=x, g=g, w4=w4, own4=own4:
                 tuple(t.reshape(-1, t.shape[-1]) for t in
                       mc.masked_conv2d_bwd_dw_plain(g, x, w4, own4, 2)))
        if mc.im2col_route(x, w4):  # conv0: the dense walk over the patches
            k, kp = 9 * cin, -(-9 * cin // 8) * 8
            patches = mm.launch_im2col(x, 3, 3, 1, (1, 1, 1, 1), kp)
            cases.append((name, 1, patches.shape[0], k, cout,
                          mm.WGRAD_DENSE_ROWS,
                          lambda p, a=patches, g=g, w=w, own=own, c=cout:
                          mm.launch_wgrad(a, g.reshape(-1, c), w, own, 2, p),
                          plain, cudnn))
            continue
        box = mc.conv_box(hw, hw)
        cases.append((name, 1, cs.BATCH * hw * hw, 9 * cin, cout,
                      mm.WGRAD_CONV_ROWS,
                      lambda p, x=x, g=g, w4=w4, own4=own4, box=box:
                      tuple(t.reshape(-1, t.shape[-1]) for t in
                            mm.launch_wgrad_conv(g, x, w4, own4, 2, 1, 1,
                                                 (box, *p))),
                      plain, cudnn))

    rows = []
    for name, per_step, m, k, n, rows_a_step, launch, plain, alone in cases:
        want = plain()
        picked = mm.wgrad_plan(m, k, n, sms, rows_a_step)
        row = dict(product=name, shape=[m, k, n], rows=rows_a_step,
                   per_step=per_step, picked=list(picked),
                   library_alone_device_us=cs.device_ms(alone) * 1e3,
                   plans={}, card=card)
        row["max_rel_err"] = {}
        for plan in plans(mm, m, k, n, rows_a_step, sms):
            got = launch(plan)
            rel = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, want))
            row["max_rel_err"][str(list(plan))] = rel
            if not rel <= cs.SUM_TOL:
                row["plans"][str(list(plan))] = "outside SUM_TOL"
                continue
            us = cs.device_ms(lambda: launch(plan))
            row["plans"][str(list(plan))] = None if us is None else us * 1e3
        timed = {p: t for p, t in row["plans"].items()
                 if isinstance(t, float)}
        best = min(timed, key=timed.get)
        row.update(best=best, best_us=timed[best],
                   picked_us=row["plans"].get(str(list(picked))))
        print(json.dumps({k: v for k, v in row.items()
                          if k not in ("plans", "max_rel_err")}),
              flush=True)
        rows.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_wgrad_plans.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
