#!/usr/bin/env python3
"""K7's one-launch backward under a sweep of ring depths, on the card.

    python scripts/torch_flash_bwd_plans.py

At each bf16 shape of chip_smoke.py's `FLASH_SHAPES` that
`flash.bwd_route` takes (vit_cifar, vit_b16, causal T = 70) times
`csrc/flash_bwd_wgmma.cu` by torch.profiler's device time under every
ring depth that fits shared memory (the plan's own marked), beside the
dQ + dK/dV pair it replaces and SDPA's autograd backward alone, in turns
(pair, kernel, kernel, pair) in one process. Every depth's result is held
against the plain version first. This is what `bwd_plan`'s ring depth and
`bwd_route` are checked against. Needs one CUDA card. Prints one JSON line
a shape and writes them to chiprun_out/torch_flash_bwd_plans.json.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

MAX_STAGES = 6


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_bwd_plans: needs a CUDA card", file=sys.stderr)
        return 1
    from cpg_tpu_torch.ops import flash as fl

    card = cs.card_line()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    kernel = fl._fn("flash_bwd_wgmma", torch.bfloat16)
    rows = []
    for name, n, t, h, hd, causal, dname, _ in cs.FLASH_SHAPES:
        gen = torch.Generator().manual_seed(cs.SEED + 6)
        q, k, v, do = (torch.randn((n, t, h, hd), generator=gen).to(
            dev, getattr(torch, dname)) for _ in range(4))
        if not fl.bwd_route(q):
            continue
        o, lse = fl.flash_fwd(q, k, v, causal)
        want = fl.flash_mha_bwd_plain(q, k, v, o, lse, do, causal)
        plan = fl.bwd_plan(n, t, h, hd, sms)

        def run(stages, grid=plan.grid):
            out = [torch.empty_like(a) for a in (q, k, v)]
            err = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         *(a.data_ptr() for a in out), n, t, h, hd,
                         int(causal), stages, grid, stream)
            if err:
                raise RuntimeError(f"flash_bwd_wgmma: CUDA error {err}")
            return out

        def pair():
            dq, d = fl.flash_bwd_dq(q, k, v, o, lse, do, causal)
            return fl.flash_bwd_dkv(q, k, v, do, lse, d, causal)

        qg, kg, vg = (a.transpose(1, 2).detach().clone().requires_grad_(True)
                      for a in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        dot = do.transpose(1, 2)
        sdpa = lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                           retain_graph=True)
        depths = [s for s in range(2, MAX_STAGES + 1)
                  if fl.bwd_smem_bytes(plan.pair, plan.n_kb, plan.n_qt, s)
                  <= fl._SMEM_LIMIT]
        for s in depths:
            for g_, w_, x in zip(run(s), want, "qkv"):
                cs.compare(g_, w_, dname, f"flash_bwd d{x} {name} {s} stages")
        pair_ms, kern_ms = [], {s: [] for s in depths}
        for turn in ("pair", "kernel", "kernel", "pair"):
            if turn == "pair":
                pair_ms.append(cs.device_ms(pair))
            else:
                for s in depths:
                    kern_ms[s].append(cs.device_ms(lambda: run(s)))
        row = {"layer": name, "shape": [n, t, h, hd], "causal": causal,
               "plan": list(plan), "stages_device_ms":
               {str(s): ms for s, ms in kern_ms.items()},
               "pair_device_ms": pair_ms, "sdpa_bwd_device_ms":
               cs.device_ms(sdpa), "bound_ms": cs.bound(
                   8 * q.numel() * 2 + n * h * t * 4,
                   10 * n * h * t * t * hd * (0.5 if causal else 1.0),
                   dname)[0], "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_flash_bwd_plans.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
