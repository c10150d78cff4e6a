#!/usr/bin/env python3
"""K4 and K5 on their TMA + wgmma routes under a sweep of launch plans, on
the card.

    python scripts/torch_fused_chain_plans.py

At each of chip_smoke.py's bf16 fused seams (VGG16-BN at batch 256 on the
"gemm" route; ResNet-50's four seam grids at batch 32 on the "im2col"
route) times `csrc/fused_chain_fwd.cu`'s `fused_chain_fwd_gemm_bf16` (K4)
and `csrc/fused_chain_bwd_dx.cu`'s `fused_chain_bwd_dx_gemm_bf16` or
`_im2col_bf16` (K5) by torch.profiler's device time under each tile width
of `masked_matmul.FUSED_BNS` and a ladder of ring depths that fit shared
memory, beside the plans `masked_matmul.fused_fwd_plan` and
`fused_dx_plan` / `fused_dx_im2col_plan` pick, the earlier kernels
(`fused_chain_fwd_bf16`, `fused_chain_bwd_dx_bf16`: the mma.sync K4 and
conv_bwd.cuh's dgrad) and cuDNN's conv and dgrad alone on the same inputs,
in one process. Every plan's result is held against the plain
version first. This is what the plans' tile widths and ring depths are
checked against. Needs one CUDA card. Prints one JSON line a seam and
writes them to chiprun_out/torch_fused_chain_plans.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

DEPTHS = (2, 3, 4, 5, 6, 8, 10, 12)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fused_chain_plans: needs a CUDA card", file=sys.stderr)
        return 1
    from cpg_tpu_torch.ops import fused_chain as fc
    from cpg_tpu_torch.ops import masked_matmul as mm
    from cpg_tpu_torch.ops.conv import conv2d_nhwc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    fwd = fc._fn("fused_chain_fwd", bf, "gemm")
    seams = ([(*c, cs.BATCH) for c in cs.CHAIN_SHAPES]
             + [(name, hw, c, c, cs.RESNET_BATCH)
                for name, hw, c, _ in cs.RESNET_SEAMS])
    rows = []
    for name, hw, cin, cout, n in seams:
        gen = torch.Generator().manual_seed(cs.SEED + 1)
        x = torch.randn((n, hw, hw, cin), generator=gen).to(dev, bf)
        a = (torch.rand((cin,), generator=gen) + 0.5).to(dev)
        b = (torch.randn((cin,), generator=gen) * 0.3).to(dev)
        w = (torch.randn((3, 3, cin, cout), generator=gen)
             * (2.0 / (9 * cout)) ** 0.5).to(dev, bf)
        g = (torch.randn((n, hw, hw, cout), generator=gen) * 0.1).to(dev, bf)
        route = fc.dx_route(x, w, bf)
        box, split = mm.fused_fwd_halo(hw, hw)
        _, _, rows_, imgs = box
        halo = mm.fused_halo_bytes(box, split)
        tiles_m = -(-n * hw * hw // mm.GEMM_BM)
        if route == "gemm":
            _, _, box_h, box_n = mm.fused_dx_plan(n, hw, hw, cin, cout, sms)[0]
            walk = (box_h, box_n)
            dx_plan = mm.fused_dx_plan
        else:
            walk = (mm.phase_table(mm.fused_dx_im2col_plan(
                n, hw, hw, cin, cout, sms)[0]),)
            dx_plan = mm.fused_dx_im2col_plan
        bwd = fc._fn("fused_chain_bwd_dx", bf, route)
        y_ref = fc.fused_oracle(x, a, b, w, bf)
        dx_ref = fc.fused_bwd_dx_plain(x, a, b, w, g, bf)

        def k4(bn, stages):
            y = torch.empty((n, hw, hw, cout), dtype=bf, device=dev)
            grid = min(tiles_m * -(-cout // bn), sms)
            err = fwd(x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                      y.data_ptr(), n, hw, hw, cin, cout, rows_, imgs, split,
                      bn, stages, grid, stream)
            if err:
                raise RuntimeError(f"K4 {name} {bn} {stages}: CUDA error {err}")
            return y

        def k5(bn, stages):
            dx = torch.empty_like(x)
            ws = torch.empty((2, tiles_m, cin), dtype=torch.float32,
                             device=dev)
            da = torch.empty((cin,), dtype=torch.float32, device=dev)
            db = torch.empty_like(da)
            grid = min(tiles_m * -(-cin // bn), sms)
            err = bwd(x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
                      w.data_ptr(), dx.data_ptr(), ws[0].data_ptr(),
                      ws[1].data_ptr(), da.data_ptr(), db.data_ptr(), n, hw,
                      hw, cin, cout, *walk, bn, stages, grid, stream)
            if err:
                raise RuntimeError(f"K5 {name} {bn} {stages}: CUDA error {err}")
            return dx, da, db

        def earlier(lib, *tensors, out):
            err = fc._fn(lib, bf)(*(t.data_ptr() for t in tensors),
                                  *(t.data_ptr() for t in out), n, hw, hw,
                                  cin, cout, stream)
            if err:
                raise RuntimeError(f"{lib} {name}: CUDA error {err}")
            return out

        y_out = torch.empty((n, hw, hw, cout), dtype=bf, device=dev)
        dx_out = (torch.empty_like(x),
                  torch.empty((2, tiles_m, cin), dtype=torch.float32,
                              device=dev), torch.empty(cin, device=dev),
                  torch.empty(cin, device=dev))
        act = torch.relu(x * a.to(bf) + b.to(bf))
        xt, gt = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        wt = w.permute(3, 2, 0, 1)
        row = dict(seam=name, route=route, shape=[n, hw, hw, cin, cout],
                   card=card, halo=[list(box), split],
                   k4_picked=list(mm.fused_fwd_plan(n, hw, hw, cin, cout,
                                                    sms)[1:3]),
                   k5_picked=list(dx_plan(n, hw, hw, cin, cout, sms)[1:3]),
                   k4_earlier_us=cs.device_ms(lambda: earlier(
                       "fused_chain_fwd", x, a, b, w, out=(y_out,))) * 1e3,
                   k5_earlier_us=cs.device_ms(lambda: earlier(
                       "fused_chain_bwd_dx", x, g, a, b, w,
                       out=(dx_out[0], dx_out[1][0], dx_out[1][1],
                            dx_out[2], dx_out[3]))) * 1e3,
                   cudnn_conv_us=cs.device_ms(
                       lambda: conv2d_nhwc(act, w, 1, (1, 1, 1, 1))) * 1e3,
                   cudnn_dgrad_us=cs.device_ms(
                       lambda: torch.nn.grad.conv2d_input(
                           xt.shape, wt, gt, 1, 1)) * 1e3,
                   k4_us={}, k5_us={})
        for bn in mm.FUSED_BNS:
            for stages in DEPTHS:
                if mm.fused_fwd_smem_bytes(bn, stages, halo) <= mm.SMEM_PER_BLOCK:
                    cs.compare(k4(bn, stages), y_ref, "bfloat16",
                               f"K4 {name} {bn} {stages}")
                    row["k4_us"][f"{bn},{stages}"] = cs.device_ms(
                        lambda: k4(bn, stages)) * 1e3
                if mm.fused_dx_smem_bytes(bn, stages) <= mm.SMEM_PER_BLOCK:
                    got = k5(bn, stages)
                    cs.compare(got[0], dx_ref[0], "bfloat16",
                               f"K5 dx {name} {bn} {stages}")
                    for i, what in ((1, "da"), (2, "db")):
                        cs.compare(got[i], dx_ref[i], "float32",
                                   f"K5 {what} {name} {bn} {stages}",
                                   rel=cs.AFFINE_SUM_TOL)
                    row["k5_us"][f"{bn},{stages}"] = cs.device_ms(
                        lambda: k5(bn, stages)) * 1e3
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_fused_chain_plans.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
