"""The earlier K3 (`csrc/masked_conv_bwd_dw.cu`, split-K f32 partials) at
SphereNet-20's conv geometries, on the card: its error and time under
several split counts, against the weight gradient summed in f64.

For each geometry of `chip_smoke.SPHERE_CONV_SHAPES` at batch 256 (bf16
inputs, as `chip_smoke.conv_geometry_rows` makes them) it prints, as a
share of max|G|, how far the f32 plain version
(`masked_conv2d_bwd_dw_plain`, cuDNN's f32 wgrad with TF32 off) and the
kernel are from the f64 sum, the kernel under `conv.wgrad_splits`'s count
("default"), 2x and 4x that, and enough splits that no split reduces more
than 4,096 or 2,048 pixels, each with its CUDA-event ms. The JSON goes to
`chiprun_out/k3_splits.json`.

    python3 scripts/torch_k3_splits.py     # needs one card and nvcc
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cpg_tpu_torch.ops import _build  # noqa: E402
from cpg_tpu_torch.ops import conv as conv_mod  # noqa: E402
from cpg_tpu_torch.ops import masked_conv as mc  # noqa: E402
from cpg_tpu_torch.ops.conv import out_size, resolve_padding  # noqa: E402

BATCH = 256
PLANS = {
    "default": lambda m, k, n: conv_mod.wgrad_splits(m, k, n),
    "x2": lambda m, k, n: 2 * conv_mod.wgrad_splits(m, k, n),
    "x4": lambda m, k, n: 4 * conv_mod.wgrad_splits(m, k, n),
    "chain4096": lambda m, k, n: max(conv_mod.wgrad_splits(m, k, n),
                                     -(-m // 4096)),
    "chain2048": lambda m, k, n: max(conv_mod.wgrad_splits(m, k, n),
                                     -(-m // 2048)),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_splits: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    print(f"build {_build.build_all():.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    out = []
    try:
        for name, hw, stride, cin, cout, _ in cs.SPHERE_CONV_SHAPES:
            pad = 1 if stride == 2 else "SAME"
            h, wd = hw
            pt, pb, pl, pr = resolve_padding(pad, h, wd, 3, 3, stride)
            ho = out_size(h, 3, stride, pt, pb)
            wo = out_size(wd, 3, stride, pl, pr)
            m = BATCH * ho * wo
            gen, x, w, gy = cs._conv_inputs(torch, dev, hw, cin, cout,
                                            torch.bfloat16, cs.SEED + 9,
                                            BATCH, 3, (ho, wo))
            own = torch.randint(0, 4, w.shape, generator=gen,
                                dtype=torch.int8).to(dev)
            exact = mc.masked_conv2d_bwd_dw_plain(gy, x, w, own, 2, stride,
                                                  pad, acc_dtype=torch.float64)
            plain = mc.masked_conv2d_bwd_dw_plain(gy, x, w, own, 2, stride,
                                                  pad)
            scale = exact[0].abs().max().item()
            row = {"layer": name, "pixels": m, "max_ref": scale,
                   "plain_f32_rel": (plain[0] - exact[0]).abs().max().item()
                   / scale, "plans": {}}
            for label, plan in PLANS.items():
                mc.wgrad_splits = plan
                got = mc.launch_bwd_dw(gy, x, w, own, 2, stride, pad)[0]
                ms = cs.time_ms(lambda: mc.launch_bwd_dw(
                    gy, x, w, own, 2, stride, pad), iters=10, warmup=2)
                row["plans"][label] = {
                    "splits": plan(m, 9 * cin, cout),
                    "rel": (got - exact[0]).abs().max().item() / scale,
                    "ms": ms}
            mc.wgrad_splits = conv_mod.wgrad_splits
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        mc.wgrad_splits = conv_mod.wgrad_splits
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k3_splits.json"), "w") as f:
        json.dump({"card": card, "rows": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
