"""The power of `chip_smoke.py`'s model-axis f32 update rule, on the card.

Runs `chip_smoke.dp_ranks_check` as the parallel phase runs it for the
model axis (two gloo ranks sharing the card as (data=1, model=2), VGG16-BN
at width PAR_MULT, task 2's kernel step at batch BATCH against the
one-process step) with its limits lifted, on sound code and with a fault
injected into `to_model_group`'s backward in both ranks:

- `sound`: the model group's sum of partial input gradients in f32;
- `bf16_sum`: that sum taken in bf16 (each rank's partial rounded to bf16,
  summed, returned in the gradient's dtype).

For each run it prints the f32 step's shared and private update distances
over the update's norm and whether each bound would pass: the model axis's
`TP_F32_UPDATE_RTOL` and the data-parallel `F32_UPDATE_RTOL`, beside the
f32 loss rule (`PAR_F32_LOSS_RTOL`) and the piggymask rule. Exits 1 unless
the sound run passes the model axis's bound and the fault misses it. The
JSON goes to `chiprun_out/tp_controls.json`.

    python3 scripts/torch_tp_controls.py     # needs one card and nvcc
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cpg_tpu_torch.ops import _build  # noqa: E402

ARMS = ("sound", "bf16_sum")
LIMITS = ("PAR_F32_LOSS_RTOL", "LOSS_RTOL", "F32_UPDATE_RTOL",
          "TP_F32_UPDATE_RTOL", "UPDATE_RATIO")


def _bf16_sum_backward(ctx, g):
    import torch.distributed as dist

    s = g.to(torch.bfloat16, copy=True).contiguous()
    dist.all_reduce(s, group=ctx.group)
    return s.to(g.dtype), None


def _control_rank(rank, world, store, cfg, out_dir):
    """`chip_smoke._parallel_rank` with cfg["control"]'s fault in place."""
    if cfg["control"] == "bf16_sum":
        from cpg_tpu_torch.parallel import collectives

        collectives._ToModelGroup.backward = staticmethod(_bf16_sum_backward)
    cs._parallel_rank(rank, world, store, cfg, out_dir)


def run(devices, backend, card):
    """Each arm's readings and verdicts, the limits lifted while it runs."""
    bounds = {k: getattr(cs, k) for k in LIMITS}
    rank_fn = cs._parallel_rank
    out = {}
    try:
        for k in LIMITS:  # read, not judged, here
            setattr(cs, k, math.inf)
        cs._parallel_rank = _control_rank
        for arm in ARMS:
            t = time.perf_counter()
            res, _ = cs.dp_ranks_check(torch, {
                "devices": devices, "backend": backend, "mult": cs.PAR_MULT,
                "batch": cs.BATCH, "n_model": 2, "control": arm}, card)
            rel, pm = res["f32_update_rel"], res["f32_piggymask"]
            out[arm] = dict(
                f32_update_rel=rel, f32_loss_max_rel=res["f32_loss_max_rel"],
                bf16_loss_max_rel=res["bf16_loss_max_rel"],
                passes_tp_bound=all(v <= bounds["TP_F32_UPDATE_RTOL"]
                                    for v in rel.values()),
                passes_dp_bound=all(v <= bounds["F32_UPDATE_RTOL"]
                                    for v in rel.values()),
                passes_loss_rule=(res["f32_loss_max_rel"]
                                  <= bounds["PAR_F32_LOSS_RTOL"]),
                f32_piggymask=pm, passes_piggymask_rule=(
                    pm["off"] <= (bounds["UPDATE_RATIO"] * pm["off_default"]
                                  + cs.PAR_MASK_OFF_SHARE * pm["moved"])
                    and pm["max_abs_diff"] <= 3 * pm["lr_mask"]),
                wall_s=time.perf_counter() - t)
            print(f"tp control {arm}: {json.dumps(out[arm])} on {card}",
                  flush=True)
    finally:
        for k, v in bounds.items():
            setattr(cs, k, v)
        cs._parallel_rank = rank_fn
    out["bounds"] = bounds
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tp_controls: no card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    print(f"build: {_build.build_all():.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = run(["cuda:0"] * 2, "gloo", card)
    out["card"] = card
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tp_controls.json"), "w") as f:
        json.dump(out, f, indent=1)
    ok = out["sound"]["passes_tp_bound"] and not out["bf16_sum"][
        "passes_tp_bound"]
    print(f"tp controls: {'as expected' if ok else 'NOT as expected'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
