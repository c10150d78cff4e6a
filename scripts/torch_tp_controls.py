"""The power of `chip_smoke.py`'s f32 update rule for the model axis and
the pipeline, on the card.

Runs `chip_smoke.dp_ranks_check` with its limits lifted, on sound code and
with a fault injected in both ranks, for two configurations:

- the model axis, as the parallel phase runs it (two gloo ranks sharing
  the card as (data=1, model=2), VGG16-BN at width PAR_MULT, task 2's
  kernel step at batch BATCH against the one-process step):
  - `sound`: the model group's sum of partial input gradients in f32;
  - `bf16_sum`: that sum taken in bf16 (each rank's partial rounded to
    bf16, summed, returned in the gradient's dtype; `to_model_group`'s
    backward);
- the pipeline, as the pipeline phase runs it (vit_cifar's 6 blocks as
  PP_STAGES stages on two gloo ranks sharing the card, PP_MICRO
  microbatches, K7 in the blocks):
  - `pp_sound`: as shipped;
  - `pp_bf16_sum`: the stages' gradient sum (`to_model_group` over the pipe
    group) taken in bf16, as `bf16_sum`;
  - `pp_bf16_ring`: the ring (`ppermute_ring`) carrying each stage's
    output in bf16.

For each run it prints the f32 step's shared and private update distances
over the update's norm and whether each bound would pass: the bound of the
model axis and the pipeline, `TP_F32_UPDATE_RTOL`, and the data-parallel
`F32_UPDATE_RTOL`, beside the f32 loss rule (`PAR_F32_LOSS_RTOL`) and the
piggymask rule. Exits 1 unless both sound runs pass `TP_F32_UPDATE_RTOL`
and every fault misses it. The JSON goes to
`chiprun_out/tp_controls.json`.

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

ARMS = ("sound", "bf16_sum", "pp_sound", "pp_bf16_sum", "pp_bf16_ring")
LIMITS = ("PAR_F32_LOSS_RTOL", "LOSS_RTOL", "F32_UPDATE_RTOL",
          "TP_F32_UPDATE_RTOL", "UPDATE_RATIO")


def _bf16_sum_backward(ctx, g):
    import torch.distributed as dist

    s = g.to(torch.bfloat16, copy=True).contiguous()
    dist.all_reduce(s, group=ctx.group)
    return s.to(g.dtype), None


def _bf16_ring_forward(ctx, x, group):
    from cpg_tpu_torch.parallel import collectives

    ctx.group = group
    return collectives._ring_take(x.to(torch.bfloat16), group, -1).to(x.dtype)


def _control_rank(rank, world, store, cfg, out_dir):
    """`chip_smoke._parallel_rank` with cfg["control"]'s fault in place."""
    from cpg_tpu_torch.parallel import collectives

    if cfg["control"] in ("bf16_sum", "pp_bf16_sum"):
        collectives._ToModelGroup.backward = staticmethod(_bf16_sum_backward)
    if cfg["control"] == "pp_bf16_ring":
        collectives._PpermuteRing.forward = staticmethod(_bf16_ring_forward)
    cs._parallel_rank(rank, world, store, cfg, out_dir)


def _config(arm, devices, backend):
    """The `dp_ranks_check` configuration an arm runs."""
    if arm.startswith("pp_"):
        return {"devices": devices, "backend": backend, "mult": cs.PAR_MULT,
                "batch": cs.BATCH, "arch": "vit_cifar",
                "pipeline": (cs.PP_STAGES, cs.PP_MICRO), "control": arm}
    return {"devices": devices, "backend": backend, "mult": cs.PAR_MULT,
            "batch": cs.BATCH, "n_model": 2, "control": arm}


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
            res, _ = cs.dp_ranks_check(torch, _config(arm, devices,
                                                      backend), card)
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
            print(f"control {arm}: {json.dumps(out[arm])} on {card}",
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
    ok = all(out[arm]["passes_tp_bound"] == arm.endswith("sound")
             for arm in ARMS)
    print(f"controls: {'as expected' if ok else 'NOT as expected'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
