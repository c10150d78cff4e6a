"""Data, model and pipeline parallelism over NCCL across every visible card.

`chip_smoke.nccl_cards_check` at n = the visible cards (at least two): the
VGG16-BN kernel step on one rank a card (global batch 256) against the
one-process step, f32 and bf16, replicas bit-equal after every step, with
ms/step of the n ranks and of one process ("dp"); the same with the model
axis as (n/2, 2) (each card half of every kernel) and, on four cards,
vit_moe_cifar as (1, 4) (one whole expert a card) ("tp");
`sequence --parallel n` and `sequence --parallel n/2 --parallel-model 2`
against `sequence --parallel 1` (in-process, over NCCL at one rank), all in
f32: the same cycle and final states within twice the widest spread of one
process's three summation orders ("cli"); a bf16 server with a weight
replica a card against the unmeshed one ("serve"); on four cards,
vit_b16's pipeline (4 stages of 3 blocks, 8 microbatches, batch 64, K7 in
the blocks) against the one-process step ("pp"), and f32
`sequence --arch vit_moe_cifar --parallel 2 --parallel-model 2
--shard-activations` against `--parallel 1` by the "cli" rule
("act_shard_cli"); with fewer than four cards it says that those did not
run. The JSON goes to `chiprun_out/parallel_cards.json`.

    python3 scripts/torch_parallel_cards.py     # needs two cards or more
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cpg_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"torch_parallel_cards: {n} card(s) visible; needs two",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card} (x{n})", flush=True)
    print(f"build: {_build.build_all():.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out, launched = cs.nccl_cards_check(
        torch, [f"cuda:{i}" for i in range(n)], card)
    out.update(launches=launched, card=card, cards=n)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "parallel_cards.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"parallel ms/step over {n} NCCL ranks, bf16 VGG16-BN kernel step "
          f"at batch {cs.BATCH}: {out['dp']['ms_per_step_ranks']}, one "
          f"process {out['dp']['ms_per_step_one_process']:.2f} on {card}",
          flush=True)
    for arch, tp in out["tp"].items():
        print(f"parallel tp {arch} over {n} NCCL ranks, model groups of "
              f"{tp['n_model']}, bf16 kernel step at batch {cs.BATCH}: "
              f"{tp['ms_per_step_ranks']} ms/step, one process "
              f"{tp['ms_per_step_one_process']:.2f}; rank 0 holds "
              f"{tp['held'][0]['bytes']} of {tp['held'][0]['whole_bytes']} "
              f"bytes on {card}", flush=True)
    if "pp" in out:
        pp = out["pp"]
        print(f"pipeline {cs.PP_CARDS['arch']} over 4 NCCL ranks "
              f"({pp['pipeline']}), bf16 at batch {pp['batch']}: "
              f"{pp['ms_per_step_ranks']} ms/step, one process "
              f"{pp['ms_per_step_one_process']:.2f}; K7 a step per stage "
              f"{json.dumps({k: v for k, v in pp['launches_step_pp_bf16'].items() if v})}"
              f", one process {json.dumps(pp['k7_launches_step_one_process'])}"
              f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
