"""Command line: the CPG cycle and offline serving.

    python -m cpg_tpu_torch sequence --experiment cifar100 ...  (the cycle)
    python -m cpg_tpu_torch baseline --experiment cifar100 ...  (goal accs)
    python -m cpg_tpu_torch packnet  --experiment cifar100 ...  (comparison
        row; --max_allowed_network_width_multiplier 1.0 for fixed capacity)
    python -m cpg_tpu_torch pae      --experiment cifar100 ...  (PackNet +
        the growth ladder)
    python -m cpg_tpu_torch serve --artifact A --requests R.npz \
        [--task-id T] [--fused-chain] [--out O.npz] [--device cuda]

The cycle subcommands take `cpg_tpu`'s flags with the same defaults and
presets (`--arch vit_cifar` swaps the architecture) and print one JSON
summary line. Everything runs on the card unless `--device cpu` is given.
Options whose modules are not ported yet (the other experiments,
`--parallel*`, `--shard-activations`, `--memmap-dir`, `--pretrained-npz`,
`--native-loader`, the finegrained and textcls flags) and the XLA-only
`--remat`, `--remat-policy` and `--scan-blocks` stop with an error naming
them. `--init-from` reads this
package's checkpoints (utils/checkpoint.py).

`serve`: R.npz holds `x` (uint8 NHWC) and, without --task-id, a per-row
`task_ids` array for mixed routing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

EXPERIMENTS = ["cifar100", "finegrained", "face", "textcls"]

# Per-experiment hyperparameter presets (the reference's shell-loop
# settings, as `cpg_tpu.cli` records them). Applied by --preset; explicit
# flags win. Only cifar100's applies until the other experiments are
# ported; theirs are kept so the table stays the reference's.
EXPERIMENT_PRESETS = {
    "cifar100": {        # VGG16-BN, 20 superclass tasks
        "lr": 0.01, "lr_mask": 1e-4, "weight_decay": 4e-5,
        "batch_size": 128, "finetune_epochs": 100, "prune_epochs": 30,
        "retrain_epochs": 30, "lr_schedule": "step",
    },
    "finegrained": {     # ResNet-50, ImageNet-pretrained task 1
        "lr": 1e-3, "lr_mask": 1e-4, "weight_decay": 4e-5,
        "batch_size": 32, "finetune_epochs": 30, "prune_epochs": 20,
        "retrain_epochs": 20, "lr_schedule": "step",
    },
    "face": {            # SphereNet-20 + A-Softmax on CASIA
        "lr": 0.1, "lr_mask": 1e-4, "weight_decay": 5e-4,
        "batch_size": 256, "finetune_epochs": 28, "prune_epochs": 16,
        "retrain_epochs": 16, "lr_schedule": "step",
    },
}

# options of `cpg_tpu`'s parser that this package does not run yet:
# (attribute, is-set test, what is missing)
UNPORTED = [
    ("parallel", bool, "multi-device training (ROADMAP Queue 1, item 12)"),
    ("parallel_model", lambda v: v != 1,
     "model-axis sharding (ROADMAP Queue 1, item 12)"),
    ("shard_activations", bool,
     "activation sharding (ROADMAP Queue 1, items 10 and 12)"),
    ("memmap_dir", bool, "memmapped datasets, data/stream.py (ROADMAP Queue "
                         "1, item 12)"),
    ("pretrained_npz", bool,
     "pretrained converters, train/pretrained.py (ROADMAP Queue 1, item 7)"),
    ("native_loader", bool,
     "the native prefetch loader (ROADMAP Queue 1, item 12)"),
    ("remat", bool, "XLA rematerialisation (TPU/XLA only; no port)"),
    ("remat_policy", bool, "XLA rematerialisation (TPU/XLA only; no port)"),
    ("scan_blocks", bool, "lax.scan over blocks (TPU/XLA only; no port)"),
    ("max_classes", lambda v: v is not None,
     "the finegrained experiment (ROADMAP Queue 1, item 7)"),
    ("text_causal", bool, "the textcls experiment (ROADMAP Queue 1, item 9)"),
    ("text_vocab", lambda v: v != 256,
     "the textcls experiment (ROADMAP Queue 1, item 9)"),
    ("text_seq_len", lambda v: v != 64,
     "the textcls experiment (ROADMAP Queue 1, item 9)"),
    ("text_tokenizer", lambda v: v != "byte",
     "the textcls experiment (ROADMAP Queue 1, item 9)"),
    ("text_order_frac", lambda v: v != 0.0,
     "the textcls experiment (ROADMAP Queue 1, item 9)"),
]


def _refuse_unported(args):
    if args.experiment != "cifar100":
        raise SystemExit(
            f"--experiment {args.experiment} is not ported to cpg_tpu_torch "
            "yet (ROADMAP Queue 1, items 7-9); this package runs cifar100")
    for attr, is_set, what in UNPORTED:
        if is_set(getattr(args, attr)):
            flag = "--" + attr.replace("_", "-")
            raise SystemExit(f"{flag}: {what} is not ported to cpg_tpu_torch")


def _experiment_tasks(args):
    """Resolve the experiment to (arch, ordered task dict, aug, prep)."""
    from .data import augment as A
    from .data.cifar import task_splits
    from .models import REGISTRY

    tasks = task_splits(synthetic_kwargs={
        "n_train_per_class": args.synthetic_train_per_class,
        "n_test_per_class": args.synthetic_test_per_class})
    if args.num_tasks:
        tasks = dict(list(tasks.items())[: args.num_tasks])
    arch = "vgg16_bn_cifar"
    if getattr(args, "arch", None):
        if args.arch not in REGISTRY:
            raise SystemExit(
                f"unknown --arch {args.arch!r}; have {sorted(REGISTRY)}")
        arch = args.arch
    return arch, tasks, A.cifar_train_augment, A.cifar_eval_preprocess


def _common_defaults():
    p = argparse.ArgumentParser()
    _add_common(p)
    return {a.dest: a.default for a in p._actions}


def _apply_preset(args):
    """Overlay the experiment's preset onto args, keeping explicit flags:
    a value is overridden only if it still equals the parser default."""
    defaults = _common_defaults()
    for k, v in EXPERIMENT_PRESETS.get(args.experiment, {}).items():
        if getattr(args, k) == defaults.get(k):
            setattr(args, k, v)


def _train_cfg(args):
    import torch

    from .train.step import TrainConfig

    return TrainConfig(
        lr=args.lr, lr_mask=args.lr_mask, weight_decay=args.weight_decay,
        label_smoothing=args.label_smoothing, optimizer=args.optimizer,
        use_pallas=args.use_pallas, use_pallas_conv=args.use_pallas_conv,
        use_fused_chain=args.fused_chain,
        flash_attention=args.flash_attention,
        compute_dtype=(torch.bfloat16 if args.dtype == "bfloat16"
                       else torch.float32))


def _seq_cfg(args):
    from .train.sequence import SequenceConfig

    return SequenceConfig(
        finetune_epochs=args.finetune_epochs, prune_epochs=args.prune_epochs,
        retrain_epochs=args.retrain_epochs,
        prune_ratios=tuple(args.prune_ratios),
        allow_acc_diff=args.allow_acc_diff, growth_step=args.growth_step,
        growth_epoch_scale=args.growth_epoch_scale,
        max_width_mult=args.max_allowed_network_width_multiplier,
        batch_size=args.batch_size, lr=args.lr, lr_mask=args.lr_mask,
        checkpoint_dir=args.checkpoint_dir, seed=args.seed,
        epoch_checkpoint_freq=args.epoch_checkpoint_freq,
        compact_mode=args.compact_mode, lr_schedule=args.lr_schedule,
        native_loader=args.native_loader, jsonl_path=args.jsonl)


def _add_common(p):
    p.add_argument("--experiment", default="cifar100", choices=EXPERIMENTS,
                   help="only cifar100 is ported; the others stop with an "
                        "error")
    p.add_argument("--arch", default=None,
                   help="override the experiment's default architecture "
                        "(a models.REGISTRY name, e.g. vit_cifar)")
    p.add_argument("--num-tasks", type=int, default=0,
                   help="0 = all tasks of the experiment")
    p.add_argument("--text-causal", action="store_true",
                   help="textcls only (not ported; stops with an error)")
    p.add_argument("--text-vocab", type=int, default=256,
                   help="textcls only (not ported; stops with an error)")
    p.add_argument("--text-seq-len", type=int, default=64,
                   help="textcls only (not ported; stops with an error)")
    p.add_argument("--text-tokenizer", default="byte", choices=["byte", "hash"],
                   help="textcls only (not ported; stops with an error)")
    p.add_argument("--text-order-frac", type=float, default=0.0,
                   help="textcls only (not ported; stops with an error)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr_mask", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=4e-5)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--use-pallas", action="store_true",
                   help="masked dense kernels in the sharable dense layers "
                        "(ops/masked_matmul.py)")
    p.add_argument("--use-pallas-conv", action="store_true",
                   help="masked-conv kernels in the sharable convs "
                        "(ops/masked_conv.py)")
    p.add_argument("--fused-chain", action="store_true",
                   help="fused BN+ReLU+conv3x3 kernels at the VGG seams "
                        "(ops/fused_chain.py)")
    p.add_argument("--remat", action="store_true",
                   help="XLA rematerialisation: no port (stops with an error)")
    p.add_argument("--remat-policy", default=None, choices=["convs"],
                   help="XLA rematerialisation: no port (stops with an error)")
    p.add_argument("--scan-blocks", action="store_true",
                   help="lax.scan over blocks: no port (stops with an error)")
    p.add_argument("--flash-attention", action="store_true",
                   help="transformer families: the flash attention kernels "
                        "(ops/flash.py)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--finetune-epochs", type=int, default=30)
    p.add_argument("--prune-epochs", type=int, default=10)
    p.add_argument("--retrain-epochs", type=int, default=10)
    p.add_argument("--prune-ratios", type=float, nargs="+",
                   default=[0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9])
    p.add_argument("--allow_acc_diff", type=float, default=0.005)
    p.add_argument("--growth-step", type=float, default=0.5)
    p.add_argument("--network_width_multiplier", type=float, default=1.0)
    p.add_argument("--max_allowed_network_width_multiplier", type=float,
                   default=2.0)
    p.add_argument("--growth-epoch-scale", type=float, default=0.0,
                   help="scale every phase's epochs by 1+s*(width_mult-1) "
                        "(0 = fixed budgets)")
    p.add_argument("--compact-mode", default="incremental",
                   choices=["incremental", "restart"])
    p.add_argument("--lr-schedule", default="cosine",
                   choices=["cosine", "constant", "step", "warmup_cosine"])
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"],
                   help="weight optimizer")
    p.add_argument("--goals-file", default=None,
                   help="JSON {task: goal_acc} (the baseline-acc file)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--epoch-checkpoint-freq", type=int, default=0,
                   help="checkpoint the pick phase every N epochs; 0 = "
                        "phase-boundary checkpoints only")
    p.add_argument("--record-dir", default=None,
                   help="ratio->acc JSON records")
    p.add_argument("--logfile", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", action="store_true",
                   help="apply the experiment's hyperparameter preset "
                        "(EXPERIMENT_PRESETS); explicit flags win")
    p.add_argument("--synthetic-train-per-class", type=int, default=100)
    p.add_argument("--synthetic-test-per-class", type=int, default=20)
    p.add_argument("--max-classes", type=int, default=None,
                   help="finegrained only (not ported; stops with an error)")
    p.add_argument("--init-from", default=None, metavar="CKPT",
                   help="continue a sequence from a checkpoint directory of "
                        "this package: its tasks are kept frozen and "
                        "skipped, the rest of the task list trains on top")
    p.add_argument("--pretrained-npz", default=None,
                   help="not ported (stops with an error)")
    p.add_argument("--parallel", type=int, default=0, metavar="N",
                   help="not ported (stops with an error unless 0)")
    p.add_argument("--parallel-model", type=int, default=1, metavar="M",
                   help="not ported (stops with an error unless 1)")
    p.add_argument("--shard-activations", action="store_true",
                   help="not ported (stops with an error)")
    p.add_argument("--memmap-dir", default=None,
                   help="not ported (stops with an error)")
    p.add_argument("--native-loader", action="store_true",
                   help="not ported (stops with an error)")
    p.add_argument("--jsonl", default=None,
                   help="structured per-phase JSONL metrics path")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="cpg_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for cmd in ("sequence", "baseline", "packnet", "pae"):
        _add_common(sub.add_parser(cmd))
    pv = sub.add_parser("serve",
                        help="batch inference from a serving artifact "
                             "(TaskServer.load), offline request-file mode")
    pv.add_argument("--artifact", required=True,
                    help="directory written by TaskServer.export")
    pv.add_argument("--requests", required=True,
                    help="npz with {x: uint8 NHWC} + either --task-id or a "
                         "per-row {task_ids: int32 (N,)} for mixed routing")
    pv.add_argument("--task-id", type=int, default=None)
    pv.add_argument("--out", default=None,
                    help="write logits (+ per-row argmax) to this npz")
    pv.add_argument("--fused-chain", action="store_true",
                    help="run the BN+ReLU+conv3x3 seams through the fused "
                         "CUDA kernel")
    pv.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return parser


def _serve(args) -> int:
    from .data.augment import cifar_eval_preprocess
    from .serve import TaskServer

    srv = TaskServer.load(args.artifact, preprocess_fn=cifar_eval_preprocess,
                          fused_chain=args.fused_chain, device=args.device)
    with np.load(args.requests) as z:
        z = dict(z)
    x = z["x"]
    if args.task_id is not None:
        lg = srv.predict(args.task_id, x)
        tids = np.full(len(x), args.task_id, np.int32)
        pred = np.argmax(lg, 1)
        arrs = {"logits": lg}
    elif "task_ids" in z:
        tids = np.asarray(z["task_ids"], np.int32)
        outs = srv.predict_mixed(list(zip(tids.tolist(), x)))
        pred = np.array([int(np.argmax(o)) for o in outs])
        # heads differ per task -> logits stored per row
        arrs = {f"logits_{i}": o for i, o in enumerate(outs)}
    else:
        raise SystemExit("--task-id or a task_ids array is required")
    if args.out:
        np.savez(args.out, task_ids=tids, pred=pred, **arrs)
    print(json.dumps({"n": int(len(x)), "tasks": sorted(set(tids.tolist())),
                      "pred_head": pred[:16].tolist(), "out": args.out}))
    return 0


def _cycle(args) -> int:
    from .core.state import resolve_device

    _refuse_unported(args)
    resolve_device(args.device)
    arch, tasks, aug, prep = _experiment_tasks(args)
    goals = None
    if args.goals_file and args.cmd != "baseline":  # baseline WRITES it
        with open(args.goals_file) as f:
            goals = json.load(f)

    if args.cmd == "baseline":
        from .train.baselines import train_individual_baselines

        out = train_individual_baselines(
            arch, tasks, _train_cfg(args), epochs=args.finetune_epochs,
            batch_size=args.batch_size, lr=args.lr, augment_fn=aug,
            preprocess_fn=prep, seed=args.seed,
            acc_file=args.goals_file or "baseline_acc.json",
            device=args.device)
        print(json.dumps(out))
        return 0

    if args.cmd == "packnet":
        from .train.baselines import run_packnet_sequence as runner
    elif args.cmd == "pae":
        from .train.baselines import run_pae_sequence as runner
    else:
        from .train.sequence import run_sequence as runner

    init_kw = {}
    if args.init_from:
        from .utils.checkpoint import load_state

        st = load_state(args.init_from, device=args.device)
        done = {t.name for t in st.tasks.values()}
        tasks = {k: v for k, v in tasks.items() if k not in done}
        init_kw["state"] = st

    state, reports = runner(
        arch, tasks, _train_cfg(args), _seq_cfg(args), goals=goals,
        augment_fn=aug, preprocess_fn=prep,
        width_mult=args.network_width_multiplier,
        record_dir=args.record_dir, device=args.device, **init_kw)
    print(json.dumps({
        "avg_top1": sum(r.final_acc for r in reports) / max(len(reports), 1),
        "final_width_mult": state.width_mult,
        "tasks": [{"name": r.name, "top1": r.final_acc,
                   "ratio": r.chosen_ratio, "grew": r.grew}
                  for r in reports]}))
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        return _serve(args)
    if args.preset:
        _apply_preset(args)

    from .utils import set_logger

    set_logger(args.logfile)
    return _cycle(args)
