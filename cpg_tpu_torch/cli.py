"""Command line: the CPG cycle, checkpoint tools and serving.

    python -m cpg_tpu_torch sequence --experiment cifar100 ...  (the cycle)
    python -m cpg_tpu_torch baseline --experiment cifar100 ...  (goal accs)
    python -m cpg_tpu_torch packnet  --experiment cifar100 ...  (comparison
        row; --max_allowed_network_width_multiplier 1.0 for fixed capacity)
    python -m cpg_tpu_torch pae      --experiment cifar100 ...  (PackNet +
        the growth ladder)
    python -m cpg_tpu_torch check     --checkpoint CK [--allow-transient]
    python -m cpg_tpu_torch stats     --checkpoint CK [--per-layer]
    python -m cpg_tpu_torch inference --checkpoint CK --task-id K
    python -m cpg_tpu_torch export    --checkpoint CK --out ART \
        [--int8 [--calibrate NPZ]]
    python -m cpg_tpu_torch export-torch --ckpt CK --out F.pth
    python -m cpg_tpu_torch import-torch --ckpt F.pth --out CK
    python -m cpg_tpu_torch serve --artifact ART (--requests R.npz \
        [--task-id T] [--out O.npz] | --http-port P [--batch-window-ms W]) \
        [--fused-chain]

The subcommands take `cpg_tpu`'s flags with the same defaults and presets
(`--arch vit_cifar` swaps the cycle's architecture) and print `cpg_tpu`'s
JSON. Everything runs on the card unless `--device cpu` is given. Four
experiments run: cifar100 (VGG16-BN, 20 CIFAR-100 superclass tasks),
finegrained (ResNet-50 at 224 px over CUBS, Cars, Flowers, WikiArt and
Sketch; `--max-classes` caps the synthetic stand-ins' classes and
`--pretrained-npz` installs pretrained weights as task 1) and face
(SphereNet-20: CASIA-WebFace identities with the A-Softmax head, then
expression, gender and age tasks with linear heads on the same trunk; the
`sequence` summary adds LFW verification through task 1's embedding,
`lfw_verification`) and textcls (the text transformer over the folders
of `$CPG_DATA_DIR/textcls/<task>/{train,test}/<class>/*.txt`, else
synthetic token tasks; `--text-causal` gives every task causal attention,
and the other `--text-*` flags size and shape the tokens; `--arch
vit_moe_cifar` runs the MoE ViT on the cifar100 tasks). Options whose
modules are not ported yet (`--parallel*`, `--shard-activations`,
`--memmap-dir`, `--native-loader`) and the XLA-only `--remat`,
`--remat-policy`, `--scan-blocks` and `--scoped-vmem-kib` stop with an
error naming them.
Checkpoints are this package's (utils/checkpoint.py).

`serve`: R.npz holds `x` (uint8 NHWC, or int32 (N, T) token ids for
textcls) and, without --task-id, a per-row
`task_ids` array for mixed routing; with --http-port the JSON endpoint of
server_http.py answers instead (blocking). `export --calibrate`: NPZ holds
`x` (one batch for every task) or `task<K>` batches per task id.
`check` exits 1 when the checkpoint breaks an invariant.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

EXPERIMENTS = ["cifar100", "finegrained", "face", "textcls"]

# Per-experiment hyperparameter presets (the reference's shell-loop
# settings, as `cpg_tpu.cli` records them). Applied by --preset; explicit
# flags win.
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
    ("native_loader", bool,
     "the native prefetch loader (ROADMAP Queue 1, item 12)"),
    ("remat", bool, "XLA rematerialisation (TPU/XLA only; no port)"),
    ("remat_policy", bool, "XLA rematerialisation (TPU/XLA only; no port)"),
    ("scan_blocks", bool, "lax.scan over blocks (TPU/XLA only; no port)"),
]


def _refuse_unported(args):
    for attr, is_set, what in UNPORTED:
        if is_set(getattr(args, attr)):
            flag = "--" + attr.replace("_", "-")
            raise SystemExit(f"{flag}: {what} is not ported to cpg_tpu_torch")
    if args.init_from and args.pretrained_npz:
        raise SystemExit("--init-from and --pretrained-npz are mutually "
                         "exclusive")


def _experiment_tasks(args):
    """Resolve the experiment to (arch, ordered task dict, aug, prep)."""
    from .data import augment as A
    from .models import REGISTRY

    if args.experiment == "finegrained":
        from .data.finegrained import FINEGRAINED_SPECS, finegrained_task

        names = list(FINEGRAINED_SPECS)[: args.num_tasks or None]
        tasks = {n: finegrained_task(n, max_classes=args.max_classes, seed=i)
                 for i, n in enumerate(names)}
        arch, aug = "resnet50", A.imagenet_train_augment
    elif args.experiment == "face":
        tasks = _face_tasks()
        if args.num_tasks:
            tasks = dict(list(tasks.items())[: args.num_tasks])
        arch, aug = "spherenet20", A.face_train_augment
    elif args.experiment == "textcls":
        tasks = _text_tasks(args)
        arch, aug = "textcls", _identity_augment
    else:
        from .data.cifar import task_splits

        tasks = task_splits(synthetic_kwargs={
            "n_train_per_class": args.synthetic_train_per_class,
            "n_test_per_class": args.synthetic_test_per_class})
        if args.num_tasks:
            tasks = dict(list(tasks.items())[: args.num_tasks])
        arch, aug = "vgg16_bn_cifar", A.cifar_train_augment
    if getattr(args, "arch", None):
        if args.arch not in REGISTRY:
            raise SystemExit(
                f"unknown --arch {args.arch!r}; have {sorted(REGISTRY)}")
        arch = args.arch
    return arch, tasks, aug, _prep(args)


def _identity_augment(x, rng):
    """Tokens take no augmentation."""
    return x


def _text_tasks(args):
    """The textcls tasks (`cpg_tpu.cli`'s): every task folder under
    `$CPG_DATA_DIR/textcls/` when there is one, tokenized to
    --text-seq-len by --text-tokenizer, else synthetic token tasks (four
    unless --num-tasks); each task runs causal attention under
    --text-causal."""
    from .data.textfolder import textfolder_task_splits

    real = textfolder_task_splits(seq_len=args.text_seq_len or 64,
                                  tokenizer=args.text_tokenizer,
                                  vocab=args.text_vocab)
    if real is not None:
        tasks = {n: real[n] for n in list(real)[: args.num_tasks or None]}
    else:
        from .data.text import text_task_splits

        tasks = text_task_splits(
            n_tasks=args.num_tasks or 4, vocab=args.text_vocab,
            seq_len=args.text_seq_len, order_frac=args.text_order_frac)
    if args.text_causal:
        for t in tasks.values():
            t["model_kwargs"] = {"causal": True}
    return tasks


def _face_tasks():
    """The face sequence (`cpg_tpu.cli`'s): CASIA-WebFace identities under
    the A-Softmax loss, then expression (7 classes), gender (2) and age
    group (5) tasks with linear heads on the compacted face trunk."""
    from .data.face import casia_task, synthetic_faces
    from .train.losses import make_angle_loss

    t = casia_task(seed=0)
    t["loss_fn"] = make_angle_loss()

    def facial_task(nc, seed):
        fx, fy = synthetic_faces(num_ids=nc, per_id=24, seed=seed)
        cut = int(len(fx) * 0.85)
        return {"train_x": fx[:cut], "train_y": fy[:cut] % nc,
                "test_x": fx[cut:], "test_y": fy[cut:] % nc,
                "num_classes": nc, "model_kwargs": {"head_type": "linear"}}

    return {"casia": t, "expressions": facial_task(7, 11),
            "gender": facial_task(2, 12), "age": facial_task(5, 13)}


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
                   help="cifar100 (VGG16-BN), finegrained (ResNet-50), "
                        "face (SphereNet-20) or textcls (the text "
                        "transformer)")
    p.add_argument("--arch", default=None,
                   help="override the experiment's default architecture "
                        "(a models.REGISTRY name, e.g. vit_cifar)")
    p.add_argument("--num-tasks", type=int, default=0,
                   help="0 = all tasks of the experiment")
    _add_text_flags(p)
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
                   help="fused BN+ReLU+conv3x3 kernels at the stride-1 "
                        "seams (ops/fused_chain.py)")
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
                   help="cap synthetic fine-grained class counts")
    p.add_argument("--init-from", default=None, metavar="CKPT",
                   help="continue a sequence from a checkpoint directory of "
                        "this package: its tasks are kept frozen and "
                        "skipped, the rest of the task list trains on top")
    p.add_argument("--pretrained-npz", default=None,
                   help="ImageNet-pretrained task-1 weights npz (torch "
                        "state_dict keys or this package's keys)")
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


def _add_text_flags(p):
    p.add_argument("--text-causal", action="store_true",
                   help="textcls only: causal (lower-triangular) attention")
    p.add_argument("--text-vocab", type=int, default=256,
                   help="textcls only: vocabulary size (sizes the sharable "
                        "embedding table)")
    p.add_argument("--text-seq-len", type=int, default=64,
                   help="textcls only: sequence length (sizes the "
                        "positional embedding)")
    p.add_argument("--text-tokenizer", default="byte", choices=["byte", "hash"],
                   help="textcls real-data tokenizer (data/textfolder.py): "
                        "byte = UTF-8 bytes, vocab 258; hash = whitespace "
                        "hashing trick into --text-vocab")
    p.add_argument("--text-order-frac", type=float, default=0.0,
                   help="textcls only: fraction of each sequence replaced by "
                        "class-oriented token pairs (only their order "
                        "carries the class; pair with --text-causal)")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")


def _add_experiment(p, help):
    p.add_argument("--experiment", default="cifar100", choices=EXPERIMENTS,
                   help=help)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="cpg_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for cmd in ("sequence", "baseline", "packnet", "pae"):
        _add_common(sub.add_parser(cmd))
    pi = sub.add_parser("inference",
                        help="top-1 of one task of a checkpoint on its test "
                             "split")
    pi.add_argument("--checkpoint", required=True)
    pi.add_argument("--task-id", type=int, required=True)
    _add_experiment(pi, "the task data and eval preprocess")
    pi.add_argument("--num-tasks", type=int, default=0)
    pi.add_argument("--batch-size", type=int, default=128)
    pi.add_argument("--synthetic-train-per-class", type=int, default=100)
    pi.add_argument("--synthetic-test-per-class", type=int, default=20)
    pi.add_argument("--max-classes", type=int, default=None,
                    help="cap synthetic fine-grained class counts")
    _add_text_flags(pi)
    _add_device(pi)
    ps = sub.add_parser("stats",
                        help="ownership/capacity report for a checkpoint")
    ps.add_argument("--checkpoint", required=True)
    ps.add_argument("--per-layer", action="store_true",
                    help="include the per-layer ownership breakdown")
    _add_device(ps)
    pc = sub.add_parser("check",
                        help="audit a checkpoint against the CPG invariants "
                             "(core/invariants.py I1-I5); exit 1 if dirty")
    pc.add_argument("--checkpoint", required=True)
    pc.add_argument("--allow-transient", action="store_true",
                    help="skip I2 (zero free weights): for states saved "
                         "between grow_state and the next start_task")
    _add_device(pc)
    pe = sub.add_parser("export",
                        help="write a standalone serving artifact "
                             "(TaskServer.export)")
    pe.add_argument("--checkpoint", required=True)
    pe.add_argument("--out", required=True)
    pe.add_argument("--int8", action="store_true",
                    help="post-training-quantize the effective weights")
    pe.add_argument("--calibrate", default=None, metavar="NPZ",
                    help="int8 activation calibration set: npz with "
                         "{x: uint8 NHWC} (one batch for every task) or "
                         "{task<K>: batch} per task id; fixes static "
                         "per-layer activation scales so int8 logits are "
                         "batching-invariant (TaskServer.calibrate)")
    _add_experiment(pe, "eval preprocess applied during --calibrate")
    _add_device(pe)
    pt = sub.add_parser("import-torch",
                        help="convert a reference CPG .pth/.pth.tar "
                             "checkpoint (state_dict + masks + "
                             "shared_layer_info) into a checkpoint of this "
                             "package")
    pt.add_argument("--ckpt", required=True,
                    help="the torch.save file released by the reference")
    pt.add_argument("--arch", default="vgg16_bn_cifar")
    pt.add_argument("--out", required=True,
                    help="checkpoint directory to write")
    _add_device(pt)
    px = sub.add_parser("export-torch",
                        help="convert a checkpoint of this package into the "
                             "reference's torch.save layout (state_dict + "
                             "masks + shared_layer_info)")
    px.add_argument("--ckpt", required=True, help="checkpoint directory")
    px.add_argument("--arch", default=None,
                    help="override arch recorded in the checkpoint")
    px.add_argument("--out", required=True,
                    help=".pth/.pth.tar file to write via torch.save")
    _add_device(px)
    pv = sub.add_parser("serve",
                        help="batch inference from a serving artifact "
                             "(TaskServer.load): offline request-file mode, "
                             "or --http-port for the JSON endpoint")
    pv.add_argument("--artifact", required=True,
                    help="directory written by `export` / TaskServer.export")
    pv.add_argument("--requests", default=None,
                    help="npz with {x: uint8 NHWC} + either --task-id or a "
                         "per-row {task_ids: int32 (N,)} for mixed routing")
    pv.add_argument("--http-port", type=int, default=None,
                    help="serve the HTTP JSON API (server_http.py) on this "
                         "port instead of scoring a request file; blocks")
    pv.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="coalesce concurrent same-task HTTP requests that "
                         "arrive within this window into one predict call "
                         "(serve.DynamicBatcher); 0 = per-request dispatch")
    pv.add_argument("--task-id", type=int, default=None)
    pv.add_argument("--out", default=None,
                    help="write logits (+ per-row argmax) to this npz")
    _add_experiment(pv, "selects the eval preprocess for the artifact")
    pv.add_argument("--fused-chain", action="store_true",
                    help="run the BN+ReLU+conv3x3 seams through the fused "
                         "CUDA kernel (bf16 artifacts; off under int8)")
    pv.add_argument("--scoped-vmem-kib", type=int, default=None,
                    help="XLA's scoped-VMEM option: no port (stops with an "
                         "error)")
    _add_device(pv)
    return parser


def _prep(args):
    """The experiment's eval preprocess (tokens: none)."""
    from .data import augment as A

    return {"cifar100": A.cifar_eval_preprocess,
            "finegrained": A.imagenet_eval_preprocess,
            "face": A.face_eval_preprocess,
            "textcls": None}[args.experiment]


def _serve(args) -> int:
    from .serve import TaskServer

    if args.scoped_vmem_kib is not None:
        raise SystemExit("--scoped-vmem-kib: XLA compiler options (TPU/XLA "
                         "only; no port)")
    srv = TaskServer.load(args.artifact, preprocess_fn=_prep(args),
                          fused_chain=args.fused_chain, device=args.device)
    if args.http_port is not None:
        from .server_http import serve_http

        print(json.dumps({"serving": f"http://127.0.0.1:{args.http_port}",
                          "tasks": len(srv.state.tasks)}), flush=True)
        serve_http(srv, port=args.http_port, block=True,
                   batch_window_ms=args.batch_window_ms)
        return 0
    if args.requests is None:
        raise SystemExit("--requests or --http-port is required")
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


def _export(args) -> int:
    from .serve import TaskServer
    from .utils.checkpoint import load_state

    prep = _prep(args)
    state = load_state(args.checkpoint, device=args.device)
    srv = TaskServer(state, preprocess_fn=prep,
                     quantize="int8" if args.int8 else None,
                     device=args.device)
    calibrated = 0
    if args.calibrate:
        with np.load(args.calibrate) as z:
            z = dict(z)
        calib = ({int(k[4:]): v for k, v in z.items()
                  if k.startswith("task")} or z["x"])
        calibrated = len(srv.calibrate(calib))
    p = srv.export(args.out)
    print(json.dumps({"artifact": p, "tasks": state.num_tasks,
                      "quantize": srv.quantize,
                      "calibrated_tasks": calibrated}))
    return 0


def _import_torch(args) -> int:
    import torch

    from .core.state import resolve_device
    from .train.pretrained import convert_torch_cpg_checkpoint
    from .utils.checkpoint import save_state

    resolve_device(args.device)
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    state = convert_torch_cpg_checkpoint(ckpt, arch=args.arch,
                                         device=args.device)
    save_state(state, args.out)
    print(json.dumps({
        "out": args.out, "arch": state.arch,
        "tasks": {tid: {"name": t.name, "num_classes": t.num_classes}
                  for tid, t in state.tasks.items()},
        "width_mult": state.width_mult,
    }))
    return 0


def _export_torch(args) -> int:
    import torch

    from .train.export_torch import export_torch_cpg_checkpoint
    from .utils.checkpoint import load_state

    state = load_state(args.ckpt, device=args.device)
    if args.arch:
        state.arch = args.arch
    ckpt = export_torch_cpg_checkpoint(state)
    torch.save(ckpt, args.out)
    print(json.dumps({
        "out": args.out, "arch": state.arch,
        "tasks": ckpt["dataset_history"],
        "width_mult": ckpt["network_width_multiplier"],
        "state_dict_keys": len(ckpt["state_dict"]),
    }))
    return 0


def _check(args) -> int:
    from .core.invariants import check_state
    from .utils.checkpoint import load_state

    state = load_state(args.checkpoint, device=args.device)
    violations = check_state(
        state, strict=False,
        expect_zero_free=False if args.allow_transient else None)
    print(json.dumps({"checkpoint": args.checkpoint,
                      "arch": state.arch, "num_tasks": state.num_tasks,
                      "clean": not violations,
                      "violations": violations}, indent=1))
    return 1 if violations else 0


def _stats(args) -> int:
    from .utils.checkpoint import load_state

    state = load_state(args.checkpoint, device=args.device)
    own = {k: v.cpu().numpy() for k, v in state.ownership.items()}
    total = sum(v.size for v in own.values())
    out = {
        "arch": state.arch,
        "width_mult": state.width_mult,
        "num_tasks": state.num_tasks,
        "total_weights": int(total),
        "free_ratio": float(sum((v == 0).sum() for v in own.values())
                            / total),
        "tasks": {},
    }
    for tid, t in sorted(state.tasks.items()):
        owned = int(sum((v == tid).sum() for v in own.values()))
        out["tasks"][str(tid)] = {
            "name": t.name, "num_classes": t.num_classes,
            "owned_ratio": owned / total,
            "final_acc": t.meta.get("final_acc"),
            "chosen_ratio": t.meta.get("chosen_ratio"),
            "grew": t.meta.get("grew", 0),
        }
    if args.per_layer:
        out["layers"] = {
            k: {"shape": list(v.shape),
                "free": float((v == 0).mean()),
                **{f"task{t}": float((v == t).mean())
                   for t in sorted(state.tasks)}}
            for k, v in own.items()
        }
    print(json.dumps(out, indent=1))
    return 0


def _inference(args) -> int:
    import torch

    from .inference import make_predict_fn
    from .utils.checkpoint import load_state

    state = load_state(args.checkpoint, device=args.device)
    _, tasks, _, prep = _experiment_tasks(args)
    task = state.tasks[args.task_id]
    data = tasks[task.name]
    fn = make_predict_fn(state, args.task_id, preprocess_fn=prep,
                         device=args.device)
    x, y = data["test_x"], data["test_y"]
    bs = args.batch_size
    correct = total = 0
    # pad the tail to the batch shape and count only the valid prefix: the
    # whole test split is scored
    for s in range(0, len(x), bs):
        bx, nvalid = x[s:s + bs], len(x[s:s + bs])
        if nvalid < bs:
            bx = np.concatenate([bx, np.repeat(bx[-1:], bs - nvalid, 0)])
        logits = fn(torch.from_numpy(np.ascontiguousarray(bx)))
        logits = logits[0] if isinstance(logits, tuple) else logits
        pred = logits.argmax(1).cpu().numpy()[:nvalid]
        correct += int((pred == y[s:s + nvalid]).sum())
        total += nvalid
    print(json.dumps({"task_id": args.task_id, "task": task.name,
                      "top1": correct / max(total, 1), "n": total}))
    return 0


_TOOLS = {"serve": _serve, "export": _export, "import-torch": _import_torch,
          "export-torch": _export_torch, "check": _check, "stats": _stats,
          "inference": _inference}


def _pretrained_state(args, arch):
    """A fresh state whose task 1 ("imagenet", 1000 classes) holds the
    weights of --pretrained-npz: torch state_dict keys go through the
    arch's converter, all three trees kept (dropping the private one would
    adopt unit BN affines, not the pretrained net); keys of this package
    are shared kernels."""
    import torch

    from .train import pretrained as P
    from .train.sequence import init_state

    with np.load(args.pretrained_npz) as z:
        z = dict(z)
    st = init_state(arch, torch.Generator().manual_seed(args.seed),
                    width_mult=args.network_width_multiplier,
                    device=args.device)
    private = None
    if any("." in k for k in z):
        conv = {"resnet50": P.convert_torch_resnet50,
                "vgg16_bn_cifar": P.convert_torch_vgg16_bn,
                "spherenet20": P.convert_torch_spherenet20}.get(arch)
        if conv is None:
            raise SystemExit(f"--pretrained-npz with torch keys: no "
                             f"converter for arch {arch!r}")
        shared, private, bn = conv(z)
    else:
        shared, bn = z, None
    P.adopt_pretrained_task1(st, "imagenet", 1000, shared, private=private,
                             bn_state=bn)
    return st


def _cycle(args) -> int:
    from .core.state import resolve_device
    from .models import takes_tokens

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
    if args.pretrained_npz:
        init_kw["state"] = _pretrained_state(args, arch)
    if takes_tokens(arch) and "state" not in init_kw and tasks:
        # a fresh text state takes its table and positions from the task
        # data (real folders carry their tokenizer's vocab, synthetic
        # tasks the flag's), set every time: an id past the table would
        # be refused
        vocab = (max(t.get("vocab", 0) for t in tasks.values())
                 or args.text_vocab)
        seq_len = next(iter(tasks.values()))["train_x"].shape[1]
        init_kw["model_kwargs"] = {"vocab": int(vocab)}
        init_kw["batch_hw"] = (int(seq_len),)

    state, reports = runner(
        arch, tasks, _train_cfg(args), _seq_cfg(args), goals=goals,
        augment_fn=aug, preprocess_fn=prep,
        width_mult=args.network_width_multiplier,
        record_dir=args.record_dir, device=args.device, **init_kw)
    summary = {
        "avg_top1": sum(r.final_acc for r in reports) / max(len(reports), 1),
        "final_width_mult": state.width_mult,
        "tasks": [{"name": r.name, "top1": r.final_acc,
                   "ratio": r.chosen_ratio, "grew": r.grew}
                  for r in reports]}
    if args.experiment == "face" and state.num_tasks >= 1:
        summary["lfw_verification"] = _lfw_verification(state, prep,
                                                        args.device)
    print(json.dumps(summary))
    return 0


def _lfw_verification(state, prep, device):
    """LFW-protocol verification through task 1's embedding (head_type
    'none'): the official pairs when `$CPG_DATA_DIR/lfw/pairs.txt` exists
    (its header's fold count), else `cpg_tpu`'s synthetic stand-in (200
    pairs of 10 identities). {acc, std, source, n_pairs}."""
    import os

    from .data.face import (eval_pairs, load_lfw_pairs, make_pairs,
                            synthetic_faces)
    from .inference import make_predict_fn

    lfw_root = os.path.join(os.environ.get("CPG_DATA_DIR", ""), "lfw")
    pairs_txt = os.path.join(lfw_root, "pairs.txt")
    n_folds = 10
    if os.path.exists(pairs_txt):
        x, i1, i2, same = load_lfw_pairs(lfw_root)
        with open(pairs_txt) as f:
            head = f.readline().split()
        n_folds = int(head[0]) if len(head) == 2 else 10
        source = "lfw"
    else:
        x, yid = synthetic_faces(num_ids=10, per_id=8, seed=5)
        i1, i2, same = make_pairs(x, yid, n_pairs=200, seed=2)
        source = "synthetic"
    embed = make_predict_fn(state, 1, preprocess_fn=prep, device=device,
                            model_kwargs={"head_type": "none"})
    acc, std = eval_pairs(embed, x, i1, i2, same, n_folds=n_folds)
    return {"acc": acc, "std": std, "source": source,
            "n_pairs": int(len(same))}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd in _TOOLS:
        return _TOOLS[args.cmd](args)
    if args.preset:
        _apply_preset(args)

    from .utils import set_logger

    set_logger(args.logfile)
    return _cycle(args)
