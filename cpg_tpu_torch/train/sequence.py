"""The full compact-pick-grow cycle as one programmatic API.

The counterpart of `cpg_tpu.train.sequence`, with the same names, options
and decisions: for each task, pick (train the piggymask and the free
capacity); if the goal is missed, roll back, grow the width by
`growth_step` and pick again, up to `max_width_mult`; then compact: walk
the prune ratios, keep the largest that meets the goal, and write the
ratio -> accuracy record.

Random inits (`init_state`, `start_task`, `grow_state`, `reinit_free`)
draw from CPU `torch.Generator`s seeded as `cpg_tpu` seeds its keys
(`seq.seed` for the state, `seq.seed + tasks so far + 1` for a task), so a
state is the same for a seed whatever device it then lives on. A call that
draws more than once (`start_task` with `reinit_free`, `grow_state`) gives
each `init` a fresh generator seeded with the caller's seed
(`rng.initial_seed()`), as `cpg_tpu` reuses its key, so no draw depends on
the draws before it. Two seams let a
caller hand in other values: `init_fn`, called as `fw.init` is
(`init_fn(generator, model_fn, sample_x, **kwargs) -> (shared, private,
bn_state)`), and `draws`, the Manager's augmentation draws
(train/manager.py).

Every entry point runs on `device` (default the card; raises without one).
Snapshots are host copies (`clone`d even when the state is on the CPU, so
an in-place step cannot change them), and every restore copies them back
to the device. With the conv kernels on (`use_pallas_conv`,
`use_fused_chain`), widths the kernels would refuse mid-cycle are refused
up front (`refuse_kernel_widths`), each check keyed to the flag and dtype
that need it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import grow as grow_mod
from ..core.ownership import assign_free_to_task, free_ratio, init_ownership
from ..core.pruner import snapshot_owned_counts
from ..core.state import CPGState, TaskEntry, resolve_device
from ..models import framework as fw
from ..models import get_flatten_dims, get_model
from ..models.resnet import conv_channels as resnet_conv_channels
from ..models.resnet import widest_seam as resnet_widest_seam
from ..models.spherenet import conv_channels as sphere_conv_channels
from ..models.spherenet import embed_dim as sphere_embed_dim
from ..models.vgg import conv_channels as vgg_conv_channels
from ..models.vit import dense_outputs as vit_dense_outputs
from ..ops.binarize import init_piggymask
from ..utils import LOGGER
from ..utils.checkpoint import (load_state, remove_after_save, save_state,
                                wait_for_saves)
from .manager import Manager, on_device
from .step import TrainConfig

log = logging.getLogger(LOGGER)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def snapshot(state: CPGState) -> CPGState:
    """A host copy of `state`: every tensor cloned to the CPU (a clone even
    when it already lives there), the task metas copied."""
    return state.map_arrays(lambda t: t.detach().to("cpu", copy=True))


def _restore(state: CPGState, snap: CPGState, dev: torch.device) -> None:
    """Make `state` a device copy of the snapshot `snap`."""
    state.__dict__.update(
        snap.map_arrays(lambda t: t.to(dev, copy=True)).__dict__)


def _state_device(state: CPGState) -> torch.device:
    return next(iter(state.shared.values())).device


def _to(tree, dev):
    return {k: v.to(dev) for k, v in tree.items()}


def _fresh(rng: torch.Generator) -> torch.Generator:
    """A new generator at the caller's seed: one for each draw of a call."""
    return _generator(rng.initial_seed())


# archs whose sharable convs scale with the width and reach the conv
# kernels: (the channel counts of the convs' outputs at a width, the width
# of the widest fused seam for an (H, W, C) input, or None for an arch
# without seams). VGG16-BN's 13 convs and 8 fused seams, the first at the
# input's width; ResNet-50's 53 convs and 13 fused seams, the widest after
# the stride-2 stem and max pool; SphereNet-20's 20 convs (no BatchNorm,
# so no seam). The ViTs' one conv, the patch embedding, keeps its embed
# dim at every width.
_CONV_CHANNELS = {
    "vgg16_bn_cifar": (vgg_conv_channels, lambda in_shape: in_shape[1]),
    "resnet50": (resnet_conv_channels, resnet_widest_seam),
    "spherenet20": (sphere_conv_channels, None),
}
# the transformers' dim, heads and MLP ratio by default (the arch's
# model_kwargs override them): their sharable dense layers' outputs scale
# with the width by `vit.dense_outputs`
_TRANSFORMER_DIMS = {
    "vit_cifar": dict(dim=256, heads=4, mlp_ratio=4),
    "vit_b16": dict(dim=768, heads=12, mlp_ratio=4),
    "textcls": dict(dim=128, heads=4, mlp_ratio=4),
    "vit_moe_cifar": dict(dim=256, heads=4, mlp_ratio=4),
}


def _dense_outputs(arch: str, model_kwargs: Optional[Dict]):
    """mult -> the output widths of the arch's sharable dense layers that
    scale with the width (SphereNet-20's fc5; the transformers' heads and
    MLP units), or None for an arch without such layers."""
    if arch == "spherenet20":
        return lambda m: [sphere_embed_dim(m)]
    if arch not in _TRANSFORMER_DIMS:
        return None
    dims = dict(_TRANSFORMER_DIMS[arch])
    dims.update({k: v for k, v in (model_kwargs or {}).items() if k in dims})
    return lambda m: vit_dense_outputs(m, **dims)


def refuse_kernel_widths(cfg: Optional[TrainConfig], arch: str, mults,
                         in_shape, model_kwargs: Optional[Dict] = None
                         ) -> None:
    """Raise ValueError for widths the kernels that `cfg` turns on would
    refuse mid-cycle, each check keyed to the flag and dtype that need it:
    under `use_fused_chain` a fused seam wider than 128 (the fused chain's
    W limit, any dtype) or, in bf16, a channel count off a multiple of 8;
    under `use_pallas_conv` in bf16, a Cout off a multiple of 4; under
    `use_pallas` in bf16, a dense output off a multiple of 4 (off a
    multiple of 8 the dense route runs the masked conv at 1x1), the
    transformers' widths sized by `model_kwargs`. f32 steps have no channel
    limit, and the masked conv no width limit."""
    if cfg is None:
        return
    checks = []  # (flag, needed multiple, channel counts at a width)
    if arch in _CONV_CHANNELS:
        channels, widest_seam = _CONV_CHANNELS[arch]
        fused = cfg.use_fused_chain and widest_seam is not None
        if fused and len(in_shape) == 3 and widest_seam(in_shape) > 128:
            raise ValueError(
                f"input width {in_shape[1]} gives a fused seam "
                f"{widest_seam(in_shape)} wide, over 128: the fused "
                "BN+ReLU+conv kernel takes W <= 128 (use_fused_chain)")
        if fused:
            checks.append(("use_fused_chain", 8, channels))
        elif cfg.use_pallas_conv:
            checks.append(("use_pallas_conv", 4, channels))
    dense = _dense_outputs(arch, model_kwargs)
    if cfg.use_pallas and dense is not None:
        checks.append(("use_pallas", 4, dense))
    if cfg.compute_dtype != torch.bfloat16:
        return
    for flag, need, channels in checks:
        for m in mults:
            bad = sorted({c for c in channels(m) if c % need})
            if bad:
                raise ValueError(
                    f"width multiplier {m} gives bf16 channel counts {bad}: "
                    f"{flag} needs multiples of {need}")


def growth_ladder(width_mult: float, seq: "SequenceConfig") -> List[float]:
    """Every width multiplier a task can grow to from `width_mult`."""
    out, m = [], width_mult
    while True:
        nxt = round(m + seq.growth_step, 4)
        if nxt <= m or nxt > seq.max_width_mult + 1e-9:
            return out
        out.append(nxt)
        m = nxt


def init_state(arch: str, rng: torch.Generator, width_mult: float = 1.0,
               batch_hw=None, mask_mode: str = "binary",
               model_kwargs: dict = None, *, device="cuda",
               cfg: Optional[TrainConfig] = None,
               init_fn: Optional[Callable] = None) -> CPGState:
    """Fresh CPG state on `device`: shared weights initialised, everything
    free. mask_mode: 'binary' | 'ternary' | 'packnet'.

    model_kwargs: arch-level forward kwargs that size the shared kernels
    (stored on the state, applied at every later init and apply);
    batch_hw: the per-example input shape when not the registry's. With
    `cfg`'s conv kernels on, refuses widths they would reject."""
    dev = resolve_device(device)
    model_fn, in_shape = get_model(arch)
    shape = tuple(batch_hw or in_shape)
    refuse_kernel_widths(cfg, arch, [width_mult], shape, model_kwargs)
    shared, _, _ = (init_fn or fw.init)(
        rng, model_fn, torch.zeros((1, *shape)), num_classes=2,
        mult=width_mult, **(model_kwargs or {}))
    shared = _to(shared, dev)
    return CPGState(arch=arch, width_mult=width_mult, shared=shared,
                    ownership=init_ownership(shared), mask_mode=mask_mode,
                    model_kwargs=dict(model_kwargs or {}),
                    in_shape=tuple(batch_hw) if batch_hw is not None else None)


def start_task(state: CPGState, name: str, num_classes: int,
               rng: torch.Generator, reinit_free: bool = False,
               model_kwargs: dict = None, *,
               init_fn: Optional[Callable] = None) -> int:
    """Add task k: claim free capacity, create the piggymask over prior-task
    weights (k > 1, not in packnet mode), fresh task-private params.
    `reinit_free` puts fresh init values on the claimed entries that are
    zero (released by pruning); its two draws each take a fresh generator
    at `rng`'s seed."""
    init = init_fn or fw.init
    model_fn, in_shape = get_model(state.arch)
    x = torch.zeros((1, *(state.in_shape or in_shape)))
    dev = _state_device(state)
    task_id = state.num_tasks + 1
    state.ownership = assign_free_to_task(state.ownership, task_id)
    merged_kwargs = state.forward_kwargs(override=model_kwargs or {})
    if reinit_free:
        fresh, _, _ = init(_fresh(rng), model_fn, x, num_classes=num_classes,
                           mult=state.width_mult, **merged_kwargs)
        state.shared = {
            k: torch.where((state.ownership[k] == task_id) & (w == 0),
                           fresh[k].to(dev), w)
            for k, w in state.shared.items()}
    piggymask = ({k: init_piggymask(w.shape, device=dev)
                  for k, w in state.shared.items()}
                 if task_id > 1 and state.mask_mode != "packnet" else None)
    _, private, bn_state = init(_fresh(rng) if reinit_free else rng,
                                model_fn, x, num_classes=num_classes,
                                mult=state.width_mult, **merged_kwargs)
    state.tasks[task_id] = TaskEntry(
        name=name, num_classes=num_classes, piggymask=piggymask,
        private=_to(private, dev), bn_state=_to(bn_state, dev),
        meta={"model_kwargs": model_kwargs} if model_kwargs else {})
    return task_id


def grow_state(state: CPGState, new_mult: float, rng: torch.Generator,
               flatten_dims="auto", *, device="cuda",
               cfg: Optional[TrainConfig] = None,
               init_fn: Optional[Callable] = None) -> CPGState:
    """Widen the network to `new_mult` on `device`, preserving all existing
    tasks exactly.

    flatten_dims: "auto" resolves the arch's registered flatten-permutation
    layers (models.FLATTEN_DIMS); pass a dict or None to override. With
    `cfg`'s conv kernels on, refuses a width they would reject. Each draw
    (the shared weights, then each task's private params) takes a fresh
    generator at `rng`'s seed."""
    init = init_fn or fw.init
    if flatten_dims == "auto":
        flatten_dims = get_flatten_dims(state.arch)
    model_fn, in_shape = get_model(state.arch)
    shape = tuple(state.in_shape or in_shape)
    refuse_kernel_widths(cfg, state.arch, [new_mult], shape,
                         state.model_kwargs)
    dev = resolve_device(device)
    on_device(state, dev)
    x = torch.zeros((1, *shape))
    fresh_shared, _, _ = init(_fresh(rng), model_fn, x, num_classes=2,
                              mult=new_mult, **state.forward_kwargs())
    pms = {tid: t.piggymask for tid, t in state.tasks.items()}
    shared, ownership, new_pms = grow_mod.grow_shared(
        state.shared, state.ownership, _to(fresh_shared, dev), pms,
        flatten_dims)
    state.shared, state.ownership, state.width_mult = shared, ownership, new_mult
    for tid, t in state.tasks.items():
        t.piggymask = new_pms[tid]
        _, fresh_priv, fresh_bn = init(
            _fresh(rng), model_fn, x, num_classes=t.num_classes, mult=new_mult,
            **state.forward_kwargs(tid))
        t.private = grow_mod.grow_private(t.private, fresh_priv)
        t.bn_state = grow_mod.grow_private(t.bn_state, fresh_bn)
    return state


@dataclasses.dataclass
class SequenceConfig:
    """One task's schedule; the fields of `cpg_tpu`'s SequenceConfig."""
    finetune_epochs: int = 30
    prune_epochs: int = 10
    retrain_epochs: int = 10          # retrain after each candidate ratio
    prune_ratios: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                                     0.9)
    allow_acc_diff: float = 0.005
    growth_step: float = 0.5           # multiplier += 0.5
    max_width_mult: float = 2.0
    batch_size: int = 128
    lr: float = 0.01
    lr_mask: float = 1e-4
    on_goal_miss: str = "accept"       # 'accept' best effort | 'abort'
    compact_mode: str = "incremental"  # 'incremental' | 'restart'
    reinit_free: bool = False
    prune_freq: int = 20
    seed: int = 0
    lr_schedule: str = "cosine"        # 'cosine' | 'constant' | 'step' |
                                       # 'warmup_cosine'
    growth_epoch_scale: float = 0.0    # every phase's epochs x
    # (1 + growth_epoch_scale * (width_mult - 1)); 0.0 = fixed budgets
    checkpoint_dir: Optional[str] = None  # checkpoints at phase boundaries
    resume: bool = True                # skip tasks with a final checkpoint
    epoch_checkpoint_freq: int = 0     # >0: `<prefix>.epoch` checkpoint
    # every N epochs of the pick phase; optimizers are rebuilt on resume
    native_loader: bool = False        # not ported yet: raises
    jsonl_path: Optional[str] = None   # structured per-phase JSONL metrics
    verify_growth: bool = True         # audit every growth event: old-task
    # logits on a probe batch must survive grow_state within
    # max|d| <= atol + rtol * max(1, max|logits|) (a wrong embedding gives
    # diffs on the order of the logits themselves)
    verify_growth_rtol: float = 1e-2
    verify_growth_atol: float = 1e-3


def _scaled_epochs(n: int, seq: SequenceConfig, state: CPGState) -> int:
    """Width-aware epoch budget: linear ramp in the width multiplier
    controlled by seq.growth_epoch_scale (0.0 = fixed)."""
    scale = 1.0 + seq.growth_epoch_scale * (state.width_mult - 1.0)
    return max(1, int(round(n * scale)))


@dataclasses.dataclass
class TaskReport:
    task_id: int
    name: str
    pick_acc: float
    final_acc: float
    chosen_ratio: float
    ratio_to_acc: Dict[float, float]
    width_mult: float
    grew: int
    images_per_sec: float
    # one entry per growth event: {"width_mult", "task_id", "max_abs_diff",
    # "bound"} from the growth audit (empty without growth or audit)
    growth_audit: List[Dict] = dataclasses.field(default_factory=list)


def _growth_audit(state, data, preprocess_fn, dev, seq, new_mult, grow):
    """Run `grow()` and hold every task's logits on a probe batch to the
    scale-aware bound; returns the audit rows."""
    if not (seq.verify_growth and state.tasks):
        grow()
        return []
    from ..inference import predict

    px = torch.as_tensor(np.asarray(data["test_x"][:8])).to(dev)
    if preprocess_fn is not None:
        px = preprocess_fn(px)
    def probe(tid):  # an angle head's (cos, phi) pair, stacked
        out = predict(state, tid, px, device=dev)
        return (torch.stack(out) if isinstance(out, tuple) else out).cpu()

    before = {tid: probe(tid) for tid in state.tasks}
    grow()
    rows = []
    for tid, b in before.items():
        after = probe(tid)
        maxd = float((b - after).abs().max())
        scale = max(1.0, float(b.abs().max()))
        bound = seq.verify_growth_atol + seq.verify_growth_rtol * scale
        if maxd > bound:
            raise RuntimeError(
                f"growth to mult {new_mult} changed task {tid} predictions "
                f"(max |d|={maxd:.3e} > {bound:.3e} at logit scale "
                f"{scale:.2f}) — embedding/flatten_dims bug")
        log.info("growth audit: task %d preds preserved (max |d|=%.2e, "
                 "scale %.2f)", tid, maxd, scale)
        rows.append({"width_mult": new_mult, "task_id": tid,
                     "max_abs_diff": maxd, "bound": bound})
    return rows


def run_task(state: CPGState, name: str, data: Dict, cfg: TrainConfig,
             seq: SequenceConfig, goal_acc: Optional[float] = None,
             augment_fn=None, preprocess_fn=None,
             record_path: Optional[str] = None, mesh=None,
             checkpoint_prefix: Optional[str] = None,
             pick_state: Optional[CPGState] = None,
             epoch_state: Optional[CPGState] = None, *, device="cuda",
             init_fn: Optional[Callable] = None,
             draws: Optional[Callable] = None) -> TaskReport:
    """One full CPG task cycle: pick (train) -> [grow + retry] -> compact.

    With `checkpoint_prefix`, the post-pick state is checkpointed
    (`<prefix>.pick`) before the compact walk, and with
    `seq.epoch_checkpoint_freq` the pick phase every N epochs
    (`<prefix>.epoch`). `pick_state` (a restored `.pick` checkpoint) skips
    the pick and re-enters the walk with fresh optimizers; `epoch_state` (a
    restored `.epoch` checkpoint) re-enters an interrupted pick at its
    saved epoch."""
    dev = resolve_device(device)
    on_device(state, dev)
    model_fn, _ = get_model(state.arch)
    seed = seq.seed + state.num_tasks + 1
    pre_task = snapshot(state)
    grew = 0
    audit: List[Dict] = []
    mgr_kw = dict(batch_size=seq.batch_size, augment_fn=augment_fn,
                  preprocess_fn=preprocess_fn, seed=seq.seed,
                  loss_fn=data.get("loss_fn"), lr_schedule=seq.lr_schedule,
                  native_loader=seq.native_loader, jsonl_path=seq.jsonl_path,
                  mesh=mesh, draws=draws, device=dev)

    if pick_state is not None:
        # ---- resume past the pick: adopt the post-pick checkpoint ----------
        _restore(state, pick_state, dev)
        task_id = state.num_tasks
        meta = state.tasks[task_id].meta
        pick_acc, grew = meta.get("pick_acc", float("nan")), meta.get("grew", 0)
        mgr = Manager(state, model_fn, task_id, data, cfg, **mgr_kw)
        log.info("task %d (%s): resumed post-pick (acc=%.4f, mult=%.2f) — "
                 "re-entering the compact walk", task_id, name, pick_acc,
                 state.width_mult)
        return _compact(state, name, data, cfg, seq, goal_acc, mgr, mgr_kw,
                        model_fn, task_id, pick_acc, grew, record_path, dev,
                        audit)

    # ---- PICK (train masks + free capacity), growing on goal miss ----------
    start_epoch, resume_it = 0, 0
    if epoch_state is not None:
        er = epoch_state.tasks[epoch_state.num_tasks].meta.get("_epoch_resume")
        if er:
            _restore(state, epoch_state, dev)
            grew = int(er.get("grew", 0))
            start_epoch, resume_it = int(er["epoch"]), int(er["it"])
            log.info("task %s: resuming interrupted pick at epoch %d (it=%d, "
                     "mult=%.2f)", name, start_epoch, resume_it,
                     state.width_mult)
    while True:
        if start_epoch:
            task_id = state.num_tasks  # task already in the restored state
        else:
            task_id = start_task(state, name, data["num_classes"],
                                 _generator(seed),
                                 reinit_free=seq.reinit_free,
                                 model_kwargs=data.get("model_kwargs"),
                                 init_fn=init_fn)
        mgr = Manager(state, model_fn, task_id, data, cfg, **mgr_kw)
        mgr.it = resume_it
        epoch_cb = None
        if checkpoint_prefix and seq.epoch_checkpoint_freq > 0:
            def epoch_cb(completed, _mgr=mgr, _tid=task_id, _grew=grew):
                if completed % seq.epoch_checkpoint_freq:
                    return
                state.tasks[_tid].meta["_epoch_resume"] = {
                    "epoch": completed, "it": _mgr.it, "grew": _grew}
                save_state(state, checkpoint_prefix + ".epoch")

        res = mgr.train(_scaled_epochs(seq.finetune_epochs, seq, state),
                        base_lr=seq.lr, start_epoch=start_epoch,
                        epoch_callback=epoch_cb)
        start_epoch = resume_it = 0  # only the first attempt resumes
        state.tasks[task_id].meta.pop("_epoch_resume", None)
        pick_acc = res.acc
        goal = (goal_acc - seq.allow_acc_diff) if goal_acc is not None else None
        log.info("task %d (%s): pick acc=%.4f goal=%s mult=%.2f",
                 task_id, name, pick_acc, goal, state.width_mult)
        if goal is None or pick_acc >= goal:
            break
        new_mult = round(state.width_mult + seq.growth_step, 4)
        if new_mult > seq.max_width_mult + 1e-9:
            if seq.on_goal_miss == "abort":
                raise RuntimeError(
                    f"task {name}: goal {goal:.4f} unreachable at max width "
                    f"multiplier {seq.max_width_mult}")
            log.warning("task %s: accepting best-effort acc %.4f", name,
                        pick_acc)
            break
        # GROW: roll this task back, widen, redo the pick
        grew += 1
        _restore(state, pre_task, dev)
        audit += _growth_audit(
            state, data, preprocess_fn, dev, seq, new_mult,
            lambda: grow_state(state, new_mult, _generator(seed), device=dev,
                               cfg=cfg, init_fn=init_fn))
        log.info("task %s: growing width multiplier -> %.2f", name, new_mult)

    if checkpoint_prefix:
        # phase-boundary checkpoint: a crash during the compact walk resumes
        # here instead of redoing pick and growth
        state.tasks[task_id].meta.update(pick_acc=pick_acc, grew=grew)
        save_state(state, checkpoint_prefix + ".pick")
        # any intra-pick .epoch checkpoint is superseded once .pick lands
        remove_after_save(checkpoint_prefix + ".epoch")

    return _compact(state, name, data, cfg, seq, goal_acc, mgr, mgr_kw,
                    model_fn, task_id, pick_acc, grew, record_path, dev, audit)


def _compact(state, name, data, cfg, seq, goal_acc, mgr, mgr_kw, model_fn,
             task_id, pick_acc, grew, record_path, dev,
             audit) -> TaskReport:
    # ---- COMPACT: walk prune ratios, keep the largest meeting the goal -----
    # Without a goal the pick accuracy is the goal. When the pick missed
    # the goal (on_goal_miss='accept'), the walk's goal is the best-effort
    # accuracy, not the unreached one: otherwise the first ratio fails, the
    # incremental walk stops at 0.0, and the task keeps the whole free pool.
    goal = ((min(goal_acc, pick_acc) if goal_acc is not None else pick_acc)
            - seq.allow_acc_diff)
    post_pick = snapshot(state)
    n0_task = {k: int(v) for k, v in snapshot_owned_counts(
        state.ownership, task_id).items()}
    ratio_to_acc: Dict[float, float] = {}
    best_ratio, best_state, best_acc = 0.0, post_pick, pick_acc
    res = None
    for ratio in seq.prune_ratios:
        if seq.compact_mode == "restart":
            _restore(state, post_pick, dev)
            mgr = Manager(state, model_fn, task_id, data, cfg, **mgr_kw)
        res = mgr.train(
            _scaled_epochs(seq.prune_epochs + seq.retrain_epochs, seq, state),
            base_lr=seq.lr * 0.1, prune_to=ratio, prune_freq=seq.prune_freq,
            prune_end_frac=seq.prune_epochs
            / max(seq.prune_epochs + seq.retrain_epochs, 1),
            prune_n0=n0_task)  # ratios are absolute fractions of post-pick
        ratio_to_acc[ratio] = res.acc
        log.info("task %s: ratio %.2f -> acc %.4f", name, ratio, res.acc)
        if goal is None or res.acc >= goal:
            best_ratio, best_acc = ratio, res.acc
            best_state = snapshot(state)
        elif seq.compact_mode == "incremental":
            break  # monotone: more pruning won't recover the goal

    _restore(state, best_state, dev)
    state.tasks[task_id].meta.update(
        ratio_to_acc={str(k): v for k, v in ratio_to_acc.items()},
        chosen_ratio=best_ratio, pick_acc=pick_acc, final_acc=best_acc,
        grew=grew)
    if record_path:
        os.makedirs(os.path.dirname(record_path) or ".", exist_ok=True)
        with open(record_path, "w") as f:
            json.dump({str(k): v for k, v in ratio_to_acc.items()}, f)

    return TaskReport(
        task_id=task_id, name=name, pick_acc=pick_acc, final_acc=best_acc,
        chosen_ratio=best_ratio, ratio_to_acc=ratio_to_acc,
        width_mult=state.width_mult, grew=grew,
        images_per_sec=res.images_per_sec if res is not None else 0.0,
        growth_audit=audit)


def _try_load(path: str, dev) -> Optional[CPGState]:
    """The checkpoint at `path`, or None when it is absent or cannot load
    (a crash landed mid-write): that phase is then redone."""
    if not os.path.exists(os.path.join(path, "cpg_meta.json")):
        return None
    try:
        return load_state(path, device=dev)
    except (OSError, RuntimeError, EOFError, ValueError, KeyError,
            pickle.UnpicklingError) as e:
        log.warning("checkpoint %s unreadable (%s: %s) — redoing that phase",
                    path, type(e).__name__, e)
        return None


def run_sequence(arch: str, tasks: Dict[str, Dict],
                 cfg: Optional[TrainConfig] = None,
                 seq: Optional[SequenceConfig] = None,
                 goals: Optional[Dict[str, float]] = None, augment_fn=None,
                 preprocess_fn=None, rng: Optional[torch.Generator] = None,
                 width_mult: float = 1.0, record_dir: Optional[str] = None,
                 state: Optional[CPGState] = None, mesh=None,
                 model_kwargs: Optional[Dict] = None, batch_hw=None, *,
                 device="cuda", init_fn: Optional[Callable] = None,
                 draws: Optional[Callable] = None
                 ) -> Tuple[CPGState, List[TaskReport]]:
    """The whole multi-task CPG run (the reference's experiment-1 loop).

    Pass `state` to continue an existing model. `model_kwargs` and
    `batch_hw` size a fresh state's shared kernels; ignored with `state`.
    With `seq.checkpoint_dir`, each task's final state is saved as
    `task<NN>_<name>` and a rerun resumes from the final, `.pick` and
    `.epoch` checkpoints it finds."""
    cfg = cfg or TrainConfig()
    seq = seq or SequenceConfig()
    dev = resolve_device(device)
    if mesh is not None:
        raise ValueError(
            "run_sequence(mesh=...): multi-device training is not ported yet "
            "(ROADMAP Queue 1, item 12)")
    if seq.native_loader:
        raise ValueError("SequenceConfig.native_loader: the native prefetch "
                         "loader is not ported yet (ROADMAP Queue 1, item 12)")
    if state is not None and state.arch != arch:
        raise ValueError(f"state arch {state.arch} != {arch}")
    start_mult = state.width_mult if state is not None else width_mult
    shape = ((state.in_shape if state is not None else batch_hw)
             or get_model(arch)[1])
    kwargs = state.model_kwargs if state is not None else model_kwargs
    refuse_kernel_widths(cfg, arch,
                         [start_mult, *growth_ladder(start_mult, seq)],
                         tuple(shape), kwargs)
    rng = _generator(seq.seed) if rng is None else rng
    if state is None:
        state = init_state(arch, rng, width_mult=width_mult,
                           batch_hw=batch_hw, model_kwargs=model_kwargs,
                           device=dev, init_fn=init_fn)
    else:
        on_device(state, dev)
    reports = []
    base = state.num_tasks
    for ti, (name, data) in enumerate(tasks.items()):
        tid_expected = base + ti + 1
        ck = (os.path.join(seq.checkpoint_dir, f"task{tid_expected:02d}_{name}")
              if seq.checkpoint_dir else None)
        pick_state = epoch_state = None
        # ---- resume: skip tasks whose final checkpoint exists --------------
        if ck and seq.resume:
            restored = _try_load(ck, dev)
            if restored is not None and restored.num_tasks == tid_expected:
                state = restored
                m = restored.tasks[tid_expected].meta
                reports.append(TaskReport(
                    task_id=tid_expected, name=name,
                    pick_acc=m.get("pick_acc", float("nan")),
                    final_acc=m.get("final_acc", float("nan")),
                    chosen_ratio=m.get("chosen_ratio", 0.0),
                    ratio_to_acc=m.get("ratio_to_acc", {}),
                    width_mult=restored.width_mult, grew=m.get("grew", 0),
                    images_per_sec=0.0))
                log.info("task %d/%s: resumed from %s", tid_expected, name, ck)
                continue
            # ---- phase-granular resume: pick done, compact interrupted -----
            restored = _try_load(ck + ".pick", dev)
            if restored is not None and restored.num_tasks == tid_expected:
                pick_state = restored
            elif seq.epoch_checkpoint_freq > 0:
                # ---- epoch-granular resume: pick itself interrupted --------
                restored = _try_load(ck + ".epoch", dev)
                if restored is not None and restored.num_tasks == tid_expected:
                    epoch_state = restored
        rec = (os.path.join(record_dir, f"ratio_acc_{name}.json")
               if record_dir else None)
        rep = run_task(state, name, data, cfg, seq,
                       goal_acc=(goals or {}).get(name),
                       augment_fn=augment_fn, preprocess_fn=preprocess_fn,
                       record_path=rec, checkpoint_prefix=ck,
                       pick_state=pick_state, epoch_state=epoch_state,
                       device=dev, init_fn=init_fn, draws=draws)
        reports.append(rep)
        if ck:
            save_state(state, ck)
            # the transient phase checkpoints are superseded by the final one
            remove_after_save(ck + ".pick")
            remove_after_save(ck + ".epoch")
        log.info("task %d/%s done: acc=%.4f ratio=%.2f mult=%.2f free=%.3f",
                 rep.task_id, name, rep.final_acc, rep.chosen_ratio,
                 rep.width_mult, float(free_ratio(state.ownership)))
    if seq.checkpoint_dir:
        wait_for_saves()
    return state, reports
