"""The CPG train step and the task-conditioned evaluation step.

Semantics as `cpg_tpu.train.step` (`build_train_step`, `build_eval_step`).
One train step: augment -> masked forward (batch-statistics BatchNorm) ->
loss -> backward -> ownership gating + selective weight decay on the shared
gradients -> SGD with momentum on {shared, private} -> Adam on the gated
piggymask gradients -> free entries re-zeroed.

With `use_pallas_conv` the sharable convs of a task >= 2 select their
weights inside the masked-conv kernels (forward K1, backward K2/K3, whose
dW and dPM arrive gated), and with `use_pallas` the sharable dense layers
do the same through the dense route of those kernels (ops/masked_matmul.py);
with `use_fused_chain` the BN+ReLU+conv3x3 seams run the fused kernels
(forward K4, backward K5/K6); with `flash_attention` transformer attention
runs the flash kernels (K7, ops/flash.py). Otherwise the effective weights
are materialised and the layers go to cuDNN/cuBLAS through autograd.

PyTorch runs eagerly and has no buffer donation: the step updates the
parameter tensors and the optimizer states IN PLACE and returns the same
objects, in the JAX step's return order. The state tensors must live on the
step's device; x, y and injected augmentation draws are moved there.

Data parallelism (`group`, a torch.distributed process group; see
parallel/mesh.py `make_parallel_train_step`): x and y are this rank's rows
of the global batch, `rng` draws the global batch's augmentation and the
rank keeps its rows, BatchNorm takes the global batch's statistics, the raw
gradients are averaged over the ranks before the ownership gating and the
selective decay (so the decay is added once) and before clipping, and the
metrics are global means. Every rank then takes the same update.

The model axis (`shards`, {kernel key: ShardSpec}; see parallel/mesh.py
`make_parallel_train_step(model_sharded=True)`): shared, ownership,
piggymask and their optimizer moments hold this rank's slices, the model
runs each split layer on its slice (models/framework.py), and `group` is
the mesh's data group. The gating, the decay, the optimizer steps and the
re-zeroing of free entries act on each slice where it lies; the global
norm of clipping sums the slices' squares over the model group.

`cfg.act_sharder` splits the transformers' tokens (and an MoE layer's
experts) over the model group (models/framework.py); `cfg.pipeliner` runs
the block stack over stage ranks, one step a stage process on the same
state and batch (parallel/pipeline.py). Both leave the step's gradients
whole on every rank, so the rest of the step is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..core.gating import gate_and_decay, gate_piggymask_grads
from ..core.ownership import FREE
from ..core.state import resolve_device
from ..data.augment import Rows
from ..models import framework as fw
from ..ops.binarize import DEFAULT_THRESHOLD
from ..ops.masked import effective_params
from ..parallel.collectives import (all_reduce_mean_, all_reduce_sum_, rank,
                                    world_size)
from .losses import (accuracy, call_loss, class_logits, cross_entropy,
                     make_cross_entropy)


@dataclasses.dataclass
class TrainConfig:
    """The fields of `cpg_tpu.train.step.TrainConfig` that the port's steps
    read (the TPU/XLA-only ones are left out)."""

    lr: float = 0.01                # SGD lr for weights
    lr_mask: float = 1e-4           # Adam lr for piggymasks
    momentum: float = 0.9
    optimizer: str = "sgd"          # weights: 'sgd' (momentum) | 'adam';
                                    # decay is the selective L2 added to the
                                    # gradient (core/gating.py) either way
    weight_decay: float = 4e-5      # applied only to current-task weights
    threshold: float = DEFAULT_THRESHOLD
    compute_dtype: torch.dtype = torch.bfloat16
    label_smoothing: float = 0.0
    train_piggymask: bool = True    # False: PackNet mode, masks frozen
    grad_clip_norm: Optional[float] = None  # global norm, weights side
    use_pallas: bool = False        # masked dense kernels (ops/masked_matmul.py)
    use_pallas_conv: bool = False   # masked-conv kernels (ops/masked_conv.py)
    use_fused_chain: bool = False   # fused BN+ReLU+conv3x3 (ops/fused_chain.py)
    flash_attention: bool = False   # flash attention kernels (ops/flash.py)
    qkv_fused: Optional[bool] = None  # ViT q|k|v as one product on the
                                    # default path (models/vit.py); None:
                                    # off, as in `cpg_tpu`
    act_sharder: Optional[Any] = None  # activation sharding over the
                                    # mesh's model group (parallel/mesh.py
                                    # act_sharder): the "tokens" and
                                    # "experts" seams; None: whole
    pipeliner: Optional[Any] = None  # the block stack as a GPipe over
                                    # stage ranks (parallel/pipeline.py
                                    # make_pipeliner); None: inline

def _masking(cfg: TrainConfig, ownership, pm, task_id, mask_mode):
    """The raw-weight Masking of a step with masked kernels, else None."""
    if not (cfg.use_pallas or cfg.use_pallas_conv):
        return None
    return fw.Masking(ownership=ownership, piggymask=pm, task_id=int(task_id),
                      threshold=cfg.threshold, mask_mode=mask_mode,
                      pallas_dense=cfg.use_pallas,
                      pallas_conv=cfg.use_pallas_conv)


class Optimizer:
    """A torch.optim optimizer factory with optax's init/state split:
    `init(tree)` binds a fresh optimizer to the tensors of a (nested) dict
    and returns it as the optimizer state."""

    def __init__(self, make: Callable, lr: float):
        self.make, self.lr = make, lr

    def init(self, tree) -> torch.optim.Optimizer:
        return self.make(list(_leaves(tree)), self.lr)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def make_optimizers(cfg: TrainConfig):
    """(opt_w, opt_pm): SGD+momentum (torch.optim.SGD, dampening 0, no
    Nesterov, weight_decay 0: optax.sgd's trace) or Adam for the weights and
    private params, Adam (eps 1e-8) for the piggymasks. (The train step
    clips the weight side by `grad_clip_norm` before stepping.)"""
    if cfg.optimizer == "sgd":
        opt_w = Optimizer(lambda p, lr: torch.optim.SGD(
            p, lr=lr, momentum=cfg.momentum, dampening=0, nesterov=False,
            weight_decay=0), cfg.lr)
    elif cfg.optimizer == "adam":
        opt_w = Optimizer(lambda p, lr: torch.optim.Adam(p, lr=lr, eps=1e-8),
                          cfg.lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                         "(expected 'sgd' | 'adam')")
    opt_pm = Optimizer(lambda p, lr: torch.optim.Adam(p, lr=lr, eps=1e-8),
                       cfg.lr_mask)
    return opt_w, opt_pm


def set_lr(opt_state: torch.optim.Optimizer, lr):
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, split=(), group=None):
    """optax.clip_by_global_norm, in place: scale every gradient by
    max_norm / norm when the global norm is at least max_norm. `split`:
    gradients of slices whose squares are summed over `group` (the model
    group) first, so the norm is the whole tensors'."""
    sq = sum(torch.sum(g.float() ** 2) for g in grads)
    if split:
        sq = sq + all_reduce_sum_(torch.stack(
            [torch.sum(g.float() ** 2) for g in split]).sum(), group)
    norm = torch.sqrt(sq)
    grads = [*grads, *split]
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def build_train_step(model_fn: Callable, *, num_classes: int, mult: float,
                     has_piggymask: bool, cfg: TrainConfig,
                     augment_fn: Optional[Callable] = None,
                     loss_fn: Callable = cross_entropy,
                     model_kwargs: Optional[Dict] = None,
                     mask_mode: str = "binary", device="cuda"):
    """The train step plus its optimizers:

    step(shared, piggymask, private, bn_state, opt_w_state, opt_pm_state,
         ownership, task_id, x, y, rng, it=0, *, group=None, shards=None)
      -> (shared, piggymask, private, new_bn_state, opt_w_state,
          opt_pm_state, {"loss", "acc"})

    `rng` goes to `augment_fn(x, rng)` (a torch.Generator, or injected
    draws; see data/augment.py). opt states come from
    `opt_w.init({"shared": shared, "private": private})` and
    `opt_pm.init(piggymask)`. `group`: data-parallel over its ranks;
    `shards`: the split kernels of a model axis (see the module
    docstring)."""
    dev = resolve_device(device)
    opt_w, opt_pm = make_optimizers(cfg)
    model_kwargs = model_kwargs or {}
    if cfg.label_smoothing and loss_fn is cross_entropy:
        loss_fn = make_cross_entropy(cfg.label_smoothing)
    if (cfg.use_pallas or cfg.use_pallas_conv) and mask_mode == "packnet":
        raise ValueError(
            "PackNet mode (mask_mode='packnet') has no piggymasks to fuse — "
            "use the default path (use_pallas/use_pallas_conv=False)")

    def step(shared, piggymask, private, bn_state, opt_w_state, opt_pm_state,
             ownership, task_id, x, y, rng, it=0, *, group=None,
             shards=None):
        shards = shards or {}
        x = torch.as_tensor(x).to(dev)
        y = torch.as_tensor(y).to(dev)
        ranks = world_size(group)
        if ranks == 1:
            group = None
        if augment_fn is not None:
            if group is not None:  # this rank's rows of the global draws
                n, r = len(x), rank(group)
                rng = Rows(rng, n * ranks, slice(r * n, (r + 1) * n))
            x = augment_fn(x, rng)
        pm = piggymask if has_piggymask else None
        params = [*shared.values(), *private.values(),
                  *(pm.values() if pm is not None else ())]
        for p in params:
            p.grad = None
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                masking = _masking(cfg, ownership, pm, task_id, mask_mode)
                eff = shared if masking is not None else effective_params(
                    shared, ownership, pm, task_id, cfg.threshold,
                    compute_dtype=cfg.compute_dtype, mask_mode=mask_mode)
                logits, new_bn = fw.apply(
                    model_fn, eff, private, bn_state, x, train=True,
                    compute_dtype=cfg.compute_dtype, masking=masking,
                    fused_chain=cfg.use_fused_chain,
                    flash_attention=cfg.flash_attention,
                    qkv_fused=cfg.qkv_fused, sync_group=group,
                    shards=shards, act_sharder=cfg.act_sharder,
                    pipeline=cfg.pipeliner, num_classes=num_classes,
                    mult=mult, **model_kwargs)
                loss = call_loss(loss_fn, logits, y, it)
                loss.backward()
        finally:
            for p in params:
                p.requires_grad_(False)
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_mean_([p.grad for p in params], group)
            g_shared = gate_and_decay({k: w.grad for k, w in shared.items()},
                                      shared, ownership, task_id,
                                      cfg.weight_decay)
            if cfg.grad_clip_norm:
                model_group = next((s.group for s in shards.values()), None)
                clip_by_global_norm(
                    [*(g for k, g in g_shared.items() if k not in shards),
                     *(p.grad for p in private.values())],
                    cfg.grad_clip_norm,
                    split=[g_shared[k] for k in shards], group=model_group)
            opt_w_state.step()
            if pm is not None and cfg.train_piggymask:
                gate_piggymask_grads({k: m.grad for k, m in pm.items()},
                                     ownership, task_id)
                opt_pm_state.step()
            # released/free weights stay exactly zero (momentum could
            # otherwise drift them)
            for k, w in shared.items():
                w.masked_fill_(ownership[k] == FREE, 0)
            for p in params:
                p.grad = None
            means = torch.stack([loss.detach().float(), accuracy(
                class_logits(logits).detach(), y)])
            all_reduce_mean_([means], group)
            metrics = {"loss": means[0], "acc": means[1]}
        new_bn = {k: v.detach() for k, v in new_bn.items()}
        return (shared, piggymask, private, new_bn, opt_w_state, opt_pm_state,
                metrics)

    return step, (opt_w, opt_pm)


# the JAX package's name for its jitted step; PyTorch runs the step eagerly
make_train_step = build_train_step


def build_eval_step(model_fn: Callable, *, num_classes: int, mult: float,
                    has_piggymask: bool, cfg: TrainConfig,
                    preprocess_fn: Optional[Callable] = None,
                    model_kwargs: Optional[Dict] = None,
                    mask_mode: str = "binary", device="cuda"):
    """step(shared, piggymask, private, bn_state, ownership, task_id, x, y,
    *, shards=None) -> (logits, {"acc_sum", "loss"}). Only weights with
    0 < ownership <= task_id are visible, prior entries gated by the task's
    binarized piggymask; task-private BN stats and head. The state tensors
    must live on `device`; x and y are moved there. `shards`: the split
    kernels of a model axis (see `build_train_step`)."""
    dev = resolve_device(device)
    model_kwargs = model_kwargs or {}

    def step(shared, piggymask, private, bn_state, ownership, task_id, x, y,
             *, shards=None):
        x = torch.as_tensor(x).to(dev)
        y = torch.as_tensor(y).to(dev)
        if preprocess_fn is not None:
            x = preprocess_fn(x)
        pm = piggymask if has_piggymask else None
        masking = _masking(cfg, ownership, pm, task_id, mask_mode)
        eff = shared if masking is not None else effective_params(
            shared, ownership, pm, task_id, cfg.threshold,
            compute_dtype=cfg.compute_dtype, mask_mode=mask_mode)
        logits, _ = fw.apply(model_fn, eff, private, bn_state, x, train=False,
                             compute_dtype=cfg.compute_dtype, masking=masking,
                             fused_chain=cfg.use_fused_chain,
                             flash_attention=cfg.flash_attention,
                             qkv_fused=cfg.qkv_fused, shards=shards,
                             act_sharder=cfg.act_sharder,
                             pipeline=cfg.pipeliner,
                             num_classes=num_classes, mult=mult,
                             **model_kwargs)
        cl = class_logits(logits)
        return logits, {"acc_sum": (cl.argmax(-1) == y).sum(),
                        "loss": cross_entropy(cl, y)}

    return step


def make_eval_step(model_fn: Callable, **kwargs):
    """The eval step run under `torch.inference_mode()` (no jit: PyTorch
    runs eagerly). Defaults to device='cuda'."""
    step = build_eval_step(model_fn, **kwargs)

    def run(*args, **kw):
        with torch.inference_mode():
            return step(*args, **kw)

    return run
