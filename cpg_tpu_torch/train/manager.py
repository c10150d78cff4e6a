"""Manager: train / eval / prune-retrain loops over the train and eval steps.

The counterpart of `cpg_tpu.train.manager`: epoch loops, accuracy metering,
LR scheduling, and gradual pruning driven from the host. The step updates
the parameters and optimizer states in place (train/step.py), so a prune
event writes into the same live tensors (`pruner.gradual_prune_`): the
optimizers keep their references and SGD's momentum carries across events,
as the JAX step keeps its optimizer state.

Random draws: the batch order comes from `np.random.RandomState(seed)`, as
in `cpg_tpu`; the augmentation draws from a seeded `torch.Generator`
unless `draws` is given. `draws(seed)` returns a callable `n -> rng` that
the Manager calls once a step for the `rng` of `augment_fn(x, rng)`, so a
caller can hand in another package's draws (data/augment.py takes
`(offsets, flips)` arrays).

Training batches come from the C++ loader with `native_loader`
(data/native_loader.py: one loader a Manager, seeded with `seed`, whose
epochs wrap inside it), else from the NumPy gather; either way they pass
through `DevicePrefetcher` onto the Manager's device. Both read memmapped
datasets (data/stream.py) through the map.

Data parallelism (`mesh`, parallel/mesh.py, built under a process group):
every rank runs a Manager over the same data and seed on its own device.
The state is broadcast from rank 0 at construction, every rank walks the
same global batch order and keeps its rows (`batch_size` is the global
batch), the step reduces over the ranks, prune events run the same on every
rank's bit-equal weights, `eval` sums the ranks' counts and only rank 0
writes the JSONL record.

The model axis (a mesh with `model` > 1): the Manager places shared,
ownership and every task's piggymask by `shared_shardings` (each rank keeps
its slice of every kernel whose axis divides; `state.shards` records the
split), the current task's private params and BN statistics replicated,
and builds the optimizers from the placed slices, so the moments take the
slices' shapes. The steps run each split layer on its slice
(make_parallel_*_step(model_sharded=True)), the data group reduces, and
the prune events take their cutoffs from whole layers (core/pruner.py).
The state stays split when the Manager is done; train/sequence.py gathers
it (`gather_state`) to snapshot or save it. `cfg.act_sharder` (the seams
over the mesh's model group) passes to both steps.

A pipeline (`cfg.pipeliner`, parallel/pipeline.py) runs one Manager a
stage process, every stage with the same state, data, seed and draws and
no mesh: the steps keep the replicas bit-equal, and only the pipe group's
rank 0 writes the JSONL record.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core import pruner
from ..core.schedule import cubic_sparsity
from ..core.state import CPGState, resolve_device
from ..data.cifar import iterate_batches
from ..data.native_loader import NativeBatcher
from ..data.stream import DevicePrefetcher
from ..models import check_token_ids
from ..parallel.collectives import all_reduce_sum_
from ..parallel.mesh import (batch_sharding, local_batch_slice,
                             make_parallel_train_step, place_state,
                             require_ranks, shared_shardings, whole_shapes)
from ..utils import LOGGER, JsonlWriter
from .losses import class_logits
from .step import TrainConfig, make_eval_step, make_train_step, set_lr

log = logging.getLogger(LOGGER)


@dataclasses.dataclass
class PhaseResult:
    acc: float
    loss: float
    steps: int
    seconds: float
    images_per_sec: float


def _lr_at(base_lr: float, epoch: int, total_epochs: int,
           schedule: str) -> float:
    if schedule == "cosine":
        return 0.5 * base_lr * (1 + math.cos(
            math.pi * epoch / max(total_epochs, 1)))
    if schedule == "warmup_cosine":
        # linear warmup over the first 10% of epochs (>= 1), then cosine
        warm = max(1, int(0.1 * total_epochs))
        if epoch < warm:
            return base_lr * (epoch + 1) / warm
        frac = (epoch - warm) / max(total_epochs - warm, 1)
        return 0.5 * base_lr * (1 + math.cos(math.pi * frac))
    if schedule == "constant":
        return base_lr
    if schedule == "step":
        # x0.1 at 50% and 75% of the phase
        frac = epoch / max(total_epochs, 1)
        return base_lr * (0.1 ** ((frac >= 0.5) + (frac >= 0.75)))
    raise ValueError(schedule)


def torch_draws(seed: int) -> Callable:
    """The default draws: one CPU `torch.Generator` seeded with `seed`,
    handed to `augment_fn` at every step."""
    gen = torch.Generator().manual_seed(seed)
    return lambda n: gen


def _elsewhere(t: torch.Tensor, dev: torch.device) -> bool:
    """True when `t` is not on `dev` (a device without an index, such as
    "cuda", stands for its current one)."""
    return t.device.type != dev.type or (
        dev.index is not None and t.device.index != dev.index)


def on_device(state: CPGState, dev: torch.device) -> None:
    """Move every tensor of `state` to `dev` in place of the old ones, if
    any lives elsewhere; a state already there is left as it is (the
    optimizers may hold its tensors)."""
    trees = [state.shared, state.ownership]
    for t in state.tasks.values():
        trees += [t.piggymask or {}, t.private, t.bn_state]
    if any(_elsewhere(v, dev) for tree in trees for v in tree.values()):
        state.__dict__.update(state.to(dev).__dict__)


class Manager:
    """Drives one task's phases: pick/finetune -> gradual prune -> retrain."""

    def __init__(self, state: CPGState, model_fn: Callable, task_id: int,
                 data: Dict[str, np.ndarray], cfg: TrainConfig,
                 batch_size: int = 128,
                 augment_fn: Optional[Callable] = None,
                 preprocess_fn: Optional[Callable] = None, loss_fn=None,
                 seed: int = 0, lr_schedule: str = "cosine",
                 native_loader: bool = False,
                 jsonl_path: Optional[str] = None, mesh=None, *,
                 draws: Optional[Callable] = None, device="cuda"):
        self.mesh = mesh
        if mesh is not None:
            require_ranks(mesh)
            if batch_size % mesh.data_size:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by data-axis "
                    f"size {mesh.data_size}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        for split in ("train_x", "test_x"):  # every batch's ids, once
            check_token_ids(state.arch, state.forward_kwargs(task_id),
                            data[split])
        on_device(state, self.device)
        if mesh is not None:  # every replica starts bit-equal
            self._place(state, mesh, task_id)
        self.state = state
        self.model_fn = model_fn
        self.task_id = task_id
        self.task = state.tasks[task_id]
        self.data = data
        self.cfg = cfg
        self.batch_size = batch_size
        self.lr_schedule = lr_schedule
        self.np_rng = np.random.RandomState(seed)
        self.next_rng = (draws or torch_draws)(seed)
        self.it = 0  # global step (drives annealed losses)
        self.has_piggymask = self.task.piggymask is not None
        pipe = getattr(cfg.pipeliner, "mesh", None)
        self.jsonl_path = (jsonl_path if all(m is None or m.is_main
                                             for m in (mesh, pipe))
                           else None)

        kwargs = dict(num_classes=self.task.num_classes, mult=state.width_mult,
                      has_piggymask=self.has_piggymask, cfg=cfg,
                      model_kwargs=state.forward_kwargs(task_id) or None,
                      mask_mode=state.mask_mode, device=self.device)
        extra = {} if loss_fn is None else {"loss_fn": loss_fn}
        self.train_step, (self.opt_w, self.opt_pm) = make_train_step(
            model_fn, augment_fn=augment_fn, **kwargs, **extra)
        split = bool(state.shards)
        if mesh is not None:
            self.train_step = make_parallel_train_step(
                self.train_step, mesh, model_sharded=split,
                shards=state.shards)
        # eval: each rank runs its rows through the plain eval step (on its
        # slices under a model axis), and `eval` sums the counts once
        self.eval_step = make_eval_step(model_fn, preprocess_fn=preprocess_fn,
                                        **kwargs)
        if split:
            self.eval_step = functools.partial(self.eval_step,
                                               shards=state.shards)
        self._batcher = (NativeBatcher(data["train_x"], data["train_y"],
                                       batch_size, seed=seed)
                         if native_loader else None)
        self.reset_optimizers()

    @staticmethod
    def _place(state: CPGState, mesh, task_id: int):
        """Place the state on the mesh (see the module docstring)."""
        task = state.tasks[task_id]
        whole = whole_shapes(state.shared, state.shards)
        shardings = (shared_shardings(mesh, whole, True)
                     if mesh.model_size > 1 else None)
        state.shared = place_state(mesh, state.shared, shardings)
        state.ownership = place_state(mesh, state.ownership, shardings)
        for t in state.tasks.values():
            if t is task or shardings is not None:
                t.piggymask = place_state(mesh, t.piggymask, shardings)
        task.private = place_state(mesh, task.private)
        task.bn_state = place_state(mesh, task.bn_state)
        if shardings is not None:
            state.shards = {k: s for k, s in shardings.items()
                            if s is not None}

    def _split(self):
        """The pruner's `shards` keyword: the kernels split over the model
        groups, when the state holds any (a whole state's calls keep the
        single-device form)."""
        return {"shards": self.state.shards} if self.state.shards else {}

    def _train_batches(self, steps_per_epoch: int):
        """One epoch of training batches on the Manager's device: the C++
        loader's next `steps_per_epoch` batches, or a NumPy gather in the
        order of `np_rng`, behind a DevicePrefetcher (under a mesh, this
        rank's rows of each global batch)."""
        if self._batcher is not None:
            it = self._batcher.batches(steps_per_epoch)
        else:
            it = iterate_batches(self.data["train_x"], self.data["train_y"],
                                 self.batch_size, self.np_rng, train=True)
        if self.mesh is not None:
            return DevicePrefetcher(it, sharding=batch_sharding(self.mesh))
        return DevicePrefetcher(it, self.device)

    # -- optimizer state ----------------------------------------------------
    def reset_optimizers(self):
        """Fresh optimizers bound to the live shared, private and piggymask
        tensors (none for the piggymask of a task without one)."""
        self.opt_w_state = self.opt_w.init(
            {"shared": self.state.shared, "private": self.task.private})
        self.opt_pm_state = (self.opt_pm.init(self.task.piggymask)
                             if self.has_piggymask else None)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- phases ---------------------------------------------------------------
    def train(self, epochs: int, base_lr: Optional[float] = None,
              prune_to: Optional[float] = None, prune_freq: int = 50,
              prune_begin_frac: float = 0.0, prune_end_frac: float = 0.8,
              prune_n0=None, start_epoch: int = 0,
              epoch_callback: Optional[Callable[[int], None]] = None
              ) -> PhaseResult:
        """Train `epochs`. With `prune_to`, runs the gradual-prune window
        inside: cubic schedule from the current sparsity to `prune_to`, a
        prune event every `prune_freq` steps and one forced at the window's
        end, then the remaining steps retrain at the final sparsity.

        `prune_n0` fixes the counts the sparsity target is a fraction OF
        (the task's post-pick owned counts); without it each call snapshots
        the current counts. `start_epoch` re-enters an interrupted epoch loop
        (the caller restores `self.it` and the state). `epoch_callback(
        completed_epochs)` fires after every epoch with the live trees
        synced into the state."""
        st, task = self.state, self.task
        base_lr = self.cfg.lr if base_lr is None else base_lr
        n = len(self.data["train_x"])
        steps_per_epoch = max(n // self.batch_size, 1)
        total_steps = epochs * steps_per_epoch

        n0 = None
        prune_begin = prune_end = -1
        init_sparsity = 0.0
        if prune_to is not None:
            n0 = prune_n0 if prune_n0 is not None else {
                k: int(v) for k, v in pruner.snapshot_owned_counts(
                    st.ownership, self.task_id, **self._split()).items()}
            init_sparsity = float(pruner.task_sparsity(
                st.ownership, self.task_id, n0, **self._split()))
            prune_begin = int(prune_begin_frac * total_steps)
            prune_end = max(int(prune_end_frac * total_steps),
                            prune_begin + 1)

        pm = task.piggymask
        shared, ownership = st.shared, st.ownership
        private, bn_state = task.private, task.bn_state
        opt_w_state, opt_pm_state = self.opt_w_state, self.opt_pm_state

        step_i = start_epoch * steps_per_epoch
        losses = []
        t0 = time.perf_counter()
        metrics = {}
        for epoch in range(start_epoch, epochs):
            opt_w_state = set_lr(
                opt_w_state, _lr_at(base_lr, epoch, epochs, self.lr_schedule))
            for bx, by in self._train_batches(steps_per_epoch):
                if (prune_to is not None
                        and prune_begin <= step_i <= prune_end
                        and ((step_i - prune_begin) % prune_freq == 0
                             or step_i == prune_end)):
                    # the `or step_i == prune_end` forces the final event to
                    # land exactly at the window end, so every remaining
                    # retrain step sees the final sparsity
                    target = cubic_sparsity(step_i, prune_begin, prune_end,
                                            init_sparsity, prune_to)
                    pruner.gradual_prune_(shared, ownership, self.task_id,
                                          target, n0, **self._split())
                (shared, pm, private, bn_state, opt_w_state, opt_pm_state,
                 metrics) = self.train_step(
                    shared, pm, private, bn_state, opt_w_state, opt_pm_state,
                    ownership, self.task_id, bx, by,
                    self.next_rng(self.batch_size), self.it)
                step_i += 1
                self.it += 1
            losses.append(float(metrics["loss"]))
            if epoch_callback is not None:
                task.bn_state = bn_state
                self.opt_w_state, self.opt_pm_state = opt_w_state, opt_pm_state
                epoch_callback(epoch + 1)
        self._sync()
        dt = time.perf_counter() - t0
        steps_run = step_i - start_epoch * steps_per_epoch
        if losses and not math.isfinite(losses[-1]):
            log.warning(
                "task %d (%s): NON-FINITE loss %s — training diverged (lower "
                "lr or set TrainConfig.grad_clip_norm); weights are likely "
                "NaN (run core.invariants.check_state)",
                self.task_id, self.task.name, losses[-1])

        # safety net: if prune_end == total_steps the loop never reaches it
        # (step_i stops at total_steps-1); land exactly on the target anyway
        if prune_to is not None:
            pruner.gradual_prune_(shared, ownership, self.task_id, prune_to,
                                  n0, **self._split())

        task.bn_state = bn_state
        self.opt_w_state, self.opt_pm_state = opt_w_state, opt_pm_state

        acc = self.eval()
        ips = steps_run * self.batch_size / max(dt, 1e-9)
        loss = losses[-1] if losses else float("nan")
        if self.jsonl_path:
            with JsonlWriter(self.jsonl_path) as w:
                w.write(event="phase", task_id=self.task_id,
                        task=self.task.name, epochs=epochs, steps=steps_run,
                        prune_to=prune_to, loss=losses[-1] if losses else None,
                        acc=acc, seconds=dt, images_per_sec=ips,
                        width_mult=st.width_mult)
        return PhaseResult(acc=acc, loss=loss, steps=steps_run, seconds=dt,
                           images_per_sec=ips)

    def eval(self, task_id: Optional[int] = None) -> float:
        """Task-conditioned top-1 on the task's test split.

        The last batch is padded to the batch size (the steps see one
        shape) and only its valid rows are counted, from the logits; the
        counts are summed on the device and read once. Under a mesh each
        rank runs its rows of every batch and the counts are summed over
        the ranks."""
        task_id = self.task_id if task_id is None else task_id
        task = self.state.tasks[task_id]
        x, y = self.data["test_x"], self.data["test_y"]
        n, bs = len(x), self.batch_size
        sl = (slice(0, bs) if self.mesh is None
              else local_batch_slice(self.mesh, bs))
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for s in range(0, n, bs):
            # copies: a memmapped split is read-only
            bx, by = np.array(x[s:s + bs]), np.array(y[s:s + bs], np.int64)
            nvalid = len(by)
            if nvalid < bs:  # pad to the batch shape
                pad = bs - nvalid
                bx = np.concatenate([bx, np.repeat(bx[-1:], pad, axis=0)])
                by = np.concatenate([by, np.zeros(pad, by.dtype)])
            mine = max(0, min(nvalid, sl.stop) - sl.start)  # valid rows here
            logits, _ = self.eval_step(
                self.state.shared, task.piggymask, task.private,
                task.bn_state, self.state.ownership, task_id, bx[sl], by[sl])
            pred = class_logits(logits)[:mine].argmax(-1)
            correct += (pred == torch.from_numpy(
                by[sl][:mine]).to(self.device)).sum()
        if self.mesh is not None:
            all_reduce_sum_(correct, self.mesh.data_group)
        return int(correct) / max(n, 1)

    # -- one-shot prune (ref --one_shot_prune_perc) --------------------------
    def one_shot_prune(self, ratio: float):
        """Release round(ratio * owned) smallest entries of every layer,
        written into the live tensors."""
        pruner.one_shot_prune_(self.state.shared, self.state.ownership,
                               self.task_id, ratio, **self._split())
