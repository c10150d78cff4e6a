"""CPG model state: the one container the whole cycle mutates.

Same structure and keys as `cpg_tpu.core.state`, holding torch tensors:

  shared     {layer/kernel: f32}   sharable weights (ownership-governed), HWIO
  ownership  {layer/kernel: int8}  0=free, k=owned by task k
  tasks      {task_id: TaskEntry}  per-task piggymask + private + BN stats
  width_mult float                 current network width multiplier

Under a model axis (parallel/mesh.py) a rank's state holds only its slice
of each split kernel, and of its ownership and piggymasks; `shards` maps
those keys to their `ShardSpec` (parallel/collectives.py) and is empty for
a whole state, the only kind that is saved or carried across.

`state_from_numpy` / `state_to_numpy` carry a state between the packages:
every array leaf is copied by key, so a state built by `cpg_tpu` (whose
arrays convert with `np.asarray`) loads here, and the reverse.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a usable card
    raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class TaskEntry:
    name: str                      # dataset/task name (e.g. 'aquatic_mammals')
    num_classes: int
    piggymask: Optional[Dict]      # None for task 1 (nothing to pick from)
    private: Dict                  # BN affine, biases, head
    bn_state: Dict                 # BN running mean/var
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CPGState:
    arch: str
    width_mult: float
    shared: Dict
    ownership: Dict
    tasks: Dict[int, TaskEntry] = dataclasses.field(default_factory=dict)
    threshold: float = 5e-3        # binarizer threshold (ref DEFAULT_THRESHOLD)
    mask_mode: str = "binary"      # 'binary' | 'ternary' | 'packnet'
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    in_shape: Optional[tuple] = None
    # {kernel key: ShardSpec} of the kernels this rank holds a slice of
    shards: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    def task_ids(self):
        return sorted(self.tasks)

    def forward_kwargs(self, task_id: Optional[int] = None,
                       override: Optional[Dict] = None) -> Dict[str, Any]:
        """Arch-level model_kwargs merged with task `task_id`'s stored kwargs
        (task wins); `override` replaces the task-level layer entirely."""
        mkw = dict(self.model_kwargs or {})
        if override is not None:
            mkw.update(override)
        elif task_id is not None and task_id in self.tasks:
            mkw.update(self.tasks[task_id].meta.get("model_kwargs") or {})
        return mkw

    def map_arrays(self, fn) -> "CPGState":
        """A new state with `fn` applied to every array leaf."""
        def tree(d):
            return None if d is None else {k: fn(v) for k, v in d.items()}

        return dataclasses.replace(
            self, shared=tree(self.shared), ownership=tree(self.ownership),
            tasks={tid: dataclasses.replace(
                t, piggymask=tree(t.piggymask), private=tree(t.private),
                bn_state=tree(t.bn_state), meta=dict(t.meta))
                for tid, t in self.tasks.items()},
            model_kwargs=dict(self.model_kwargs or {}))

    def to(self, device) -> "CPGState":
        """The same state with every tensor on `device` (no copy for
        tensors already there)."""
        dev = torch.device(device)
        return self.map_arrays(lambda t: t.to(dev))


def state_from_numpy(src, device) -> CPGState:
    """Port state on `device` from any state-shaped object (this package's
    CPGState of numpy arrays, or `cpg_tpu`'s): same fields, same keys, array
    leaves converted with `np.asarray`."""
    dev = resolve_device(device)
    shell = CPGState(
        arch=src.arch, width_mult=float(src.width_mult), shared=src.shared,
        ownership=src.ownership,
        tasks={int(tid): TaskEntry(
            name=t.name, num_classes=int(t.num_classes),
            piggymask=t.piggymask, private=t.private, bn_state=t.bn_state,
            meta=dict(t.meta or {})) for tid, t in src.tasks.items()},
        threshold=float(src.threshold),
        mask_mode=getattr(src, "mask_mode", "binary"),
        model_kwargs=dict(getattr(src, "model_kwargs", None) or {}),
        in_shape=getattr(src, "in_shape", None))
    return shell.map_arrays(
        lambda a: torch.from_numpy(np.array(a, copy=True, order="C")).to(dev))


def state_to_numpy(state: CPGState) -> CPGState:
    """The same state with every tensor copied to a host numpy array."""
    return state.map_arrays(lambda t: t.detach().cpu().numpy())
