"""Checkpoints of a CPG state, in torch format.

The counterpart of `cpg_tpu.utils.checkpoint`, with the same layout apart
from the tensor file: a checkpoint is a directory holding

  tree.pt         `torch.save` of the tree {"shared", "ownership",
                  "tasks": {"<tid>": {"private", "bn_state"[, "piggymask"]}}}
                  (the keys of `cpg_tpu`'s `_to_tree`), CPU tensors;
  cpg_meta.json   the same sidecar: arch, width multiplier, threshold,
                  mask mode, model kwargs, input shape, and each task's
                  name, class count and meta.

Every file is written to a temporary name in the directory, flushed to
disk (fsync) and renamed over the old one, and the sidecar goes last (an earlier one is removed
first), so a directory with a sidecar always holds a whole checkpoint. The
round trip is bit-exact: inference correctness IS the mask bits. Saves are
synchronous (`block` is accepted for the JAX package's signature): when
`save_state` returns, the checkpoint is on disk. A state moves to or from
an orbax checkpoint of `cpg_tpu` through `state_to_numpy` /
`state_from_numpy`.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from ..core.ownership import OWN_DTYPE
from ..core.state import CPGState, TaskEntry, resolve_device

_META = "cpg_meta.json"
_TREE = "tree.pt"


def _cpu(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def _to_tree(state: CPGState):
    tasks = {}
    for tid, t in state.tasks.items():
        entry = {"private": _cpu(t.private), "bn_state": _cpu(t.bn_state)}
        if t.piggymask is not None:
            entry["piggymask"] = _cpu(t.piggymask)
        tasks[str(tid)] = entry
    return {"shared": _cpu(state.shared), "ownership": _cpu(state.ownership),
            "tasks": tasks}


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _replace(path: str, write) -> None:
    """Write `path` through `write(tmp_path)`, flush it to disk, then rename
    it into place and flush the directory entry."""
    tmp = path + ".tmp"
    write(tmp)
    _fsync(tmp)
    os.replace(tmp, path)
    _fsync(os.path.dirname(path))


def remove_after_save(path: str) -> None:
    """Delete checkpoint dir `path` once every save has landed: retires a
    task's transient `.pick` / `.epoch` checkpoint after its successor is
    on disk. Saves are synchronous, so that is now."""
    shutil.rmtree(path, ignore_errors=True)


def wait_for_saves() -> None:
    """Block until every save is on disk: saves are synchronous, so they
    are."""


def save_state(state: CPGState, path: str, block: bool = True) -> str:
    """Write a full CPG checkpoint at `path` (a directory); returns the
    absolute path."""
    del block  # saves are synchronous
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta_path = os.path.join(path, _META)
    if os.path.exists(meta_path):
        os.remove(meta_path)
    _replace(os.path.join(path, _TREE),
             lambda p: torch.save(_to_tree(state), p))
    meta = {
        "arch": state.arch,
        "width_mult": state.width_mult,
        "threshold": state.threshold,
        "mask_mode": state.mask_mode,
        "model_kwargs": dict(state.model_kwargs or {}),
        "in_shape": list(state.in_shape) if state.in_shape else None,
        "tasks": {str(tid): {"name": t.name, "num_classes": t.num_classes,
                             "meta": t.meta}
                  for tid, t in state.tasks.items()},
    }

    def write_meta(p):
        with open(p, "w") as f:
            json.dump(meta, f, indent=1)

    _replace(meta_path, write_meta)
    return path


def load_state(path: str, device="cuda") -> CPGState:
    """The checkpoint at `path` as a state on `device`."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    tree = torch.load(os.path.join(path, _TREE), map_location="cpu",
                      weights_only=True)
    tasks = {}
    for tid_s, tm in meta["tasks"].items():
        entry = tree["tasks"][tid_s]
        tasks[int(tid_s)] = TaskEntry(
            name=tm["name"], num_classes=tm["num_classes"],
            piggymask=entry.get("piggymask"), private=entry["private"],
            bn_state=entry["bn_state"], meta=tm.get("meta") or {})
    state = CPGState(
        arch=meta["arch"], width_mult=meta["width_mult"],
        shared=tree["shared"],
        ownership={k: v.to(OWN_DTYPE) for k, v in tree["ownership"].items()},
        tasks=tasks, threshold=meta["threshold"],
        mask_mode=meta.get("mask_mode", "binary"),
        model_kwargs=meta.get("model_kwargs") or {},
        in_shape=tuple(meta["in_shape"]) if meta.get("in_shape") else None)
    return state.to(dev)


def latest_checkpoint(root: str) -> Optional[str]:
    """Most recent checkpoint dir under `root` (named task<k>_<phase> or
    any)."""
    if not os.path.isdir(root):
        return None
    cands = [os.path.join(root, d) for d in os.listdir(root)
             if os.path.exists(os.path.join(root, d, _META))]
    return max(cands, key=os.path.getmtime) if cands else None
