"""Ownership masks: the single bookkeeping tensor that drives CPG.

Every sharable weight tensor has an int8 mask of identical shape: 0 means the
weight is free, k>0 means it is owned by task k. Ownership drives pruning
eligibility (only `own == task` entries), gradient gating and inference
visibility (task t sees `0 < own <= t`, `ops/masked.py`). Same semantics as
`cpg_tpu.core.ownership`, over torch tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

OWN_DTYPE = torch.int8
FREE = 0


def init_ownership(shared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """All-free masks matching the shared-weight dict."""
    return {k: torch.zeros(w.shape, dtype=OWN_DTYPE, device=w.device)
            for k, w in shared.items()}


def assign_free_to_task(ownership, task_id: int):
    """Every free entry becomes owned by `task_id` (the new task trains the
    released or never-used capacity)."""
    return {k: m.masked_fill(m == FREE, task_id) for k, m in ownership.items()}


def visible_mask(own: torch.Tensor, task_id) -> torch.Tensor:
    """Entries a forward pass for `task_id` may use: 0 < own <= task_id."""
    return (own > FREE) & (own <= int(task_id))


def owned_mask(own: torch.Tensor, task_id) -> torch.Tensor:
    return own == int(task_id)


def _frac(preds) -> torch.Tensor:
    num = sum(p.sum(dtype=torch.int32) for p in preds)
    den = sum(p.numel() for p in preds)
    return num.to(torch.float32) / max(den, 1)


def free_ratio(ownership) -> torch.Tensor:
    """Fraction of all shared weights currently free."""
    return _frac([m == FREE for m in ownership.values()])


def task_ratio(ownership, task_id) -> torch.Tensor:
    """Fraction of all shared weights owned by `task_id`."""
    return _frac([owned_mask(m, task_id) for m in ownership.values()])


def used_ratio(ownership) -> torch.Tensor:
    return _frac([m > FREE for m in ownership.values()])


def prior_mask(own: torch.Tensor, task_id) -> torch.Tensor:
    """Entries owned by strictly earlier tasks (the piggymask domain)."""
    return (own > FREE) & (own < int(task_id))
