"""Magnitude pruner: one-shot and gradual.

Per layer, collect |w| over entries owned by the current task; the cutoff is
the k-th smallest with k = round(ratio * n_owned) (f32, half-to-even);
entries with |w| <= cutoff (ties all pruned) are released: ownership -> 0
and weight -> 0. Same semantics, bit for bit, as `cpg_tpu.core.pruner`. The
rank stays a tensor, so a prune on the card never waits for the host.

Gradual pruning: the cubic schedule's target s(t) is a fraction of the
task's owned count at the start of the prune phase (n0). Entries already
released count toward it, so each event prunes
`max(round(s(t) * n0) - (n0 - n_now), 0)` more, smallest magnitude first.

Every prune writes into the live weight and ownership tensors with
`masked_fill_` (the `_` forms): the train step and its `torch.optim`
optimizers hold references to those tensors, so a prune inside a training
phase must not replace them. `one_shot_prune` alone also returns new
tensors, for callers that keep the state they pruned from.

A layer split over a model group (`shards`, {key: ShardSpec} of
parallel/collectives.py) takes its counts and its cutoff from the whole
layer: |w| and the ownership are gathered over the group, and each rank
writes only its own slice, so the result is bit-equal to one process on
the whole layer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .ownership import FREE, owned_mask


def _whole(t: torch.Tensor, spec) -> torch.Tensor:
    """The whole layer of a slice (a collective), or `t` when not split."""
    return t if spec is None else spec.gather(t)


def _kth_smallest(values: torch.Tensor, valid: torch.Tensor,
                  rank: torch.Tensor) -> torch.Tensor:
    """k-th smallest (1-indexed `rank`) of `values` over `valid` entries.
    Invalid entries sort to +inf; rank < 1 yields -inf (prune nothing)."""
    inf = torch.tensor(float("inf"), dtype=values.dtype, device=values.device)
    s, _ = torch.sort(torch.where(valid, values, inf).ravel())
    idx = (rank.to(torch.int64) - 1).clamp(0, s.numel() - 1)
    return torch.where(rank < 1, -inf, s[idx])


def _release_(w, own, task_id, n_prune, whole=None) -> None:
    """Release the `n_prune` smallest-|w| entries owned by `task_id`, and
    every entry tied with the cutoff magnitude, in place. `whole`: the
    whole layer's (w, own) when w and own are this rank's slice of it; the
    cutoff comes from the whole layer."""
    ww, ow = (w, own) if whole is None else whole
    rank = torch.as_tensor(n_prune, dtype=torch.int32, device=w.device)
    cutoff = _kth_smallest(ww.abs(), owned_mask(ow, task_id), rank)
    remove = owned_mask(own, task_id) & (w.abs() <= cutoff)
    w.masked_fill_(remove, 0)
    own.masked_fill_(remove, FREE)


def prune_layer_by_ratio_(w, own, task_id, ratio, spec=None) -> None:
    """One-shot prune: release round(ratio * n_owned_now) smallest entries
    (of the whole layer under `spec`)."""
    whole = _whole(w, spec), _whole(own, spec)
    n_owned = owned_mask(whole[1], task_id).sum(dtype=torch.int32)
    r = torch.tensor(ratio, dtype=torch.float32, device=w.device)
    _release_(w, own, task_id,
              torch.round(r * n_owned.to(torch.float32)).to(torch.int32),
              whole)


def prune_layer_to_total_(w, own, task_id, target_sparsity, n0,
                          spec=None) -> None:
    """Gradual-prune step: release entries until `target_sparsity` of the
    snapshot count `n0` (the layer's owned count at prune-phase start) are
    released; the shortfall is clamped at 0. Under `spec` w and own are
    this rank's slice and the counts are the whole layer's."""
    whole = _whole(w, spec), _whole(own, spec)
    n_now = owned_mask(whole[1], task_id).sum(dtype=torch.int32)
    n0 = torch.as_tensor(n0, device=own.device)
    pruned_so_far = n0.to(torch.int32) - n_now
    want_total = torch.round(
        torch.as_tensor(target_sparsity, dtype=torch.float32).to(own.device)
        * n0.to(torch.float32)).to(torch.int32)
    _release_(w, own, task_id, torch.clamp(want_total - pruned_so_far, min=0),
              whole)


# ---------------------------------------------------------------------------
# Tree-level wrappers (one call per prune event, applied to every layer).
# ---------------------------------------------------------------------------


def snapshot_owned_counts(ownership: Dict, task_id,
                          shards: Optional[Dict] = None) -> Dict:
    """{layer: int32 0-d tensor} owned by `task_id` (in the whole layer of
    a slice that `shards` names)."""
    shards = shards or {}
    return {k: owned_mask(_whole(m, shards.get(k)), task_id).sum(
        dtype=torch.int32) for k, m in ownership.items()}


def one_shot_prune_(shared: Dict, ownership: Dict, task_id, ratio,
                    shards: Optional[Dict] = None) -> None:
    shards = shards or {}
    for k, w in shared.items():
        prune_layer_by_ratio_(w, ownership[k], task_id, ratio, shards.get(k))


def one_shot_prune(shared: Dict, ownership: Dict, task_id,
                   ratio) -> Tuple[Dict, Dict]:
    """`one_shot_prune_` on copies; the given trees are left as they were."""
    shared = {k: w.clone() for k, w in shared.items()}
    ownership = {k: m.clone() for k, m in ownership.items()}
    one_shot_prune_(shared, ownership, task_id, ratio)
    return shared, ownership


def gradual_prune_(shared, ownership, task_id, target_sparsity,
                   n0_counts, shards: Optional[Dict] = None) -> None:
    """One gradual-prune event over every layer of the tree (`shards`: the
    layers held as slices, see the module docstring)."""
    shards = shards or {}
    for k, w in shared.items():
        prune_layer_to_total_(w, ownership[k], task_id, target_sparsity,
                              n0_counts[k], shards.get(k))


def task_sparsity(ownership, task_id, n0_counts,
                  shards: Optional[Dict] = None) -> torch.Tensor:
    """Achieved sparsity vs the snapshot counts (for logging and records),
    f32, summed over the layers in sorted-key order (the JAX tree order)."""
    keys = sorted(ownership)
    now = snapshot_owned_counts(ownership, task_id, shards)
    n_now = sum(now[k].cpu() for k in keys)
    n_tot = sum(torch.as_tensor(n0_counts[k], dtype=torch.float32).cpu()
                for k in keys)
    return 1.0 - n_now / torch.clamp(n_tot, min=1.0)
