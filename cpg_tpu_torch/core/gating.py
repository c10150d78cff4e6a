"""Gradient gating and selective weight decay (same semantics as
`cpg_tpu.core.gating`).

After the backward pass, for every sharable weight: add `weight_decay * w`
and then zero the gradient wherever ownership != the current task, so
prior-task weights stay bit-frozen and only current-task entries decay;
piggymask gradients are zeroed outside the prior-task domain.

Unlike the JAX functions, these update the gradient tensors IN PLACE (the
train step passes each parameter's `.grad`) and return the same dict.
"""

from __future__ import annotations

from typing import Dict

import torch

from .ownership import owned_mask, prior_mask


@torch.no_grad()
def gate_and_decay(grads: Dict[str, torch.Tensor],
                   shared: Dict[str, torch.Tensor],
                   ownership: Dict[str, torch.Tensor], task_id,
                   weight_decay: float) -> Dict[str, torch.Tensor]:
    """g <- where(own == task, g + weight_decay * w, 0), in place."""
    for k, g in grads.items():
        g.add_(shared[k].to(g.dtype) * weight_decay)
        g.masked_fill_(~owned_mask(ownership[k], task_id), 0)
    return grads


@torch.no_grad()
def gate_piggymask_grads(pm_grads: Dict[str, torch.Tensor],
                         ownership: Dict[str, torch.Tensor],
                         task_id) -> Dict[str, torch.Tensor]:
    """g <- where(0 < own < task, g, 0), in place: entries owned by the
    current task or free get no mask gradient (they pass unmasked)."""
    for k, g in pm_grads.items():
        g.masked_fill_(~prior_mask(ownership[k], task_id), 0)
    return pm_grads
