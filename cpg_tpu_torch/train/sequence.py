"""Building a CPG state: `init_state` and `start_task` (same semantics as
`cpg_tpu.train.sequence`). The rest of the cycle (run_task, compaction,
growth) comes in a later slice.

Random inits draw from an explicit `torch.Generator` on the CPU, so a state
is the same for a seed whatever device it then lives on.
"""

from __future__ import annotations

import torch

from ..core.ownership import assign_free_to_task, init_ownership
from ..core.state import CPGState, TaskEntry, resolve_device
from ..models import framework as fw
from ..models import get_model
from ..ops.binarize import init_piggymask


def _to(tree, device):
    return {k: v.to(device) for k, v in tree.items()}


def init_state(arch: str, generator: torch.Generator, width_mult: float = 1.0,
               mask_mode: str = "binary", device="cuda") -> CPGState:
    """Fresh CPG state on `device`: shared weights initialised, everything
    free. mask_mode: 'binary' | 'ternary' | 'packnet'."""
    dev = resolve_device(device)
    model_fn, in_shape = get_model(arch)
    shared, _, _ = fw.init(generator, model_fn, torch.zeros((1, *in_shape)),
                           num_classes=2, mult=width_mult)
    shared = _to(shared, dev)
    return CPGState(arch=arch, width_mult=width_mult, shared=shared,
                    ownership=init_ownership(shared), mask_mode=mask_mode)


def start_task(state: CPGState, name: str, num_classes: int,
               generator: torch.Generator) -> int:
    """Add task k: claim free capacity, create the piggymask over prior-task
    weights (k > 1, not in packnet mode), fresh task-private params."""
    model_fn, in_shape = get_model(state.arch)
    dev = next(iter(state.shared.values())).device
    task_id = state.num_tasks + 1
    state.ownership = assign_free_to_task(state.ownership, task_id)
    piggymask = ({k: init_piggymask(w.shape, device=dev)
                  for k, w in state.shared.items()}
                 if task_id > 1 and state.mask_mode != "packnet" else None)
    _, private, bn_state = fw.init(
        generator, model_fn, torch.zeros((1, *(state.in_shape or in_shape))),
        num_classes=num_classes, mult=state.width_mult,
        **state.forward_kwargs())
    state.tasks[task_id] = TaskEntry(
        name=name, num_classes=num_classes, piggymask=piggymask,
        private=_to(private, dev), bn_state=_to(bn_state, dev))
    return task_id
