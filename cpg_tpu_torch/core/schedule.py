"""Gradual sparsity schedule (Zhu & Gupta cubic).

Same semantics, bit for bit, as `cpg_tpu.core.schedule`: during the prune
window [begin_step, end_step] the target sparsity at step t is

    s(t) = s_f + (s_i - s_f) * (1 - (t - t0) / (t1 - t0))**3

in f32, evaluated every `frequency` steps; outside the window it clamps to
its endpoints. Takes tensors or Python numbers; returns 0-d tensors.
"""

from __future__ import annotations

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def cubic_sparsity(step, begin_step, end_step, initial_sparsity,
                   final_sparsity) -> torch.Tensor:
    """Target *total* sparsity (fraction of task-owned weights pruned) at
    `step`, f32."""
    step = _f32(step)
    span = torch.clamp(_f32(end_step - begin_step), min=1.0)
    progress = torch.clamp((step - begin_step) / span, 0.0, 1.0)
    si, sf = _f32(initial_sparsity), _f32(final_sparsity)
    q = 1.0 - progress
    # x * (x * x): the product XLA's integer_pow(x, 3) forms
    return sf + (si - sf) * (q * (q * q))


def is_prune_step(step, begin_step, end_step, frequency) -> torch.Tensor:
    """True on steps where a prune event fires (every `frequency` steps in
    the window)."""
    step = torch.as_tensor(step)
    in_window = (step >= begin_step) & (step <= end_step)
    on_freq = torch.remainder(step - begin_step, max(int(frequency), 1)) == 0
    return in_window & on_freq
