"""Task-conditioned inference — the public predict() API.

Restore the task's piggymask and private BN/head, zero out weights with
ownership 0 or > t, forward with binarize(piggymask_t) * w, pick head t.
Same semantics as `cpg_tpu.inference`. Runs on `device` (default the card);
the state's tensors are moved there (no copy when they already live there).
"""

from __future__ import annotations

import torch

from .core.state import CPGState, resolve_device
from .models import framework as fw
from .models import check_token_ids, get_model
from .ops.masked import effective_params


def _float_dtype_of(x: torch.Tensor) -> torch.dtype:
    """The input's own dtype when floating, f32 otherwise."""
    return x.dtype if x.dtype.is_floating_point else torch.float32


def make_predict_fn(state: CPGState, task_id: int, preprocess_fn=None,
                    compute_dtype=None, device="cuda", model_kwargs=None):
    """A closure x -> logits over the task's frozen view, on `device`."""
    dev = resolve_device(device)
    state = state.to(dev)
    task = state.tasks[task_id]
    model_fn, _ = get_model(state.arch)
    mkw = state.forward_kwargs(task_id, override=model_kwargs)

    def fn(x):
        check_token_ids(state.arch, mkw, x)
        with torch.inference_mode():
            x = torch.as_tensor(x).to(dev)
            if preprocess_fn is not None:
                x = preprocess_fn(x)
            eff = effective_params(state.shared, state.ownership,
                                   task.piggymask, task_id, state.threshold,
                                   compute_dtype=compute_dtype,
                                   mask_mode=state.mask_mode)
            logits, _ = fw.apply(
                model_fn, eff, task.private, task.bn_state, x, train=False,
                compute_dtype=compute_dtype or _float_dtype_of(x),
                num_classes=task.num_classes, mult=state.width_mult, **mkw)
            return logits

    return fn


def predict(state: CPGState, task_id: int, x, preprocess_fn=None,
            compute_dtype=None, model_kwargs=None, device="cuda"):
    """Logits for `x` under task `task_id`'s view of the network.
    `model_kwargs` overrides the task's stored forward kwargs."""
    return make_predict_fn(state, task_id, preprocess_fn, compute_dtype,
                           device, model_kwargs)(x)
