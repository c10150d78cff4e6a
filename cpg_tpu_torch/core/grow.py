"""Capacity growing: widen every sharable layer, preserving old tasks exactly.

Same semantics as `cpg_tpu.core.grow`. When a task cannot reach its goal,
the network is rebuilt wider; the old weights land in the leading block of
each enlarged tensor and the new entries are fresh capacity (free, then
claimed by the current task).

Exact preservation: an old task t only sees ownership <= t, and every grown
entry is free or owned by a later task, so its feature maps on new channels
are identically zero PROVIDED the padded task-private params keep them zero:
  * conv/dense kernels: old block top-left; fresh init values live only on
    FREE entries, which inference zeroes;
  * old-task BN: pad scale=1, bias=0, running mean=0, var=1 -> output 0 on
    new channels; PReLU slope pad 0.25 (input 0 -> output 0);
  * old-task head kernels: pad new feature rows with ZEROS -> logits
    unchanged; an MoE router bias pads -1e9, so grown experts get no mass.

Dense layers fed by a spatial flatten interleave channels in the flattened
index; `flatten_dims={layer: (H, W)}` selects the block-permutation
embedding instead of the plain top-left block. New tensors are made on the
old tensor's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .ownership import FREE, OWN_DTYPE


def _embed_block(old, new):
    """Top-left block embedding: a copy of `new` with
    new[tuple(slice(s) for s in old.shape)] = old."""
    out = new.to(old.device, copy=True)
    out[tuple(slice(0, s) for s in old.shape)] = old
    return out


def _embed_flatten_dense(old, new, hw: Tuple[int, int], c_old: int,
                         c_new: int):
    """Embed a dense kernel whose input axis is a (H, W, C) flatten."""
    h, w = hw
    out_old, out_new = old.shape[1], new.shape[1]
    new3 = new.to(old.device, copy=True).reshape(h * w, c_new, out_new)
    new3[:, :c_old, :out_old] = old.reshape(h * w, c_old, out_old)
    return new3.reshape(h * w * c_new, out_new)


def _grow_kernel(name, old, new_shape, fresh, flatten_dims):
    """Returns (grown weight, the embedding to apply to masks)."""
    if flatten_dims and name in flatten_dims:
        hw = flatten_dims[name]
        c_old = old.shape[0] // (hw[0] * hw[1])
        c_new = new_shape[0] // (hw[0] * hw[1])

        def embed(o, n):
            return _embed_flatten_dense(o, n, hw, c_old, c_new)
    else:
        embed = _embed_block
    return embed(old, fresh), embed


def grow_shared(shared: Dict, ownership: Dict, fresh_shared: Dict,
                piggymasks: Dict[int, Optional[Dict]],
                flatten_dims: Optional[Dict[str, Tuple[int, int]]] = None):
    """Grow shared weights, ownership and every stored piggymask to the
    shapes of `fresh_shared` (a fresh init at the new multiplier).

    Returns (shared', ownership', {task: piggymask'}). New entries keep the
    fresh init values (trainable capacity once claimed), ownership FREE,
    piggymask 0 (binarizes to off; outside old tasks' visibility anyway)."""
    new_shared, new_own, embeds = {}, {}, {}
    for name, old in shared.items():
        fresh = fresh_shared[name]
        if tuple(fresh.shape) == tuple(old.shape):
            new_shared[name] = old
            new_own[name] = ownership[name]
            embeds[name] = None
            continue
        grown, embed = _grow_kernel(name, old, fresh.shape, fresh,
                                    flatten_dims)
        new_shared[name] = grown
        new_own[name] = embed(ownership[name], torch.full(
            fresh.shape, FREE, dtype=OWN_DTYPE, device=old.device))
        embeds[name] = embed

    new_pms = {}
    for tid, pm in piggymasks.items():
        if pm is None:
            new_pms[tid] = None
            continue
        new_pms[tid] = {
            name: old_pm if embeds[name] is None else embeds[name](
                old_pm, torch.zeros(new_shared[name].shape,
                                    dtype=old_pm.dtype, device=old_pm.device))
            for name, old_pm in pm.items()}
    return new_shared, new_own, new_pms


# fill values that keep grown channels inert for old tasks
_PRIVATE_FILL = {
    "scale": 1.0,   # BN scale (input is 0 -> output bias = 0)
    "bias": 0.0,    # BN/conv/head bias
    "slope": 0.25,  # PReLU
    "kernel": 0.0,  # head kernel: new feature rows MUST be zero
    "mean": 0.0,    # BN running mean
    "var": 1.0,     # BN running var
    # MoE router bias: grown expert columns MUST be unreachable for old
    # tasks — -1e9 makes their softmax mass exactly 0.0 in f32 and their
    # argmax unreachable (kernel columns pad 0 like heads)
    "gate_bias": -1e9,
}


def grow_private(private: Dict, fresh_private: Dict) -> Dict:
    """Pad one task's private params (or bn_state) to the fresh shapes using
    exact-preservation fill values keyed by the param-name suffix."""
    out = {}
    for name, old in private.items():
        fresh = fresh_private[name]
        if tuple(fresh.shape) == tuple(old.shape):
            out[name] = old
            continue
        fill = _PRIVATE_FILL.get(name.rsplit("/", 1)[-1], 0.0)
        out[name] = _embed_block(old, torch.full(
            fresh.shape, fill, dtype=old.dtype, device=old.device))
    return out
