"""Pipeline parallelism (GPipe) for homogeneous transformer block stacks.

The counterpart of `cpg_tpu.parallel.pipeline`. `cpg_tpu` runs the
schedule as one `shard_map`ped `fori_loop` over a `pipe` mesh axis; the
port runs one process a stage (torch.distributed ranks) and the same
schedule eagerly:

  * every stage holds the whole state, replicated, and runs only its
    depth/S consecutive blocks of the stacked parameters;
  * microbatch m enters stage 0 at tick m and leaves stage S-1 at tick
    m + S - 1; the loop runs n_micro + S - 1 ticks, a stage's output
    going to the next stage after each (`ppermute_ring`); dead ticks run
    and are masked, never skipped;
  * every stage builds the same autograd graph and issues the same
    collectives in the same order, forward and backward: the stage
    conditions are tensors (`torch.where`), never a Python branch on the
    rank;
  * the stacked parameters and the token input enter through
    `to_model_group` over the pipe group (the identity forward; the
    backward sums the stages' gradients, each block's being non-zero on
    its own stage only), and the last stage's rows reach every stage
    through `psum_replicated` (an all-reduce whose backward is the
    identity), so every stage ends with the same output and the same
    whole gradients and its replica of the state stays bit-equal.

CPG semantics ride along unchanged: the blocks consume the effective
params (ops/masked.py), so ownership and piggymask selection are those of
every other path; the stacked layout is a differentiable `torch.stack` of
the flat `blocks/{i}/...` entries.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .collectives import (ppermute_ring, psum_replicated, to_model_group,
                          world_size)
from .mesh import Mesh, _local_devices, _rank_devices


def make_pipeline_mesh(n_stages: int, devices=None) -> Mesh:
    """A 1-D ("pipe",) mesh of `n_stages` ranks, one stage a rank: the
    first `n_stages` ranks of the process group, with their group (every
    rank calls it; a rank past them holds a mesh it cannot run). Without a
    process group, one stage on this process's device (`devices[0]`,
    default this process's first card). Raises on too few ranks."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world < n_stages:
            raise ValueError(f"pipeline needs {n_stages} ranks (devices), "
                             f"only {world} available")
        group = (dist.group.WORLD if world == n_stages
                 else dist.new_group(list(range(n_stages))))
        return Mesh(_rank_devices()[:n_stages], ("pipe",), (n_stages,),
                    group=group)
    devices = list(devices) if devices is not None else _local_devices()
    if n_stages != 1:
        raise ValueError(f"pipeline needs {n_stages} ranks (devices), only "
                         "1 available: one process runs one stage (join a "
                         "process group first)")
    return Mesh(devices[:1], ("pipe",), (1,))


def stack_block_params(tree: Dict[str, torch.Tensor], depth: int,
                       prefix: str = "blocks/"):
    """{"blocks/i/rest": leaf} -> stacked {"rest": (depth, ...)}, and the
    passthrough {key: leaf} of every key outside `prefix`. `torch.stack`
    is differentiable, so gradients land on the flat entries."""
    cols: Dict[str, list] = {}
    rest: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if k.startswith(prefix):
            i, sub = k[len(prefix):].split("/", 1)
            cols.setdefault(sub, [None] * depth)[int(i)] = v
        else:
            rest[k] = v
    for sub, vs in cols.items():
        missing = [i for i, v in enumerate(vs) if v is None]
        if missing:
            raise ValueError(f"block param {sub!r} missing for blocks "
                             f"{missing} (depth={depth})")
    return {k: torch.stack(v) for k, v in cols.items()}, rest


def _default_block_fn(params: Dict[str, torch.Tensor], x, compute_dtype,
                      block_kwargs, flash_attention: bool = False):
    """One ViT encoder block from a per-block param dict of relative names
    (attn/..., ln1/..., mlp/..., ln2/...); `flash_attention` routes its
    attention through K7 (ops/flash.py); `cpg_tpu`'s runs the plain
    attention, and so does this one by default."""
    from ..models.framework import Ctx
    from ..models.vit import vit_block

    ctx = Ctx(mode="apply", train=False, shared=params, private=params,
              bn_state={}, compute_dtype=compute_dtype,
              flash_attention=flash_attention)
    return vit_block(ctx, x, **block_kwargs)


def pipeline_blocks(mesh: Mesh, stacked: Dict[str, torch.Tensor], x,
                    n_micro: int, block_kwargs: Optional[dict] = None,
                    block_fn: Callable = _default_block_fn,
                    compute_dtype=torch.float32):
    """Run `depth` stacked blocks over `x` (N, T, D) as an S-stage GPipe
    on this rank's stage. S = mesh.shape["pipe"]; depth % S == 0 (each
    stage runs depth/S blocks); N % n_micro == 0. Bubble fraction
    (S-1)/(n_micro+S-1). The carries are in result_type(x, compute
    dtype) (a bf16 stream through f32 blocks promotes at the residual).

    Returns the block stack's output, the same on every stage."""
    S = int(mesh.shape["pipe"])
    depth = next(iter(stacked.values())).shape[0]
    if depth % S:
        raise ValueError(f"depth {depth} not divisible by {S} stages")
    n = x.shape[0]
    if n % n_micro:
        raise ValueError(f"batch {n} not divisible by n_micro {n_micro}")
    group = mesh.group if world_size(mesh.group) > 1 else None
    stage = mesh.rank or 0
    per = depth // S
    bkw = block_kwargs or {}
    mine = {k: to_model_group(v, group).narrow(0, stage * per, per)
            for k, v in stacked.items()}
    xm = to_model_group(x, group).reshape(n_micro, n // n_micro,
                                          *x.shape[1:])
    first_stage = torch.tensor(stage == 0, device=x.device)
    last_stage = torch.tensor(stage == S - 1, device=x.device)
    odt = torch.promote_types(x.dtype, compute_dtype)
    buf = torch.zeros(xm.shape[1:], dtype=odt, device=x.device)
    outs = [torch.zeros_like(buf) for _ in range(n_micro)]
    ticks = n_micro + S - 1
    for t in range(ticks):
        y = torch.where(first_stage, xm[min(t, n_micro - 1)], buf).to(odt)
        for j in range(per):
            y = block_fn({k: v[j] for k, v in mine.items()}, y,
                         compute_dtype, bkw)
        if t >= S - 1:  # the last stage finishes microbatch t - (S - 1)
            slot = t - (S - 1)
            outs[slot] = torch.where(last_stage, y, outs[slot])
        if t < ticks - 1:
            buf = ppermute_ring(y, group)
    # only the last stage holds real rows: summed into every stage
    out = psum_replicated(torch.stack(outs), group)
    return out.reshape(x.shape)


def make_pipeliner(mesh: Mesh, n_micro: int, depth: int,
                   block_fn: Callable = _default_block_fn) -> Callable:
    """The pipeline hook for `TrainConfig.pipeliner` / `Ctx.pipeline`:
    `(merged_params, tokens, block_kwargs, compute_dtype) -> tokens`,
    merged_params the model's flat {**effective_shared, **private} dict.
    Differentiable: the train step (gating, piggymask gradients,
    optimizers) runs through it unchanged, one process a stage, every
    stage with the same state, batches and draws. The hook carries its
    `mesh` (the Manager lets only the pipe group's rank 0 write)."""
    def run(merged, tokens, block_kwargs, compute_dtype=torch.float32):
        stacked, _ = stack_block_params(merged, depth)
        return pipeline_blocks(mesh, stacked, tokens, n_micro,
                               block_kwargs=block_kwargs, block_fn=block_fn,
                               compute_dtype=compute_dtype)

    run.mesh = mesh
    return run
