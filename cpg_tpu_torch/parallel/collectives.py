"""The collectives of data-parallel training, over a torch.distributed group.

`group=None` means no group: one process, whose batch is the whole batch,
and every function here is then the identity (as it is over a group of one
rank).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist


def world_size(group) -> int:
    """The ranks in `group` (1 without a group)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in `group` (0 without a group)."""
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group's ranks; the gradient of x is the
    sum of y's gradients over the ranks (every rank's loss depends on y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group's ranks, differentiable; `x` itself at
    one rank or without a group."""
    if world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Replace `t` by its sum over the group's ranks, in place; returns
    it."""
    if world_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the group's ranks, in place,
    with one all-reduce per dtype over a flat buffer."""
    w = world_size(group)
    if w == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= w
        o = 0
        for t in ts:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()


def broadcast_(tensors: Iterable[torch.Tensor], group) -> None:
    """Overwrite every tensor with the group's rank 0's bytes, in place:
    one broadcast of their bytes (the tensors must share a device)."""
    ts = [t for t in tensors if t.numel()]
    if world_size(group) == 1 or not ts:
        return
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("broadcast_ needs contiguous tensors")
    flat = torch.cat([t.view(-1).view(torch.uint8) for t in ts])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    o = 0
    for t in ts:
        n = t.numel() * t.element_size()
        t.view(-1).view(torch.uint8).copy_(flat[o:o + n])
        o += n


def agree(values: torch.Tensor, group) -> torch.Tensor:
    """For each entry of an int64 vector, whether every rank holds the same
    value (one all-reduce of the maximum of (v, -v))."""
    if world_size(group) == 1:
        return torch.ones_like(values, dtype=torch.bool)
    both = torch.cat([values, -values])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, neg_lo = both.chunk(2)
    return hi == -neg_lo


def checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of a tensor's bits (its 32-bit words, or bytes for
    other widths): the plain sum and one weighted by position, so equal
    checksums mean equal bits up to a collision. Integer sums wrap and are
    exact in any order."""
    t = t.detach().contiguous().view(-1)
    w = (t.view(torch.int32) if t.element_size() == 4
         else t.view(torch.uint8)).long()
    pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
    return torch.stack([w.sum(), (w * pos).sum()])


def barrier(group) -> None:
    if world_size(group) > 1:
        dist.barrier(group=group)
