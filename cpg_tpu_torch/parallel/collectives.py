"""The collectives of parallel training, over a torch.distributed group.

`group=None` means no group: one process, whose batch is the whole batch,
and every function here is then the identity (as it is over a group of one
rank).

The model axis (parallel/mesh.py) splits a kernel over the ranks of a
model group (`ShardSpec`). A layer whose kernel is split runs as
`to_model_group(x)` -> the product on this rank's shard ->
`gather_from_model_group(y, axis)`: the input's gradient is the sum of the
ranks' partial gradients, and the output is whole again at once.
`gather_state` and `shard_state` move a whole state between its shards
and whole tensors.

Activation sharding (parallel/mesh.py `act_sharder`) splits a transformer's
token axis over the model group. A tensor held whole on every rank of the
group carries its whole gradient on each; one held as this rank's rows
carries its rows' gradient. `split_tokens` takes this rank's rows (its
backward all-gathers the rows' gradients), `gather_from_model_group(x,
group, 1)` makes rows whole where tokens mix (its backward keeps this
rank's rows), and `gather_tokens` makes rows whole for a product on a
kernel shard: its backward sums the ranks' partial input gradients, in
`to_model_group`'s place.

The pipeline (parallel/pipeline.py) moves a stage's output to the next
stage (`ppermute_ring`) and sums the stages' rows into every stage
(`psum_replicated`, whose backward is the identity: every stage holds the
whole gradient of what it holds).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

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


# ---------------------------------------------------------------------------
# The model axis: kernels split over the ranks of a model group.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """A tensor split into `parts` equal slices along `axis` over the ranks
    of `group`: `size` is the whole axis, `index` this rank's slice (its
    rank in the group)."""

    axis: int
    size: int
    parts: int
    index: int
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)

    @property
    def width(self) -> int:
        """The length of one slice along `axis`."""
        return self.size // self.parts

    def shard_shape(self, shape) -> tuple:
        """This rank's shape of a whole tensor of `shape`."""
        shape = tuple(shape)
        if shape[self.axis] != self.size:
            raise ValueError(f"axis {self.axis} of {shape} is not {self.size}")
        return shape[:self.axis] + (self.width,) + shape[self.axis + 1:]

    def whole_shape(self, shape) -> tuple:
        """The whole shape of a shard of `shape`."""
        shape = tuple(shape)
        return shape[:self.axis] + (self.size,) + shape[self.axis + 1:]

    def is_whole(self, t: torch.Tensor) -> bool:
        return t.shape[self.axis] == self.size

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor, as a contiguous copy."""
        return t.narrow(self.axis, self.index * self.width,
                        self.width).contiguous()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (a collective)."""
        return all_gather_along(t, self.group, self.axis)


def all_gather_along(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along `axis` in rank
    order; `t` itself at one rank. The bytes travel as they are (any
    dtype), through `dist.all_gather`; not differentiable."""
    n = world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    raw = t.view(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    return torch.cat([p.view(t.dtype).view(t.shape) for p in parts], axis)


class _ToModelGroup(torch.autograd.Function):
    """y = x; the gradient of x is the sum of y's gradients over the group
    (each rank's product on its shard gives a partial one), summed in f32
    and returned in x's dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(s, group=ctx.group)
        return s.to(g.dtype), None


class _GatherFromModelGroup(torch.autograd.Function):
    """y = the group's shards concatenated along `axis`; the gradient of a
    shard is this rank's slice of y's gradient."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.axis, ctx.width = axis, x.shape[axis]
        ctx.start = rank(group) * ctx.width
        return all_gather_along(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.start, ctx.width).contiguous(), None, None


def to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a product on a kernel shard: the identity forward; the
    backward sums the ranks' partial gradients over the model group."""
    if world_size(group) == 1:
        return x
    return _ToModelGroup.apply(x, group)


def gather_from_model_group(y: torch.Tensor, group, axis: int
                            ) -> torch.Tensor:
    """The output of a product on a kernel shard made whole: the ranks'
    slices concatenated along `axis` (the kernel's output channels or its
    experts); the backward keeps this rank's slice of the gradient."""
    if world_size(group) == 1:
        return y
    return _GatherFromModelGroup.apply(y, group, axis)


def _tree_of(state, fn):
    """`fn(tree, key, tensor)` over the trees of a state that a model axis
    splits: shared, ownership and every task's piggymask; a new state."""
    def tree(d):
        return None if d is None else {k: fn(k, v) for k, v in d.items()}

    return dataclasses.replace(
        state, shared=tree(state.shared), ownership=tree(state.ownership),
        tasks={tid: dataclasses.replace(t, piggymask=tree(t.piggymask))
               for tid, t in state.tasks.items()})


def gather_state(state):
    """The whole state from this rank's shards (`state.shards`): every split
    tensor of shared, ownership and the piggymasks all-gathered over its
    model group, everything else kept (no copy); the result records no
    shards. A collective: every rank of the model groups calls it. A state
    without shards is returned as it is."""
    if not state.shards:
        return state
    shards = state.shards
    out = _tree_of(state, lambda k, v: shards[k].gather(v) if k in shards
                   else v)
    out.shards = {}
    return out


def shard_state(state, shards: Dict[str, Optional[ShardSpec]]):
    """This rank's shards of a whole state (the same on every rank of the
    model group): each tensor of shared, ownership and the piggymasks whose
    key `shards` splits becomes its slice (a copy); the specs are recorded
    on the result as `shards`."""
    if state.shards:
        raise ValueError("shard_state takes a whole state; this one is "
                         "sharded already")
    shards = {k: s for k, s in shards.items() if s is not None}
    out = _tree_of(state, lambda k, v: shards[k].take(v) if k in shards
                   else v)
    out.shards = shards
    return out


# ---------------------------------------------------------------------------
# Activation sharding and the pipeline's ring.
# ---------------------------------------------------------------------------


class _SplitTokens(torch.autograd.Function):
    """y = this rank's slice of x along axis 1; the gradient of x is the
    ranks' slices of y's gradient all-gathered (x is whole on every
    rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        width = x.shape[1] // world_size(group)
        return x.narrow(1, rank(group) * width, width).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_along(g, ctx.group, 1), None


class _GatherTokens(torch.autograd.Function):
    """y = the ranks' slices all-gathered along axis 1; the gradient of a
    slice is the sum over the group of y's gradient (each rank's is a
    partial one), summed in f32, narrowed to this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[1]
        return all_gather_along(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        s = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(s, group=ctx.group)
        return (s.narrow(1, rank(ctx.group) * ctx.width, ctx.width)
                .to(g.dtype).contiguous(), None)


def split_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's 1/M of `x` along axis 1 (the tokens of (N, T, D) or
    (N, T) ids; an MoE dispatch's experts of (N, E, C, D)), M the group's
    ranks, which must divide it; backward: the slices' gradients
    all-gathered. `x` itself at one rank."""
    if world_size(group) == 1:
        return x
    if x.shape[1] % world_size(group):
        raise ValueError(f"axis 1 of {tuple(x.shape)} does not split over "
                         f"{world_size(group)} ranks")
    return _SplitTokens.apply(x, group)


def gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' slices of `x` concatenated along axis 1, for a product
    whose ranks each give a partial input gradient (a kernel shard): the
    backward sums the gradient over the group, then keeps this rank's
    slice. `x` itself at one rank."""
    if world_size(group) == 1:
        return x
    return _GatherTokens.apply(x, group)


class _PpermuteRing(torch.autograd.Function):
    """y on stage r is stage (r - 1) mod S's x; the gradient goes round
    the other way. Built on all_gather (one route for gloo and NCCL)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring_take(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return _ring_take(g, ctx.group, 1), None


def _ring_take(x, group, step):
    """Stage (r + step) mod S's x, on stage r."""
    n = world_size(group)
    parts = all_gather_along(x.unsqueeze(0), group, 0)
    return parts[(rank(group) + step) % n].contiguous()


def ppermute_ring(y: torch.Tensor, group) -> torch.Tensor:
    """`y` sent from stage r to stage (r + 1) mod S (`lax.ppermute` over
    the ring): each stage returns its predecessor's `y`; the backward
    sends the gradient to the predecessor. `y` itself at one stage."""
    if world_size(group) == 1:
        return y
    return _PpermuteRing.apply(y, group)


class _PsumReplicated(torch.autograd.Function):
    """y = the sum of x over the group; the gradient of x is y's gradient
    as it is: every rank computes the same y and the same loss from it,
    so each holds y's whole gradient already."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_replicated(y: torch.Tensor, group) -> torch.Tensor:
    """The sum of `y` over the group's ranks, taken where the result is
    used alike on every rank: the backward is the identity (unlike
    `all_reduce_sum`'s, which sums the gradient over the ranks as well).
    `y` itself at one rank."""
    if world_size(group) == 1:
        return y
    return _PsumReplicated.apply(y, group)
