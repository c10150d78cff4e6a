"""Device meshes for the CPG train step and for serving.

The counterpart of `cpg_tpu.parallel.mesh`. `cpg_tpu` jits one program
over a `jax.sharding.Mesh` and XLA partitions it; the port runs one
process per device (SPMD, torch.distributed) and places each collective
itself:

  * training: rank r is (data index, model index) = divmod(r, n_model), as
    `cpg_tpu` reshapes its devices to (n_data, n_model). Every rank takes
    the rows of the global batch of its data index (`local_batch_slice`).
    The ranks of one model index form the mesh's data group: the gradients
    are averaged over it before the ownership gating (train/step.py),
    BatchNorm takes its statistics over it (models/framework.py), the
    metrics come back as its means. The ranks of one data index form the
    model group: with `model_sharded`, each holds only its slice of every
    sharable kernel whose sharded axis divides (`shared_shardings`), with
    the ownership, piggymasks and optimizer moments of that slice; a
    layer gathers its output over the model group right after the product
    (parallel/collectives.py), so everything after it runs replicated
    within the group; under `act_sharder` the model group splits a
    transformer's tokens too (each rank keeps its T/M rows between the
    layers that mix tokens) and an MoE layer's experts;
  * serving (serve.py `TaskServer(mesh=)`): one process over the mesh's
    devices, one weight replica a device, each bucket split into equal
    shards, one a device, the answers gathered in order; a model axis
    serves data-parallel over all its devices, as `cpg_tpu`'s.

A mesh built while a process group is up (and without explicit devices)
spans the group's ranks, one device each, and carries the group and its
two kinds of subgroup: the training entry points take such a mesh. A mesh
of explicit devices spans devices of this process and carries no group; a
device may repeat (`[cuda:0, cuda:0]`), which lets a bucket split run on
one card. The axes are ("data", "model"), or ("dcn", "data", "model") with
`n_dcn > 1`; the batch splits over the dcn and data axes together.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.state import resolve_device
from .collectives import ShardSpec, all_reduce_sum_, broadcast_, world_size
from .collectives import rank as group_rank

DATA_AXES = ("dcn", "data")


class Mesh:
    """Devices in an array over named axes, as `jax.sharding.Mesh`:
    `devices`, `axis_names`, `shape` ({axis: size}) and `size`; with a
    process group (`group`), this process's `rank` among the mesh's ranks
    (the flat position of its device in `devices`), its `data_group` (the
    ranks of its model index; None when that is this rank alone) and its
    `model_group` (the ranks of its data index; None without a model
    axis)."""

    def __init__(self, devices: Sequence[torch.device], axis_names,
                 shape, group=None, data_group=None, model_group=None):
        flat = np.empty(len(devices), dtype=object)
        flat[:] = [torch.device(d) for d in devices]
        self.devices = flat.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.group = group
        self.data_group = data_group
        self.model_group = model_group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_size(self) -> int:
        """The ranks (or devices) the batch splits over."""
        return int(np.prod([self.shape.get(a, 1) for a in DATA_AXES]))

    @property
    def model_size(self) -> int:
        """The ranks (or devices) a sharded kernel splits over."""
        return self.shape.get("model", 1)

    @property
    def rank(self) -> Optional[int]:
        return None if self.group is None else group_rank(self.group)

    @property
    def data_rank(self) -> int:
        """This rank's index along the data axes (0 without a group)."""
        return (self.rank or 0) // self.model_size

    @property
    def model_rank(self) -> int:
        """This rank's index along the model axis (0 without a group)."""
        return (self.rank or 0) % self.model_size

    @property
    def device(self) -> torch.device:
        """This process's device: its rank's, or the first one's."""
        return self.devices.flat[self.rank or 0]

    @property
    def is_main(self) -> bool:
        """Whether this process writes what the run writes once (rank 0,
        or the only process)."""
        return not self.rank

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}"
                f"{', ranks' if self.group is not None else ''})")


def _local_devices():
    """This process's cards (raises without one: pass CPU devices to
    build a mesh on the CPU)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _rank_devices():
    """Every rank's device, in rank order."""
    from .distributed import local_device

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, str(local_device()))
    return [torch.device(d) for d in out]


def _subgroups(n_data: int, n_model: int):
    """(data group, model group) of this rank in a world of n_data x
    n_model ranks, rank r at (r // n_model, r % n_model). Every rank creates
    every subgroup, in one order (torch.distributed hangs a rank that
    creates only its own); a subgroup of one rank is None."""
    if n_model == 1:
        return dist.group.WORLD, None
    me = dist.get_rank()
    data = model = None
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks) if n_data > 1 else None
        if me in ranks:
            data = g
    for d in range(n_data):
        ranks = list(range(d * n_model, (d + 1) * n_model))
        g = dist.new_group(ranks)
        if me in ranks:
            model = g
    return data, model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None,
              n_dcn: int = 1) -> Mesh:
    """The mesh of `n_dcn * n_data * n_model` devices: with a process group
    up and no `devices`, one device a rank over every rank (`n_data`
    defaults to the ranks over `n_dcn * n_model`), with its data and model
    subgroups; otherwise `devices` (default: this process's cards; raises
    without one) in this process."""
    if n_model < 1 or n_dcn < 1:
        raise ValueError(f"a mesh of {n_dcn} x {n_data} x {n_model} devices")
    spmd = devices is None and dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = _rank_devices() if spmd else _local_devices()
    devices = list(devices)
    step = n_dcn * n_model
    n_total = (len(devices) // step * step if n_data is None
               else step * n_data)
    if not 0 < n_total <= len(devices):
        raise ValueError(f"a mesh of {n_dcn} x {n_data} x {n_model} devices "
                         f"over {len(devices)}")
    if spmd and n_total != len(devices):
        raise ValueError(f"a mesh over the process group spans all "
                         f"{len(devices)} ranks, not {n_total}")
    n_data = n_total // step
    groups = ((dist.group.WORLD, *_subgroups(n_dcn * n_data, n_model))
              if spmd else (None, None, None))
    if n_dcn > 1:
        return Mesh(devices[:n_total], ("dcn", "data", "model"),
                    (n_dcn, n_data, n_model), *groups)
    return Mesh(devices[:n_total], ("data", "model"), (n_data, n_model),
                *groups)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: replicated, or its rows split over the
    data axes (`batch`)."""

    mesh: Mesh
    batch: bool

    def rows(self, n: int) -> slice:
        """This process's rows of an n-row tensor."""
        return local_batch_slice(self.mesh, n) if self.batch else slice(0, n)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, batch=False)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The batch axis split over every data axis (dcn included)."""
    return Sharding(mesh, batch=True)


def require_ranks(mesh: Mesh) -> None:
    """Raise unless `mesh` is one a training process can use: one rank a
    device under a process group, or one device."""
    if mesh.size > 1 and mesh.group is None:
        raise ValueError(
            f"{mesh}: training over {mesh.size} devices runs one process a "
            "device; call parallel.distributed.initialize() in each (or run "
            "`sequence --parallel N`) and build the mesh after it")


def local_batch_slice(mesh: Mesh, global_batch: int) -> slice:
    """The [start, stop) rows of the global batch this process takes: all
    of them in a process without a group, else its data index's equal
    share (the ranks of one model group take the same rows)."""
    if mesh.group is None:
        return slice(0, global_batch)
    n = mesh.data_size
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split into "
                         f"{n} equal shards")
    per = global_batch // n
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def put_global_batch(mesh: Mesh, x, y):
    """This process's rows (see `local_batch_slice`), on its device."""
    require_ranks(mesh)
    return (torch.as_tensor(x).to(mesh.device),
            torch.as_tensor(y).to(mesh.device))


def shard_batch(mesh: Mesh, x, y):
    """This process's rows of a global batch, on its device."""
    sl = local_batch_slice(mesh, len(x))
    return put_global_batch(mesh, x[sl], y[sl])


def shared_shardings(mesh: Mesh, shared, model_sharded: bool = False
                     ) -> Dict[str, Optional[ShardSpec]]:
    """{key: ShardSpec or None (replicated)} for the shared kernels AND
    their ownership and piggymask trees (same shapes, same split), from the
    whole tree `shared` (tensors or shapes).

    Under `model_sharded`, `cpg_tpu`'s rule: a kernel splits along its
    output channels, one under an `/experts/` scope along its leading
    expert axis instead when the experts divide; an axis that does not
    divide over the model axis stays replicated. `index` is this rank's
    model index."""
    n = mesh.model_size

    def spec(name, w) -> Optional[ShardSpec]:
        shape = tuple(getattr(w, "shape", w))
        if not model_sharded or n == 1:
            return None
        if "/experts/" in name and shape[0] % n == 0:
            axis = 0  # cpg_tpu's _expert_spec: whole experts a rank
        elif shape[-1] % n == 0:
            axis = len(shape) - 1  # its _kernel_spec: HWIO or (in, out)
        else:
            return None
        return ShardSpec(axis, shape[axis], n, mesh.model_rank,
                         mesh.model_group)

    return {k: spec(k, w) for k, w in shared.items()}


@dataclasses.dataclass(frozen=True)
class ActSharder:
    """The activation-sharding hook of `act_sharder` over the mesh's model
    group (`parts` ranks, this one at `index`): `spec(x, tag)` is the
    split the seam `tag` makes of x (axis 1), or None where it leaves x
    whole; `Ctx.constrain` takes this rank's part (`split_tokens`)."""

    group: object = dataclasses.field(compare=False, repr=False)
    parts: int
    index: int
    tokens: bool
    experts: bool

    def spec(self, x, tag) -> Optional[ShardSpec]:
        ndims = {"tokens": (2, 3), "experts": (4,)}.get(tag, ())
        if (self.parts == 1 or not getattr(self, tag, False)
                or x.dim() not in ndims or x.shape[1] % self.parts):
            return None
        return ShardSpec(1, x.shape[1], self.parts, self.index, self.group)


def act_sharder(mesh: Mesh, tokens: bool = False, experts: bool = False
                ) -> ActSharder:
    """The activation-sharding hook for models (framework.Ctx.act_sharder;
    `cpg_tpu`'s is a callable (array, tag) -> array), its seams over the
    mesh's model group:

      * tag `"tokens"` on (N, T, D) transformer activations (sequence
        parallelism): each rank of a model group keeps its T/M tokens
        (`split_tokens`). LayerNorm, the MLPs and the residual adds run on
        them; attention, the MoE layer and the mean pool gather the tokens
        whole first (models/vit.py, models/moe.py). On (N, T) token ids
        (models/text.py) the port's embedding looks up this rank's rows
        alone;
      * tag `"experts"` on (N, E, C, D) MoE dispatch tensors (expert
        parallelism): each rank runs its E/M experts' slots, the kernels'
        experts under a model axis that splits them, else its experts of
        the replicated kernels, and the outputs are gathered before the
        combine.

    `cpg_tpu`'s seams are layout notes that XLA turns into collectives;
    the port's move the data. An array whose axis does not divide over
    the model axis passes whole (e.g. an old task evaluated at a
    pre-growth expert count), and a mesh without a model axis leaves every
    seam whole. The batch is split over the data axes already (each rank
    holds its rows)."""
    return ActSharder(mesh.model_group, mesh.model_size, mesh.model_rank,
                      tokens, experts)


def whole_shapes(shared, shards) -> Dict[str, tuple]:
    """{key: whole shape} of a shared tree that may hold shards."""
    return {k: (shards[k].whole_shape(w.shape) if k in shards
                else tuple(w.shape)) for k, w in shared.items()}


def place_state(mesh: Mesh, tree, sharding=None):
    """Place a flat state tree on the mesh: every tensor on this process's
    device (tensors already there are kept), rank 0's bytes broadcast into
    them in place, so every replica starts bit-equal; returns the placed
    tree.

    `sharding`: None (or `replicated(mesh)`) replicates every tensor; a
    dict of `shared_shardings` splits the tensors of its keys: a whole
    tensor is broadcast over the ranks, then this rank keeps its slice; a
    tensor that is a slice already is broadcast over the data group."""
    if isinstance(sharding, Sharding) and sharding.batch:
        raise ValueError("place_state places state; a batch goes through "
                         "shard_batch")
    require_ranks(mesh)
    if tree is None:
        return None
    specs = sharding if isinstance(sharding, dict) else {}
    world, data, cut = [], [], {}
    out = {}
    for k, t in tree.items():
        t = out[k] = t.to(mesh.device)
        spec = specs.get(k)
        if spec is None or spec.is_whole(t):
            world.append(t)
            if spec is not None:
                cut[k] = spec
        else:
            data.append(t)
    broadcast_(world, mesh.group)
    broadcast_(data, mesh.data_group)
    for k, spec in cut.items():
        out[k] = spec.take(out[k])
    return out


def _dp_group(mesh: Mesh):
    """The group the step reduces its gradients, BatchNorm statistics and
    metrics over: the mesh's data group (the step treats a group of one
    rank as none: a mesh of one device runs the single-device step bit for
    bit)."""
    require_ranks(mesh)
    return mesh.data_group


def _model_shards(model_sharded: bool, shards):
    """The split kernels' specs a model-sharded step runs on ({} without)."""
    if model_sharded and shards is None:
        raise ValueError("model_sharded=True needs the state's shards "
                         "(CPGState.shards, as place_state split it)")
    return dict(shards) if model_sharded else {}


def make_parallel_train_step(step_fn, mesh: Mesh, model_sharded: bool = False,
                             shards=None):
    """The step of train/step.py `build_train_step` (same 12 arguments,
    `it` carried as given) over the mesh: x and y are this process's rows
    (`shard_batch`), `rng` draws the global batch's augmentation and each
    rank keeps its rows; gradients, BatchNorm statistics and metrics are
    reduced over the data group.

    `model_sharded=True` (needs `shards`, the state's `CPGState.shards`:
    the non-None `shared_shardings` that `place_state` split it by):
    shared, ownership and piggymask hold this rank's slices, and the
    optimizer states were built from them, so their moments have the
    slices' shapes (`cpg_tpu`'s `opt_state_shardings`); each split layer
    runs on its slice and gathers its output over the model group."""
    return functools.partial(step_fn, group=_dp_group(mesh),
                             shards=_model_shards(model_sharded, shards))


def make_parallel_eval_step(eval_fn, mesh: Mesh, model_sharded: bool = False,
                            shards=None):
    """The eval step of train/step.py over the mesh: this process's rows
    in, its logits out, the plain step's `acc_sum` summed and `loss`
    averaged over the data group. `model_sharded`: as
    `make_parallel_train_step`; the piggymask passed in is any task's,
    placed under the same split."""
    group = _dp_group(mesh)
    shards = _model_shards(model_sharded, shards)

    def step(*args):
        logits, m = eval_fn(*args, shards=shards)
        both = all_reduce_sum_(torch.stack([m["acc_sum"].double(),
                                            m["loss"].double()]), group)
        return logits, {"acc_sum": both[0].to(m["acc_sum"].dtype),
                        "loss": (both[1] / world_size(group)).to(
                            m["loss"].dtype)}

    return step
