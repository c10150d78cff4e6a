"""Device meshes for the CPG train step and for serving, along the data axes.

The counterpart of `cpg_tpu.parallel.mesh`. `cpg_tpu` jits one program
over a `jax.sharding.Mesh` and XLA inserts the reductions; the port runs
one process per device (SPMD, torch.distributed):

  * training: every rank holds the replicated state on its own device,
    takes its rows of the global batch (`local_batch_slice`) and meets the
    other ranks in collectives: the gradients are averaged over the ranks
    before the ownership gating (train/step.py), BatchNorm takes its
    statistics over the global batch (models/framework.py), the metrics
    come back as global means;
  * serving (serve.py `TaskServer(mesh=)`): one process over the mesh's
    devices, one weight replica a device, each bucket split into equal
    shards, one a device, the answers gathered in order.

A mesh built while a process group is up (and without explicit devices)
spans the group's ranks, one device each, and carries the group: the
training entry points take such a mesh. A mesh of explicit devices spans
devices of this process and carries no group; a device may repeat
(`[cuda:0, cuda:0]`), which lets a bucket split run on one card. The axes
are ("data", "model"), or ("dcn", "data", "model") with `n_dcn > 1`; the
batch splits over the dcn and data axes together. The model axis (output-
channel sharded kernels, expert sharding, activation sharding) stays at 1.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.state import resolve_device
from .collectives import all_reduce_sum_, broadcast_, world_size
from .collectives import rank as group_rank

MODEL_AXIS = ("the model axis (output-channel sharded kernels, expert "
              "sharding, activation sharding) is not ported to cpg_tpu_torch "
              "yet (ROADMAP Queue 1, item 12)")
DATA_AXES = ("dcn", "data")


class Mesh:
    """Devices in an array over named axes, as `jax.sharding.Mesh`:
    `devices`, `axis_names`, `shape` ({axis: size}) and `size`; with a
    process group (`group`), this process's `rank` among the mesh's ranks
    (the flat position of its device in `devices`)."""

    def __init__(self, devices: Sequence[torch.device], axis_names,
                 shape, group=None):
        flat = np.empty(len(devices), dtype=object)
        flat[:] = [torch.device(d) for d in devices]
        self.devices = flat.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.group = group

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
    def rank(self) -> Optional[int]:
        return None if self.group is None else group_rank(self.group)

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


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None,
              n_dcn: int = 1) -> Mesh:
    """The mesh of `n_dcn * n_data` devices: with a process group up and no
    `devices`, one device a rank over every rank (`n_data` defaults to the
    ranks over `n_dcn`); otherwise `devices` (default: this process's
    cards; raises without one) in this process."""
    if n_model != 1:
        raise NotImplementedError(f"make_mesh(n_model={n_model}): "
                                  f"{MODEL_AXIS}")
    spmd = devices is None and dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = _rank_devices() if spmd else _local_devices()
    devices = list(devices)
    n_total = (len(devices) // n_dcn * n_dcn if n_data is None
               else n_dcn * n_data)
    if not 0 < n_total <= len(devices):
        raise ValueError(f"a mesh of {n_dcn} x {n_data} devices over "
                         f"{len(devices)}")
    if spmd and n_total != len(devices):
        raise ValueError(f"a mesh over the process group spans all "
                         f"{len(devices)} ranks, not {n_total}")
    n_data = n_total // n_dcn
    if n_dcn > 1:
        return Mesh(devices[:n_total], ("dcn", "data", "model"),
                    (n_dcn, n_data, 1), dist.group.WORLD if spmd else None)
    return Mesh(devices[:n_total], ("data", "model"), (n_data, 1),
                dist.group.WORLD if spmd else None)


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
    of them in a process without a group, else its rank's equal share."""
    if mesh.group is None:
        return slice(0, global_batch)
    n = mesh.data_size
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split into "
                         f"{n} equal shards")
    per = global_batch // n
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def put_global_batch(mesh: Mesh, x, y):
    """This process's rows (see `local_batch_slice`), on its device."""
    require_ranks(mesh)
    return (torch.as_tensor(x).to(mesh.device),
            torch.as_tensor(y).to(mesh.device))


def shard_batch(mesh: Mesh, x, y):
    """This process's rows of a global batch, on its device."""
    sl = local_batch_slice(mesh, len(x))
    return put_global_batch(mesh, x[sl], y[sl])


def _map(tree, fn):
    """`fn` on every tensor of a nested dict (other leaves kept)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def place_state(mesh: Mesh, tree, sharding=None):
    """Replicate a (nested dict) state tree on the mesh: every tensor on
    this process's device (tensors already there are kept), then rank 0's
    bytes broadcast into them in place, so every replica starts
    bit-equal."""
    if sharding is not None and sharding.batch:
        raise NotImplementedError(f"place_state(sharding=...): {MODEL_AXIS}")
    require_ranks(mesh)
    placed = []

    def put(t):
        placed.append(t.to(mesh.device))
        return placed[-1]

    tree = _map(tree, put)
    broadcast_(placed, mesh.group)
    return tree


def _dp_group(mesh: Mesh):
    """The group the step reduces over (the step treats a group of one
    rank as none: a mesh of one device runs the single-device step bit for
    bit)."""
    require_ranks(mesh)
    return mesh.group


def make_parallel_train_step(step_fn, mesh: Mesh, model_sharded: bool = False):
    """The step of train/step.py `build_train_step` (same 12 arguments,
    `it` carried as given) run data-parallel over the mesh: x and y are this
    process's rows (`shard_batch`), `rng` draws the global batch's
    augmentation and each rank keeps its rows; gradients, BatchNorm
    statistics and metrics are reduced over the ranks."""
    if model_sharded:
        raise NotImplementedError(f"model_sharded=True: {MODEL_AXIS}")
    return functools.partial(step_fn, group=_dp_group(mesh))


def make_parallel_eval_step(eval_fn, mesh: Mesh, model_sharded: bool = False):
    """The eval step of train/step.py over the mesh: this process's rows
    in, its logits out, the plain step's `acc_sum` summed and `loss`
    averaged over the ranks."""
    if model_sharded:
        raise NotImplementedError(f"model_sharded=True: {MODEL_AXIS}")
    group = _dp_group(mesh)

    def step(*args):
        logits, m = eval_fn(*args)
        both = all_reduce_sum_(torch.stack([m["acc_sum"].double(),
                                            m["loss"].double()]), group)
        return logits, {"acc_sum": both[0].to(m["acc_sum"].dtype),
                        "loss": (both[1] / world_size(group)).to(
                            m["loss"].dtype)}

    return step
