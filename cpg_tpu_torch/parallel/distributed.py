"""Joining the ranks of a data-parallel run.

The counterpart of `cpg_tpu.parallel.distributed`. `cpg_tpu` runs one
program a host and `jax.distributed.initialize` assembles the global device
list; the port runs one process a device and joins a torch.distributed
process group: NCCL between cards, gloo on the CPU. Gloo also carries CUDA
tensors, which is how two ranks share one card (NCCL refuses two ranks on
one GPU).

Usage (the same script in every rank, e.g. under torchrun):

    from cpg_tpu_torch.parallel import distributed as pd
    pd.initialize()                          # from torchrun's environment
    mesh = pd.make_pod_mesh(n_model=M)       # ("data", "model") or dcn too
    ... Manager(..., mesh=mesh) ...

Each rank loads its own rows of the global batch (`local_batch_slice`) and
places them on its device (`put_global_batch`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.state import resolve_device
from .mesh import Mesh, local_batch_slice, make_mesh, put_global_batch

__all__ = ["initialize", "shutdown", "local_device", "make_pod_mesh",
           "local_batch_slice", "put_global_batch"]

# the device `initialize` bound this process's rank to (process state, as
# torch.distributed's default group is)
_BOUND = {}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout: Optional[float] = None) -> Optional[torch.device]:
    """Join the process group and bind this rank to its device; returns
    that device. Idempotent.

    From explicit arguments (`coordinator_address` "host:port",
    "tcp://host:port" or "file:///path", with `num_processes` and
    `process_id`) or from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK). `device` defaults to the card of the
    local rank (raises without a card; pass "cpu" for CPU ranks);
    `backend` to NCCL for a card and gloo for the CPU (gloo on a card:
    ranks sharing it). `timeout`: seconds a collective may wait before it
    raises (torch's default without it). With nothing configured it does
    nothing and returns None, as `cpg_tpu`'s: a mesh of more than one
    device then refuses to train (`mesh.require_ranks`), so nothing trains
    single-process in silence."""
    if dist.is_initialized():
        return local_device()
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and process_id is None and "RANK" not in env):
        return None
    rank = int(env["RANK"]) if process_id is None else process_id
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(env.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {rank} (local rank {local}) has no card: "
                    f"{torch.cuda.device_count()} visible")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    _BOUND["device"] = dev
    return dev


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _BOUND.clear()


def local_device() -> torch.device:
    """This rank's device, as `initialize` bound it (a group made
    elsewhere under NCCL: the current card)."""
    if "device" in _BOUND:
        return _BOUND["device"]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError("this rank's device is unknown: join the process "
                       "group through parallel.distributed.initialize()")


def make_pod_mesh(n_model: int = 1, n_dcn: Optional[int] = None) -> Mesh:
    """The mesh over every rank, with a `dcn` axis over the hosts and a
    model axis of `n_model` ranks (the ranks of one host's model group are
    consecutive, so a model group stays on one host when n_model divides
    the host's ranks).

    `n_dcn` defaults to the hosts: the ranks over torchrun's
    LOCAL_WORLD_SIZE (one host without it). With one host this is
    `make_mesh` (no dcn axis), so a training script can call it always;
    torchrun numbers ranks host by host, which is the dcn-major order."""
    if n_dcn is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        n_dcn = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_dcn <= 1:
        return make_mesh(n_model=n_model)
    return make_mesh(n_model=n_model, n_dcn=n_dcn)
