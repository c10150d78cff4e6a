"""Larger-than-RAM input: memory-mapped datasets and a device prefetcher.

The counterpart of `cpg_tpu.data.stream`. A dataset is written once as flat
`.npy` files beside a `meta.json` (`save_memmap_dataset`), the same layout
as `cpg_tpu`'s, so a directory written by either package loads in the
other; training maps it with `np.load(mmap_mode="r")`, so the OS pages rows
in on demand and only the working set must fit in RAM. Batches are
gathered on the host (the C++ loader, data/native_loader.py, or a NumPy
gather) and `DevicePrefetcher` keeps the next batches' host-to-device
copies in flight while the current step computes. Augmentation runs on the
card (data/augment.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from ..parallel.mesh import require_ranks

_META = "meta.json"


def save_memmap_dataset(out_dir: str, data: Dict) -> None:
    """Write a data dict ({train,test}_{x,y} and extras) as flat .npy files;
    scalars, strings and lists go to meta.json. A callable (a face task's
    `loss_fn`) cannot be stored: store the marker {"loss": "angle"} and the
    CLI reattaches the A-Softmax loss."""
    os.makedirs(out_dir, exist_ok=True)
    meta = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray):
            np.save(os.path.join(out_dir, f"{k}.npy"), v)
            meta[k] = {"shape": list(v.shape), "dtype": str(v.dtype)}
        elif not callable(v):
            meta[k] = v
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f)


def load_memmap_dataset(in_dir: str) -> Dict:
    """A `save_memmap_dataset` directory with every array memory-mapped
    read-only: a drop-in for the in-memory data dicts of Manager and
    run_sequence."""
    with open(os.path.join(in_dir, _META)) as f:
        meta = json.load(f)
    out: Dict = {}
    for k, v in meta.items():
        path = os.path.join(in_dir, f"{k}.npy")
        if isinstance(v, dict) and os.path.exists(path):
            out[k] = np.load(path, mmap_mode="r")
        else:
            out[k] = v
    return out


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class _Slot:
    """A pinned staging pair and the event that marks its last copy
    done."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.x = torch.empty(x.shape, dtype=_torch_dtype(x), pin_memory=True)
        self.y = torch.empty(y.shape, dtype=_torch_dtype(y), pin_memory=True)
        self.done = None

    def fits(self, x: np.ndarray, y: np.ndarray) -> bool:
        return (tuple(self.x.shape) == x.shape
                and self.x.dtype == _torch_dtype(x)
                and tuple(self.y.shape) == y.shape
                and self.y.dtype == _torch_dtype(y))


class DevicePrefetcher:
    """Overlap host-to-device copies with the card's compute.

    Wraps a host batch iterator of (x, y) numpy arrays and keeps `depth`
    batches' copies in flight: each batch is written into a pinned staging
    pair and copied with `non_blocking=True` on a side stream, whose event
    the consuming stream waits on before the batch is used. A staging pair
    is written again only after its previous copy's event has completed
    (writing it earlier would hand the step another batch's rows);
    `rewrites` counts the pairs so written again. On the CPU the batches
    pass through unchanged. With `sharding` (parallel/mesh.py
    `batch_sharding(mesh)`, the mesh over the ranks) `it` yields global
    batches and this rank's rows of each are staged onto its device.
    """

    def __init__(self, it: Iterable[Tuple[np.ndarray, np.ndarray]],
                 device=None, depth: int = 2, sharding=None):
        if sharding is not None:
            require_ranks(sharding.mesh)
            device = sharding.mesh.device
            it = ((x[sharding.rows(len(x))], y[sharding.rows(len(y))])
                  for x, y in it)
        elif device is None:
            raise ValueError("DevicePrefetcher needs a device or a sharding")
        self._it = iter(it)
        self.device = torch.device(device)
        self._depth = max(depth, 1)
        self._fifo: list = []
        self.rewrites = 0
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._slots: list = []  # depth + 1 pairs, used in turn
            self._next = 0

    def _put(self, xy):
        if self.device.type != "cuda":
            return xy
        x, y = (np.asarray(a) for a in xy)
        i = self._next
        self._next = (i + 1) % (self._depth + 1)
        if i == len(self._slots):
            self._slots.append(_Slot(x, y))
        slot = self._slots[i]
        if slot.done is not None:
            slot.done.synchronize()  # its last copy has read it
            self.rewrites += 1
        if not slot.fits(x, y):
            slot = self._slots[i] = _Slot(x, y)
        np.copyto(slot.x.numpy(), x)
        np.copyto(slot.y.numpy(), y)
        with torch.cuda.stream(self._stream):
            dx = slot.x.to(self.device, non_blocking=True)
            dy = slot.y.to(self.device, non_blocking=True)
            slot.done = torch.cuda.Event()
            slot.done.record(self._stream)
        return dx, dy, slot.done

    def _take(self, item):
        if self.device.type != "cuda":
            return item
        dx, dy, done = item
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        # allocated on the side stream, used on the consumer's
        dx.record_stream(consumer)
        dy.record_stream(consumer)
        return dx, dy

    def __iter__(self) -> Iterator[Tuple]:
        for xy in self._it:
            self._fifo.append(self._put(xy))
            if len(self._fifo) >= self._depth:
                break
        while self._fifo:
            out = self._fifo.pop(0)
            nxt = next(self._it, None)
            if nxt is not None:
                self._fifo.append(self._put(nxt))
            yield self._take(out)
