"""Multi-task serving: batched task-conditioned inference from one state.

The counterpart of `cpg_tpu.serve` (`TaskServer`, `DynamicBatcher`): one
frozen backbone answers requests for many tasks.

  * per-task effective weights are selected once (the masks are frozen after
    compaction) and cached on the card in the serving dtype;
  * a request batch pads up to the next power of two (>= `min_bucket`) by
    repeating its last row, so the shapes the card sees stay few;
  * mixed-task request lists are grouped by task and dispatched per group;
  * `quantize="int8"`: post-training quantization of the cached effective
    weights (per-output-channel symmetric scales, `_quantize_tree`),
    per-tensor activation scales (dynamic, or static after `calibrate`),
    and int8 x int8 -> int32 products on the card's integer tensor cores
    (ops/int8.py); eval only, and the fused chain is off under it;
  * `export`/`load` read and write the same artifact as `cpg_tpu`:
    `serving_meta.json` plus `taskNN.npz`, with bf16 arrays stored as uint16
    bit patterns listed under `bf16_keys`, and under int8 the int8 weights,
    their `scale/` entries and the calibrated `act/` scales. An artifact
    exported by either package loads in the other;
  * `DynamicBatcher` coalesces concurrent same-task requests into one
    `predict` call (the HTTP front end, server_http.py, uses it).

With `fused_chain=True` the eight BN+ReLU+conv3x3 seams of VGG16 run the fused
CUDA kernel (ops/fused_chain.py) on the bf16 path. `mesh` (parallel/mesh.py
`make_mesh(devices=...)`, devices of this process) serves data-parallel as
`cpg_tpu`'s does: one replica of a task's weights a device, the bucket
floor raised to the mesh size, each bucket split into equal shards run on
their devices by a thread each, the answers gathered in order. XLA's
`compiler_options` are refused.

Usage:
    server = TaskServer(state, preprocess_fn=cifar_eval_preprocess)
    logits = server.predict(task_id, x)                  # one task
    outs = server.predict_mixed([(tid, x), ...])         # router
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.state import CPGState, TaskEntry, resolve_device
from .models import framework as fw
from .models import check_token_ids, get_model
from .ops import int8
from .ops.masked import effective_params

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16"}


def _next_bucket(n: int, min_bucket: int, max_bucket: int) -> int:
    b = min_bucket
    while b < n and b < max_bucket:
        b *= 2
    return b


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 as its uint16 bit pattern (numpy has no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    a = np.require(a, requirements="C")  # keeps 0-d scales 0-d
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _mesh_floor(mesh, min_bucket: int) -> int:
    """The bucket floor over a mesh: at least its size, and a multiple of
    it, so every padded bucket splits into equal shards."""
    if mesh.group is not None:
        raise ValueError(f"{mesh}: a server runs in one process over its "
                         "own devices (make_mesh(devices=...))")
    n = mesh.size
    min_bucket = max(min_bucket, n)
    if min_bucket % n:
        raise ValueError(f"min_bucket {min_bucket} not divisible by mesh "
                         f"size {n}")
    return min_bucket


def _on(dev: torch.device):
    """Make `dev` the thread's current card, so the kernels launch there."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _refuse_unported(quantize, compiler_options):
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r}")
    if compiler_options is not None:
        raise NotImplementedError(
            "compiler_options steer XLA only; cpg_tpu_torch has no port")


def _quantize_tree(eff: Dict[str, torch.Tensor]):
    """Per-output-channel symmetric int8 of an effective-params tree: each
    kernel's scale is max(max|w|, 1e-8) / 127 over every axis but the last.
    Returns ({key: int8}, {key: f32 scale})."""
    q, scales = {}, {}
    for k, w in eff.items():
        sc = int8.scale_of(w.float().abs().amax(
            dim=tuple(range(w.dim() - 1))))
        q[k], scales[k] = int8.quantize(w, sc), sc
    return q, scales


class TaskServer:
    """Frozen-state, multi-task inference server on one device, or
    data-parallel over a mesh's devices."""

    def __init__(self, state: CPGState, preprocess_fn: Optional[Callable] = None,
                 compute_dtype=torch.bfloat16, min_bucket: int = 8,
                 max_bucket: int = 1024, quantize: Optional[str] = None,
                 cache: str = "precompute", max_cached: int = 4,
                 mesh=None, compiler_options=None, fused_chain: bool = False,
                 device="cuda"):
        """`quantize="int8"`: int8 weights with per-output-channel scales
        and per-tensor activation scales. Uncalibrated, an activation scale
        is the batch's own max |x|, so a request's logits can move by a
        quantization step with what shares its bucket; `calibrate()` fixes
        static scales and makes them batching-invariant.

        `cache`: "precompute" (default) selects every task's effective
        weights at load; "lru" keeps shared weights and masks resident once
        and selects a task's weights on its first request, evicting the
        least recently used beyond `max_cached`.

        `mesh`: data-parallel over its devices (see the module docstring);
        the state lives on its first device, which replaces `device`."""
        _refuse_unported(quantize, compiler_options)
        if cache not in ("precompute", "lru"):
            raise ValueError(f"unsupported cache={cache!r}")
        if mesh is not None:
            min_bucket = _mesh_floor(mesh, min_bucket)
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.state = state.to(self.device)
        self._setup(preprocess_fn, compute_dtype, min_bucket, max_bucket,
                    quantize, fused_chain, cache, max_cached, mesh)
        if cache == "precompute":
            for tid in self.state.tasks:
                self._materialize(tid)

    def _setup(self, preprocess_fn, compute_dtype, min_bucket, max_bucket,
               quantize, fused_chain, cache, max_cached, mesh):
        self.preprocess_fn = preprocess_fn
        self.compute_dtype = compute_dtype
        self.min_bucket, self.max_bucket = min_bucket, max_bucket
        self.quantize = quantize
        self.fused_chain = fused_chain
        self.cache, self.max_cached = cache, max_cached
        self.model_fn, in_shape = get_model(self.state.arch)
        self.in_shape = tuple(self.state.in_shape or in_shape)
        # concurrent callers race on the effective-weight cache
        self._cache_lock = threading.Lock()
        self._eff: Dict[int, Dict[str, torch.Tensor]] = {}
        self._scales: Dict[int, Optional[Dict[str, torch.Tensor]]] = {}
        self._act_scales: Dict[int, Optional[Dict[str, torch.Tensor]]] = {}
        self._lru: List[int] = []  # task access order, most recent last
        self.mesh = mesh
        # (task, device) -> (the cached tensors copied, their copies there)
        self._copies: Dict[Tuple[int, str], Tuple] = {}
        self._pool = (ThreadPoolExecutor(mesh.size, "mesh-shard")
                      if mesh is not None and mesh.size > 1 else None)

    def _materialize(self, tid: int) -> None:
        """Select (under int8: in f32, then quantize) one task's effective
        weights into the cache."""
        task = self.state.tasks[tid]
        with torch.inference_mode():
            eff = effective_params(
                self.state.shared, self.state.ownership, task.piggymask, tid,
                self.state.threshold,
                compute_dtype=(torch.float32 if self.quantize
                               else self.compute_dtype),
                mask_mode=self.state.mask_mode)
            if self.quantize:
                self._eff[tid], self._scales[tid] = _quantize_tree(eff)
            else:
                self._eff[tid], self._scales[tid] = eff, None

    def _get_eff(self, tid: int):
        """Cache lookup honouring the eviction policy (thread-safe). Returns
        (eff, quant_scales) as one pair: an eviction between two lookups
        cannot split a task's int8 weights from their scales."""
        with self._cache_lock:
            if tid not in self._eff:
                if tid not in self.state.tasks:
                    raise KeyError(f"unknown task {tid}")
                self._materialize(tid)
            if self.cache == "lru":
                if tid in self._lru:
                    self._lru.remove(tid)
                self._lru.append(tid)
                while len(self._lru) > self.max_cached:
                    ev = self._lru.pop(0)
                    self._eff.pop(ev, None)
                    self._scales.pop(ev, None)
                    for key in [k for k in self._copies if k[0] == ev]:
                        del self._copies[key]
            return self._eff[tid], self._scales.get(tid)

    def _replica(self, tid: int, dev: torch.device, eff, scales):
        """(eff, scales, activation scales, task) of a task on `dev`: the
        cached tensors on the server's device, copies of them elsewhere
        (made once, and again after an eviction or a calibration)."""
        task, acts = self.state.tasks[tid], self._act_scales.get(tid)
        if dev == self.device:
            return eff, scales, acts, task
        with self._cache_lock:
            src, rep = self._copies.get((tid, str(dev)), (None, None))
            if src is None or src[0] is not eff or src[1] is not acts:
                def mv(tree):
                    return (None if tree is None
                            else {k: v.to(dev) for k, v in tree.items()})

                rep = (mv(eff), mv(scales), mv(acts), TaskEntry(
                    name=task.name, num_classes=task.num_classes,
                    piggymask=None, private=mv(task.private),
                    bn_state=mv(task.bn_state), meta=task.meta))
                self._copies[(tid, str(dev))] = ((eff, acts), rep)
            return rep

    def _forward_on(self, dev: torch.device, tid: int, eff, scales,
                    x: np.ndarray) -> np.ndarray:
        """f32 logits of the rows `x` on `dev` (any thread)."""
        eff, scales, acts, task = self._replica(tid, dev, eff, scales)
        with torch.inference_mode(), _on(dev):
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            y = self._forward(tid, eff, scales, acts, xt, task=task)
            return y.float().cpu().numpy()

    def _bucket(self, tid: int, eff, scales, x: np.ndarray) -> np.ndarray:
        """Logits of one padded bucket: on the server's device, or in equal
        shards over the mesh's devices, gathered in order."""
        if self._pool is None:
            return self._forward_on(self.device, tid, eff, scales, x)
        futs = [self._pool.submit(self._forward_on, dev, tid, eff, scales,
                                  shard)
                for dev, shard in zip(self.mesh.devices.flat,
                                      np.split(x, self.mesh.size))]
        return np.concatenate([f.result() for f in futs])

    def _forward(self, tid: int, eff, scales, act_scales, x: torch.Tensor,
                 act_stats=None, task=None) -> torch.Tensor:
        task = task or self.state.tasks[tid]
        xx = self.preprocess_fn(x) if self.preprocess_fn is not None else x
        logits, _ = fw.apply(self.model_fn, eff, task.private, task.bn_state,
                             xx, train=False, compute_dtype=self.compute_dtype,
                             num_classes=task.num_classes,
                             mult=self.state.width_mult,
                             fused_chain=self.fused_chain,
                             quant_scales=scales,
                             act_scales=act_scales,
                             act_stats=act_stats,
                             **self.state.forward_kwargs(tid))
        return logits[0] if isinstance(logits, tuple) else logits

    def calibrate(self, calib, margin: float = 1.0) -> Dict[int, Dict]:
        """Fix static per-layer activation scales from a calibration set:
        each layer's max observed scale times `margin`. Identical inputs
        then give identical int8 logits whatever shares their bucket; the
        scales ride in the exported artifact. `calib`: {task_id: uint8
        batch}, or one batch for every task. Returns the scales per task."""
        if self.quantize != "int8":
            raise ValueError("calibrate() applies to quantize='int8' servers")
        tasks = (calib if isinstance(calib, dict)
                 else {tid: calib for tid in self.state.tasks})
        for tid, x in tasks.items():
            check_token_ids(self.state.arch, self.state.forward_kwargs(tid),
                            x)
            eff, scales = self._get_eff(tid)
            stats: Dict[str, float] = {}
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            with torch.inference_mode():  # dynamic scales, observed
                self._forward(tid, eff, scales, None, xt, act_stats=stats)
            self._act_scales[tid] = {
                k: torch.tensor(v * margin, dtype=torch.float32,
                                device=self.device)
                for k, v in stats.items()}
        return {tid: self._act_scales[tid] for tid in tasks}

    def predict(self, task_id: int, x) -> np.ndarray:
        """Logits for a request batch under one task's view (host in/out)."""
        eff, scales = self._get_eff(task_id)
        x = np.asarray(x)
        check_token_ids(self.state.arch, self.state.forward_kwargs(task_id),
                        x)
        n = len(x)
        b = _next_bucket(n, self.min_bucket, self.max_bucket)
        out: List[np.ndarray] = []
        for s in range(0, n, b):
            chunk = x[s:s + b]
            rows = len(chunk)
            if rows < b:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - rows, 0)])
            out.append(self._bucket(task_id, eff, scales, chunk)[:rows])
        return np.concatenate(out)

    def predict_mixed(self, requests: Sequence[Tuple[int, np.ndarray]]
                      ) -> List[np.ndarray]:
        """Route a mixed-task request list: group by task, batch each group,
        scatter results back in request order."""
        by_task: Dict[int, List[int]] = {}
        for i, (tid, _) in enumerate(requests):
            by_task.setdefault(tid, []).append(i)
        results: List[Optional[np.ndarray]] = [None] * len(requests)
        for tid, idxs in by_task.items():
            ys = self.predict(tid, np.stack([np.asarray(requests[i][1])
                                             for i in idxs]))
            for j, i in enumerate(idxs):
                results[i] = ys[j]
        return results  # type: ignore[return-value]

    def warmup(self, batch: Optional[int] = None) -> None:
        """Run every task's forward once at one bucket size before traffic
        (builds the CUDA kernels on first use)."""
        x = np.zeros((batch or self.min_bucket, *self.in_shape), np.uint8)
        for tid in self.state.tasks:
            self.predict(tid, x)

    def close(self) -> None:
        """Stop the mesh's shard threads (nothing to stop without one)."""
        if self._pool is not None:
            self._pool.shutdown()

    # -- deployment artifact -------------------------------------------------
    def export(self, path: str) -> str:
        """Write the serving artifact: per-task effective weights (int8 and
        their scales when quantized, plus calibrated activation scales),
        private and BN collections, metadata. No piggymasks, no
        ownership."""
        os.makedirs(path, exist_ok=True)
        meta = {"arch": self.state.arch, "width_mult": self.state.width_mult,
                "in_shape": list(self.in_shape), "quantize": self.quantize,
                "compute_dtype": _DTYPE_NAMES[self.compute_dtype],
                "tasks": {}}
        for tid, task in self.state.tasks.items():
            eff, scales = self._get_eff(tid)  # lru: selected on demand
            tensors = {f"eff/{k}": v for k, v in eff.items()}
            tensors.update({f"scale/{k}": v for k, v in (scales or {}).items()})
            tensors.update({f"act/{k}": v for k, v in
                            (self._act_scales.get(tid) or {}).items()})
            tensors.update({f"private/{k}": v for k, v in task.private.items()})
            tensors.update({f"bn/{k}": v for k, v in task.bn_state.items()})
            bf16_keys = [k for k, v in tensors.items()
                         if v.dtype == torch.bfloat16]
            np.savez(os.path.join(path, f"task{tid:02d}.npz"),
                     **{k: _to_numpy(v) for k, v in tensors.items()})
            meta["tasks"][str(tid)] = {
                "name": task.name, "num_classes": task.num_classes,
                "model_kwargs": self.state.forward_kwargs(tid),
                "bf16_keys": bf16_keys,
            }
        with open(os.path.join(path, "serving_meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str, preprocess_fn: Optional[Callable] = None,
             min_bucket: int = 8, max_bucket: int = 1024, mesh=None,
             compiler_options=None, fused_chain: bool = False,
             device="cuda") -> "TaskServer":
        """Reconstruct a server from an `export()` artifact (either
        package's), on `device`, or data-parallel over `mesh`."""
        with open(os.path.join(path, "serving_meta.json")) as f:
            meta = json.load(f)
        _refuse_unported(meta.get("quantize"), compiler_options)
        if mesh is not None:
            min_bucket = _mesh_floor(mesh, min_bucket)
            device = mesh.devices.flat[0]
        dev = resolve_device(device)
        srv = cls.__new__(cls)
        srv.device = dev
        tasks, effs, scales, acts = {}, {}, {}, {}
        for tid_s, tm in meta["tasks"].items():
            tid = int(tid_s)
            with np.load(os.path.join(path, f"task{tid:02d}.npz")) as z:
                bf16 = set(tm.get("bf16_keys") or ())

                def pick(pre):
                    return {k[len(pre):]: _from_numpy(z[k], k in bf16, dev)
                            for k in z.files if k.startswith(pre)}

                effs[tid] = pick("eff/")
                scales[tid] = pick("scale/") or None
                acts[tid] = pick("act/") or None
                tasks[tid] = TaskEntry(
                    name=tm["name"], num_classes=tm["num_classes"],
                    piggymask=None, private=pick("private/"),
                    bn_state=pick("bn/"),
                    meta={"model_kwargs": tm["model_kwargs"] or None})
        srv.state = CPGState(
            arch=meta["arch"], width_mult=meta["width_mult"], shared={},
            ownership={}, tasks=tasks,
            in_shape=tuple(meta["in_shape"]) if meta.get("in_shape") else None)
        dtype = {v: k for k, v in _DTYPE_NAMES.items()}[meta["compute_dtype"]]
        srv._setup(preprocess_fn, dtype, min_bucket, max_bucket,
                   meta.get("quantize"), fused_chain, "precompute", 0, mesh)
        srv._eff, srv._scales, srv._act_scales = effs, scales, acts
        return srv


class DynamicBatcher:
    """Coalesce concurrent same-task requests into one `predict` call.

    Per task, a worker thread drains a queue: the first request opens a
    window of `max_delay_ms`; everything arriving before it closes (up to
    `max_batch` rows) runs as ONE TaskServer.predict call, and the rows go
    back to their callers' futures. An error reaches every caller of that
    call. Results equal unbatched predict for bf16/f32 and calibrated int8
    servers (uncalibrated int8 scales with its batch).

    Usage:
        batcher = DynamicBatcher(server, max_delay_ms=3)
        logits = batcher.predict(task_id, x)     # thread-safe, blocking
        batcher.close()
    """

    def __init__(self, server: TaskServer, max_delay_ms: float = 3.0,
                 max_batch: Optional[int] = None):
        self.server = server
        self.max_delay = max_delay_ms / 1e3
        self.max_batch = max_batch or server.max_bucket
        self._queues: Dict[int, queue.Queue] = {}
        self._threads: Dict[int, threading.Thread] = {}
        self._lock = threading.Lock()
        self._stop = False

    def _queue_for(self, tid: int) -> queue.Queue:
        with self._lock:
            q = self._queues.get(tid)
            if q is None:
                if tid not in self.server.state.tasks:
                    raise KeyError(f"unknown task {tid}")
                q = self._queues[tid] = queue.Queue()
                t = threading.Thread(target=self._worker, args=(tid, q),
                                     daemon=True)
                t.start()
                self._threads[tid] = t
            return q

    def _worker(self, tid: int, q: queue.Queue) -> None:
        while not self._stop:
            try:
                first = q.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:  # shutdown sentinel
                return
            batch = [first]
            rows = len(first[0])
            deadline = time.monotonic() + self.max_delay
            while rows < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    self._stop = True
                    break
                batch.append(item)
                rows += len(item[0])
            try:
                ys = self.server.predict(
                    tid, np.concatenate([x for x, _ in batch]))
                s = 0
                for x, fut in batch:
                    fut.set_result(ys[s:s + len(x)])
                    s += len(x)
            except Exception as e:  # every waiting caller gets the error
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def submit(self, task_id: int, x) -> Future:
        """Enqueue a request batch (or one example); returns a Future of
        the logits (N, C)."""
        x = np.asarray(x)
        if x.ndim == len(self.server.in_shape):
            x = x[None]
        fut: Future = Future()
        self._queue_for(task_id).put((x, fut))
        return fut

    def predict(self, task_id: int, x) -> np.ndarray:
        return self.submit(task_id, x).result()

    def close(self) -> None:
        self._stop = True
        with self._lock:
            for q in self._queues.values():
                q.put(None)
