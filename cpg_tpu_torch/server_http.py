"""HTTP JSON inference endpoint over a TaskServer.

The counterpart of `cpg_tpu.server_http`: stdlib only (`http.server`),
threaded, so concurrent clients queue into the card; per-task bucketed
batching happens inside TaskServer, and with a batch window a
`DynamicBatcher` merges concurrent same-task requests first.

Endpoints (JSON):
  GET  /v1/tasks            -> {task_id: {name, num_classes}}
  GET  /v1/stats            -> request/image counters, per-task, latency
  POST /v1/predict          -> {"task_id": t, "inputs": [...]} where inputs is
                               a nested list: one example of the model's
                               in_shape or a batch (N, *in_shape); ints stay
                               integral (uint8 images / int32 token ids),
                               floats become float32
                               -> {"logits": [[...]], "top1": [...]}
  POST /v1/predict_mixed    -> {"requests": [{"task_id": t, "input": [...]},
                               ...]}: ONE example per entry, routed per
                               task, answers in order

Usage:
    srv = TaskServer.load("artifact/", preprocess_fn=...)
    httpd = serve_http(srv, port=8000)        # returns after bind; threaded
    ...
    httpd.shutdown()

or: `python -m cpg_tpu_torch serve --artifact art/ --http-port 8000`.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np

from .serve import DynamicBatcher, TaskServer


def _as_batch(obj, in_shape) -> np.ndarray:
    """Accept one example (in_shape) or a batch (N, *in_shape).

    The dtype follows the task's input shape, never the payload's values:
    float payloads (normalized pixels, pre-processed features) become
    float32; integer payloads become int32 for 1-D inputs (token ids: a
    vocabulary can exceed 255) and uint8 for image-shaped inputs, where a
    pixel outside [0, 255] is a client error."""
    x = np.asarray(obj)
    if x.dtype == object:
        raise ValueError("ragged or non-numeric input")
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    elif len(in_shape) == 1:
        x = x.astype(np.int32)  # token ids
    else:
        if x.size and not (0 <= int(x.min()) and int(x.max()) <= 255):
            raise ValueError(
                f"integer pixels out of uint8 range "
                f"[{int(x.min())}, {int(x.max())}] for image input "
                f"{tuple(in_shape)}; send floats for pre-processed inputs")
        x = x.astype(np.uint8)
    if x.shape == tuple(in_shape):
        x = x[None]
    if x.ndim != len(in_shape) + 1 or x.shape[1:] != tuple(in_shape):
        raise ValueError(f"input shape {x.shape} != (N, {in_shape})")
    return x


class _Handler(BaseHTTPRequestHandler):
    server: "_Httpd"

    def _reply(self, code: int, payload: Dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet; the stats endpoint replaces logs
        pass

    def do_GET(self):
        ts = self.server.task_server
        if self.path == "/v1/tasks":
            self._reply(200, {str(tid): {"name": t.name,
                                         "num_classes": t.num_classes}
                              for tid, t in ts.state.tasks.items()})
        elif self.path == "/v1/stats":
            with self.server.lock:
                self._reply(200, dict(self.server.stats))
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        ts = self.server.task_server
        t0 = time.perf_counter()
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            if self.path == "/v1/predict":
                tid = int(req["task_id"])
                x = _as_batch(req["inputs"], ts.in_shape)
                front = self.server.batcher or ts
                y = front.predict(tid, x)
                out = {"logits": y.tolist(),
                       "top1": np.argmax(y, -1).tolist()}
                self._count([tid] * len(x), time.perf_counter() - t0)
            elif self.path == "/v1/predict_mixed":
                reqs = []
                for r in req["requests"]:
                    xb = _as_batch(r["input"], ts.in_shape)
                    if len(xb) != 1:
                        raise ValueError(
                            "predict_mixed 'input' must be ONE example of "
                            f"shape {tuple(ts.in_shape)}, got a batch of "
                            f"{len(xb)} — use /v1/predict for batches")
                    reqs.append((int(r["task_id"]), xb[0]))
                ys = ts.predict_mixed(reqs)
                out = {"results": [{"logits": y.tolist(),
                                    "top1": int(np.argmax(y))}
                                   for y in ys]}
                self._count([tid for tid, _ in reqs],
                            time.perf_counter() - t0)
            else:
                return self._reply(404, {"error": f"unknown path {self.path}"})
            self._reply(200, out)
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    def _count(self, tids, secs: float = 0.0):
        """One HTTP request served `tids` images (one task id per image) in
        `secs` — requests/latency count once per request, images per item."""
        with self.server.lock:
            s = self.server.stats
            s["requests"] = s.get("requests", 0) + 1
            s["images"] = s.get("images", 0) + len(tids)
            per = s.setdefault("per_task", {})
            for tid in tids:
                per[str(tid)] = per.get(str(tid), 0) + 1
            ms = secs * 1e3
            lat = s.setdefault("latency_ms", {"count": 0, "avg": 0.0,
                                              "max": 0.0})
            lat["count"] += 1
            lat["avg"] += (ms - lat["avg"]) / lat["count"]
            lat["max"] = max(lat["max"], ms)


class _Httpd(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's 5 lets a burst of concurrent
    # clients overflow the accept queue, and the kernel then resets some
    # of their connections
    request_queue_size = 1024

    def __init__(self, addr, task_server: TaskServer, batcher=None):
        super().__init__(addr, _Handler)
        self.task_server = task_server
        self.batcher = batcher
        self.stats: Dict = {}
        self.lock = threading.Lock()

    def shutdown(self):
        """Stop serving and the DynamicBatcher's per-task worker threads
        (which would otherwise poll forever and keep the TaskServer's
        cached weights alive)."""
        super().shutdown()
        if self.batcher is not None:
            self.batcher.close()


def serve_http(task_server: TaskServer, port: int = 8000,
               host: str = "127.0.0.1", block: bool = False,
               batch_window_ms: float = 0.0) -> _Httpd:
    """Bind and serve. `block=False` (default) serves from a daemon thread and
    returns the server (call `.shutdown()` to stop); `block=True` serves in
    the calling thread until interrupted. `batch_window_ms > 0` coalesces
    concurrent /v1/predict requests for the same task into one device launch
    (serve.DynamicBatcher)."""
    batcher = None
    if batch_window_ms and batch_window_ms > 0:
        batcher = DynamicBatcher(task_server, max_delay_ms=batch_window_ms)
    httpd = _Httpd((host, port), task_server, batcher)
    if block:
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            if batcher is not None:
                batcher.close()
            httpd.server_close()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd
