"""Profiling: a trace around a region and a step timer with a readback
barrier (the counterpart of `cpg_tpu.utils.profiling`).

`trace(logdir)` runs `torch.profiler` over a region, with the CUDA
activity when a card is there, and writes a Chrome/Perfetto trace. Kernel
launches are asynchronous, so `StepTimer.stop` takes a tensor from the end
of the step chain and reads it back to the host: the time then covers the
work of every step, not only its launches.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region: `with trace('build/trace') as prof: run()` writes
    `<logdir>/trace.json` (open it in Perfetto or chrome://tracing); `prof`
    is the live `torch.profiler.profile` (e.g. for `key_averages()`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Phase step-time meter with an explicit readback barrier.

    usage:
        t = StepTimer()
        t.start()
        for ...: out = step(...)
        t.stop(barrier=metrics["loss"])  # a tensor that ends the chain
        t.images_per_sec(n_steps * batch)
    """

    def __init__(self):
        self._t0: Optional[float] = None
        self.seconds = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, barrier):
        # a one-element tensor's host readback (`.item()`) waits for every
        # launch queued before it
        float(barrier)
        self.seconds = time.perf_counter() - self._t0
        return self.seconds

    def images_per_sec(self, n_images: int) -> float:
        return n_images / max(self.seconds, 1e-9)
