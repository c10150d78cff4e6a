"""Utils: a running metric, logging, structured JSONL records (the
counterparts of `cpg_tpu.utils`; standard library only)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

LOGGER = "cpg_tpu_torch"


class Metric:
    """Running average."""

    def __init__(self, name: str = "metric"):
        self.name = name
        self.sum = 0.0
        self.n = 0

    def update(self, value, n: int = 1):
        self.sum += float(value) * n
        self.n += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.n, 1)


def set_logger(logfile: Optional[str] = None, level=logging.INFO):
    """Console (stderr) and optional file logging for the package logger."""
    log = logging.getLogger(LOGGER)
    log.setLevel(level)
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname).1s %(message)s",
                            "%H:%M:%S")
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(fmt)
    log.addHandler(h)
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        log.addHandler(fh)
    return log


class JsonlWriter:
    """Structured per-phase records, one JSON object a line (appended,
    line-buffered). A context manager: `with JsonlWriter(p) as w: ...`."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, **record):
        record.setdefault("ts", time.time())
        self._f.write(json.dumps(record) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
