"""MetricsLogger — append-only JSONL sink for long-running fit/serve.
Copy of ``repro/obs/logger.py`` (numpy and the standard library), so the
port imports nothing of the JAX package.

One JSON object per line, each stamped with a wall-clock ``ts`` (unix
seconds) and an optional monotonically increasing ``step``. Rows are either
free-form records (``log``) or whole registry snapshots
(``log_snapshot``) — the longitudinal counterpart of the live
``/metrics`` exposition (docs/observability.md).

Values that arrive as numpy scalars, tensors (on any device) or small
arrays are converted to plain Python so every row is json-serializable
without the caller thinking about it.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from repro_torch.obs.qlog import host

__all__ = ["MetricsLogger"]


def _jsonable(v):
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    v = host(v)
    if np.ndim(v) == 0:
        f = float(v)
        return int(f) if f.is_integer() and abs(f) < 2 ** 53 else f
    return _jsonable(v.tolist())


class MetricsLogger:
    """Thread-safe JSONL writer. ``flush_every=1`` (default) flushes after
    every row so a crashed fit still leaves its trajectory on disk."""

    def __init__(self, path: str, flush_every: int = 1):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._flush_every = max(1, int(flush_every))
        self._since_flush = 0

    def log(self, record: dict, step: int | None = None) -> None:
        row = {"ts": time.time()}
        if step is not None:
            row["step"] = int(step)
        row.update(_jsonable(record))
        line = json.dumps(row)
        with self._lock:
            if self._fh.closed:
                raise ValueError("MetricsLogger is closed")
            self._fh.write(line + "\n")
            self._since_flush += 1
            if self._since_flush >= self._flush_every:
                self._fh.flush()
                self._since_flush = 0

    def log_snapshot(self, registry, step: int | None = None) -> None:
        self.log({"snapshot": registry.snapshot()}, step=step)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
