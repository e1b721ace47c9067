"""QueryLog — sampled serve-time (query, result-ids) stream for online refit.
Copy of ``repro/obs/qlog.py`` (numpy only): the same sampling draws from
the same seed. Batches may arrive as tensors on any device; each is brought
to the host once, at the boundary (:func:`host`).

IRLI improves partitions by iterating on query→item relevance (paper §3);
LIRA (PAPERS.md) shows the signal worth iterating on is the LIVE query
distribution, not the offline train split. The server can't afford to keep
every query, so this is a sampled ring buffer: ``record`` keeps each batch
row with probability ``sample`` and overwrites the oldest entries once
``capacity`` is reached, so a drain always sees the most recent traffic.
The logged label ids are the ids the index itself returned — serve-time
self-relevance, exactly the affinity stream the OnlineRefitLoop
(repro_torch.online.refit) trains its incremental ``fit_round``s on.

Each entry also carries the artifact ``epoch`` the ids were served against
and the serve latency of its batch, so the shadow auditor (obs.quality)
can attribute audited recall to artifact versions across install swaps and
judge served latency from the SAME sampled stream. ``drain`` returns a
:class:`DrainedLog`; it still unpacks as ``x, ids = qlog.drain()`` for the
refit loop's windowed read, and drained windows concatenate via
:meth:`DrainedLog.merge` (shards, audit accumulation).

Numpy-only and lock-per-call like the rest of ``repro_torch.obs`` (this package
is a LEAF: no repro_torch.core imports); buffers are allocated lazily on the
first ``record`` so the log adapts to whatever (d, k) the server runs.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

__all__ = ["DrainedLog", "QueryLog", "host"]


def host(x, dtype=None) -> np.ndarray:
    """A numpy array of ``x``: a tensor (on any device) comes to the host
    in one copy, anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


@dataclasses.dataclass(frozen=True)
class DrainedLog:
    """One drained traffic window: row i of every field describes the same
    served query. Unpacks as the legacy ``(x, ids)`` pair — ``epoch`` and
    ``latency`` ride along by name."""
    x: np.ndarray        # [m, d] fp32 query vectors
    ids: np.ndarray      # [m, k] int32 served ids (-1 pad)
    epoch: np.ndarray    # [m] int64 artifact version served against
    latency: np.ndarray  # [m] fp32 serve seconds (nan = not recorded)

    def __len__(self) -> int:
        return int(self.x.shape[0])

    def __iter__(self):
        # back-compat: ``x, ids = qlog.drain()`` (repro_torch.online.refit)
        return iter((self.x, self.ids))

    def __getitem__(self, i):
        return (self.x, self.ids)[i]

    def merge(self, other: "DrainedLog") -> "DrainedLog":
        """Concatenate two drained windows row-wise (self's rows first).
        Empty windows merge with anything; otherwise d and k must match."""
        if len(self) == 0:
            return other
        if len(other) == 0:
            return self
        if self.x.shape[1] != other.x.shape[1] or \
                self.ids.shape[1] != other.ids.shape[1]:
            raise ValueError(
                f"cannot merge windows with d={self.x.shape[1]} "
                f"k={self.ids.shape[1]} and d={other.x.shape[1]} "
                f"k={other.ids.shape[1]}")
        return DrainedLog(
            x=np.concatenate([self.x, other.x]),
            ids=np.concatenate([self.ids, other.ids]),
            epoch=np.concatenate([self.epoch, other.epoch]),
            latency=np.concatenate([self.latency, other.latency]))


def _empty_window(d: int, k: int) -> DrainedLog:
    return DrainedLog(x=np.zeros((0, d), np.float32),
                      ids=np.zeros((0, k), np.int32),
                      epoch=np.zeros((0,), np.int64),
                      latency=np.zeros((0,), np.float32))


class QueryLog:
    """Thread-safe sampled ring buffer of (query vector, result ids,
    serve epoch, serve latency).

    capacity  max retained samples (oldest overwritten first)
    sample    per-row keep probability in [0, 1] (0 disables retention
              but keeps the traffic counters)
    seed      sampling rng seed (deterministic logs for tests/benches)
    registry  optional MetricRegistry: records qlog_logged_total /
              qlog_seen_total counters and a qlog_fill gauge
    """

    def __init__(self, capacity: int = 4096, sample: float = 1.0,
                 seed: int = 0, registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.capacity = int(capacity)
        self.sample = float(sample)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._x = None          # [capacity, d] fp32, lazy
        self._ids = None        # [capacity, k] int32, lazy
        self._epoch = None      # [capacity] int64, lazy
        self._lat = None        # [capacity] fp32 seconds, lazy
        self._pos = 0           # next write slot (mod capacity)
        self._n = 0             # valid rows, <= capacity
        self._total = 0         # all rows ever logged (post-sampling)
        self._reg = registry

    def __len__(self) -> int:
        with self._lock:
            return self._n

    @property
    def total_logged(self) -> int:
        with self._lock:
            return self._total

    def record(self, queries, ids, *, epoch: int = 0,
               latencies=None) -> int:
        """Log a served batch: queries [n, d] with their returned ids
        [n, k] (pad -1 allowed — the refit loop masks them), the artifact
        ``epoch`` they were served against, and ``latencies`` — a scalar
        (the batch's serve seconds, shared by every row) or a per-row [n]
        array; None records nan ("not measured"). Returns the number of
        rows kept after sampling."""
        q = host(queries, np.float32)
        lab = host(ids, np.int32)
        n_seen = q.shape[0]
        if q.ndim != 2 or lab.ndim != 2 or q.shape[0] != lab.shape[0]:
            raise ValueError(
                f"expected queries [n, d] and ids [n, k] with matching n, "
                f"got {q.shape} and {lab.shape}")
        lat = np.broadcast_to(
            host(np.nan if latencies is None else latencies,
                 np.float32), (q.shape[0],))
        ep = np.full((q.shape[0],), int(epoch), np.int64)
        with self._lock:
            if self.sample < 1.0:
                keep = self._rng.random(q.shape[0]) < self.sample
                q, lab, ep, lat = q[keep], lab[keep], ep[keep], lat[keep]
            n = q.shape[0]
            if self._reg is not None:
                self._reg.counter("qlog_seen_total").inc(float(n_seen))
                self._reg.counter("qlog_logged_total").inc(float(n))
            if n == 0:
                return 0
            if self._x is None:
                self._x = np.zeros((self.capacity, q.shape[1]), np.float32)
                self._ids = np.zeros((self.capacity, lab.shape[1]), np.int32)
                self._epoch = np.zeros((self.capacity,), np.int64)
                self._lat = np.full((self.capacity,), np.nan, np.float32)
            if q.shape[1] != self._x.shape[1] or \
                    lab.shape[1] != self._ids.shape[1]:
                raise ValueError(
                    f"shape drift: log holds d={self._x.shape[1]} "
                    f"k={self._ids.shape[1]}, got d={q.shape[1]} "
                    f"k={lab.shape[1]}")
            if n >= self.capacity:          # batch alone fills the ring
                self._x[:] = q[-self.capacity:]
                self._ids[:] = lab[-self.capacity:]
                self._epoch[:] = ep[-self.capacity:]
                self._lat[:] = lat[-self.capacity:]
                self._pos, self._n = 0, self.capacity
            else:
                idx = (self._pos + np.arange(n)) % self.capacity
                self._x[idx] = q
                self._ids[idx] = lab
                self._epoch[idx] = ep
                self._lat[idx] = lat
                self._pos = int((self._pos + n) % self.capacity)
                self._n = min(self.capacity, self._n + n)
            self._total += n
            if self._reg is not None:
                self._reg.gauge("qlog_fill").set(self._n / self.capacity)
            return n

    def drain(self) -> DrainedLog:
        """Atomically take every logged sample as a :class:`DrainedLog`
        (copies) and empty the log — the refit loop's windowed read, which
        still unpacks it as ``x, ids``. Empty log -> zero-row arrays
        ((0, 0)-shaped before the first record fixed d and k)."""
        with self._lock:
            if self._n == 0 or self._x is None:
                d = 0 if self._x is None else self._x.shape[1]
                k = 0 if self._ids is None else self._ids.shape[1]
                return _empty_window(d, k)
            out = DrainedLog(x=self._x[:self._n].copy(),
                             ids=self._ids[:self._n].copy(),
                             epoch=self._epoch[:self._n].copy(),
                             latency=self._lat[:self._n].copy())
            self._pos, self._n = 0, 0
            if self._reg is not None:
                self._reg.gauge("qlog_fill").set(0.0)
            return out
