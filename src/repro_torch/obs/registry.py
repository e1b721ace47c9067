"""MetricRegistry — the one metrics substrate the port records into.
Copy of ``repro/obs/registry.py`` (numpy only), so the port imports nothing
of the JAX package; the two keep the same names, kinds and snapshot layout.

Three scalar metric kinds (Prometheus semantics) plus a fixed-size vector
counter for per-bucket statistics:

  Counter        monotonically increasing float (requests, pad waste, ...)
  Gauge          last-write-wins float (epoch, delta occupancy, fit loss)
  Histogram      fixed LOG-SPACED buckets — observations land in the first
                 bucket whose upper bound is >= the value (``le`` semantics,
                 like Prometheus). Fixed bounds make two snapshots mergeable
                 by elementwise addition, which is what makes cross-process
                 aggregation (shards, bench subprocesses) associative.
  VectorCounter  a fixed-size count vector (e.g. probes per (rep, bucket))
                 whose snapshot carries the load-balance summary
                 (min/max/std/KL-vs-uniform) — the paper's §load balance
                 metric, observable at serve time — plus ``decay(factor)``
                 / ``reset()`` windowing so long-running servers track
                 recent traffic (docs/online.md).

Everything is thread-safe: the server micro-batcher, client threads, and
the fit loop may record into one registry concurrently. Reads
(``snapshot()``/``to_text()``) are consistent per metric, not across the
whole registry — fine for monitoring.

Snapshots are plain dicts (JSON-able; the MetricsLogger writes them
verbatim) and ``merge_snapshots`` combines two of them associatively
(property-tested in tests/test_obs.py).
"""
from __future__ import annotations

import bisect
import math
import threading

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "VectorCounter", "MetricRegistry",
    "log_buckets", "bucket_index", "merge_snapshots", "load_balance_stats",
    "LATENCY_BUCKETS", "COUNT_BUCKETS",
]


def log_buckets(lo: float = 1e-6, hi: float = 1e2,
                per_decade: int = 3) -> tuple:
    """Log-spaced ascending bucket upper bounds covering [lo, hi].

    ``per_decade`` bounds per factor of 10; the first bound is exactly
    ``lo`` and the last is >= ``hi``. An implicit +Inf overflow bucket is
    appended by Histogram itself.
    """
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    out = [lo * 10 ** (i / per_decade) for i in range(n)]
    if out[-1] < hi:
        out.append(hi)
    return tuple(out)


#: serve-path latencies: 1us .. 100s
LATENCY_BUCKETS = log_buckets(1e-6, 1e2, per_decade=3)
#: discrete count distributions (candidates per query, batch fill): 1 .. 1e6
COUNT_BUCKETS = log_buckets(1.0, 1e6, per_decade=4)


def bucket_index(bounds, v) -> int:
    """Index of the bucket ``v`` lands in: the first i with v <= bounds[i],
    or len(bounds) (the +Inf overflow bucket) when v exceeds every bound.
    A value exactly equal to a bound lands IN that bound's bucket."""
    return bisect.bisect_left(bounds, v)


class Counter:
    """Monotonic float counter. ``inc`` with a negative amount raises —
    that's a Gauge's job."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0: {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bound histogram: len(bounds)+1 counts (last = +Inf overflow),
    plus sum/count/min/max. Bounds are immutable after construction so any
    two snapshots of same-named histograms merge elementwise."""

    kind = "histogram"

    def __init__(self, bounds=LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly ascending")
        self._lock = threading.Lock()
        self._counts = np.zeros(len(self.bounds) + 1, np.int64)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        i = bucket_index(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    def observe_many(self, values) -> None:
        for v in np.asarray(values).ravel():
            self.observe(float(v))

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1) from the bucket counts,
        linearly interpolated inside the containing bucket. Observations in
        the +Inf overflow bucket report the recorded max. Used by the swap
        latency assertions (tests/test_online.py) so p99 claims come from
        the SAME histograms operators monitor, not a side channel."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = self._counts.copy()
            total, vmin, vmax = self._count, self._min, self._max
        if total == 0:
            return math.nan
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                frac = (target - cum) / c
                if i >= len(self.bounds):           # +Inf overflow bucket
                    return float(vmax)
                lo = self.bounds[i - 1] if i > 0 else min(vmin, self.bounds[0])
                hi = self.bounds[i]
                return float(lo + frac * (hi - lo))
            cum += c
        return float(vmax)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": "histogram",
                "bounds": list(self.bounds),
                "counts": self._counts.tolist(),
                "count": self._count,
                "sum": self._sum,
                "min": None if self._count == 0 else self._min,
                "max": None if self._count == 0 else self._max,
            }


class VectorCounter:
    """Fixed-size vector of counts (index -> count), for per-bucket
    statistics: probe frequency per (rep, bucket), per-bucket candidate
    contributions, ... Snapshot carries the load-balance summary
    (:func:`load_balance_stats`) and the raw counts while small.

    Counts are float64 (not int64) so :meth:`decay` — the exponential
    forgetting the online refit loop applies so it sees RECENT traffic, not
    all-time totals — commutes with :func:`merge_snapshots`: decay is an
    elementwise scale and merge is an elementwise add, so
    merge(decay(a), decay(b)) == decay(merge(a, b)) (property-tested in
    tests/test_obs.py). Increments are still whole numbers; only decayed
    tails are fractional."""

    kind = "vector"
    RAW_LIMIT = 65536       # snapshots include raw counts up to this size

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"vector size must be >= 1, got {size}")
        self._lock = threading.Lock()
        self._counts = np.zeros(int(size), np.float64)

    @property
    def size(self) -> int:
        return self._counts.shape[0]

    def add(self, counts) -> None:
        """Elementwise add a full-size count vector."""
        counts = np.asarray(counts)
        if counts.shape != self._counts.shape:
            raise ValueError(
                f"expected shape {self._counts.shape}, got {counts.shape}")
        with self._lock:
            self._counts += counts.astype(np.float64)

    def inc_at(self, indices) -> None:
        """Increment by 1 at each index (repeats accumulate)."""
        idx = np.asarray(indices).ravel()
        with self._lock:
            np.add.at(self._counts, idx, 1)

    def decay(self, factor: float) -> None:
        """Exponentially forget: counts *= factor (0 <= factor <= 1).

        Long-running servers call this on a window cadence so probe
        frequencies track the live query distribution instead of
        saturating; factor=0 is a hard reset."""
        factor = float(factor)
        if not 0.0 <= factor <= 1.0:
            raise ValueError(f"decay factor must be in [0, 1], got {factor}")
        with self._lock:
            self._counts *= factor

    def reset(self) -> np.ndarray:
        """Windowed read: return the current counts and zero the vector —
        one atomic step, so concurrent increments are never lost between
        the read and the clear."""
        with self._lock:
            out = self._counts.copy()
            self._counts[:] = 0.0
            return out

    @property
    def value(self) -> np.ndarray:
        with self._lock:
            return self._counts.copy()

    def snapshot(self) -> dict:
        v = self.value
        snap = {"type": "vector", "size": int(v.shape[0]),
                **load_balance_stats(v)}
        if v.shape[0] <= self.RAW_LIMIT:
            snap["counts"] = v.tolist()
        return snap


def load_balance_stats(counts) -> dict:
    """The paper's load-balance summary of one count vector: sum, min, max,
    std, and KL(p || uniform) where p is the normalized distribution —
    KL = sum p_i log(p_i B); 0 iff perfectly balanced, log(B) at worst
    (everything in one bucket)."""
    c = np.asarray(counts, np.float64).ravel()
    total = float(c.sum())
    out = {"sum": total, "min": float(c.min()), "max": float(c.max()),
           "std": float(c.std())}
    if total <= 0:
        out["kl_vs_uniform"] = 0.0
    else:
        p = c / total
        nz = p > 0
        out["kl_vs_uniform"] = float(
            np.sum(p[nz] * np.log(p[nz] * c.shape[0])))
    return out


# ----------------------------------------------------------------- registry --
def _labels_key(labels: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _full_name(name: str, lkey: tuple) -> str:
    if not lkey:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in lkey)
    return f"{name}{{{inner}}}"


class MetricRegistry:
    """Thread-safe name -> metric map with get-or-create accessors.

    Metrics are identified by (name, labels); re-requesting an existing
    metric returns the SAME object (type-checked), so call sites can stay
    stateless: ``registry.counter("serve_requests_total").inc(n)``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}

    def _get(self, name: str, labels, factory, kind):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested as {kind}")
            return m

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        return self._get(name, labels, Counter, "counter")

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        return self._get(name, labels, Gauge, "gauge")

    def histogram(self, name: str, labels: dict | None = None,
                  bounds=LATENCY_BUCKETS) -> Histogram:
        return self._get(name, labels, lambda: Histogram(bounds), "histogram")

    def vector(self, name: str, size: int,
               labels: dict | None = None) -> VectorCounter:
        return self._get(name, labels, lambda: VectorCounter(size), "vector")

    def get(self, name: str, labels: dict | None = None):
        """The existing metric at (name, labels), or None — a READ that
        never creates. Monitors (obs.quality.SLOMonitor) use this so
        polling a signal that nothing has recorded yet stays "no data"
        instead of materializing a zero-valued series."""
        with self._lock:
            return self._metrics.get((name, _labels_key(labels)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def names(self) -> list:
        with self._lock:
            return sorted({name for name, _ in self._metrics})

    def snapshot(self) -> dict:
        """One JSON-able dict: ``name{label="v"} -> metric snapshot``."""
        with self._lock:
            items = list(self._metrics.items())
        return {_full_name(name, lkey): m.snapshot()
                for (name, lkey), m in sorted(items)}

    def to_text(self) -> str:
        """Prometheus-style text exposition (docs/observability.md)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines, seen_type = [], set()
        for (name, lkey), m in items:
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {m.kind}")
            def labeled(suffix: str, extra: str = "") -> str:
                pairs = [f'{k}="{v}"' for k, v in lkey]
                if extra:
                    pairs.append(extra)
                return (f"{name}{suffix}{{{','.join(pairs)}}}" if pairs
                        else f"{name}{suffix}")

            if m.kind in ("counter", "gauge"):
                lines.append(f"{labeled('')} {m.value:g}")
            elif m.kind == "histogram":
                s = m.snapshot()
                cum = 0
                for bound, c in zip(list(s["bounds"]) + ["+Inf"],
                                    s["counts"]):
                    cum += c
                    le = bound if bound == "+Inf" else f"{bound:g}"
                    extra = 'le="%s"' % le
                    lines.append(f"{labeled('_bucket', extra)} {cum}")
                lines.append(f"{labeled('_sum')} {s['sum']:g}")
                lines.append(f"{labeled('_count')} {s['count']}")
                # derived p50/p95/p99 (summary-style quantile label):
                # interpolated from the SAME cumulative le-buckets above, so
                # a scraper's own histogram_quantile() and these lines can
                # only disagree by in-bucket interpolation
                if s["count"] > 0:
                    for q in (0.5, 0.95, 0.99):
                        extra = 'quantile="%g"' % q
                        lines.append(
                            f"{labeled('', extra)} {m.quantile(q):g}")
            else:   # vector: expose the summary, not B raw series
                s = m.snapshot()
                for stat in ("sum", "min", "max", "std", "kl_vs_uniform"):
                    extra = 'stat="%s"' % stat
                    lines.append(f"{labeled('', extra)} {s[stat]:g}")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------------- merges --
def _merge_one(a: dict, b: dict) -> dict:
    if a["type"] != b["type"]:
        raise ValueError(f"cannot merge {a['type']} with {b['type']}")
    t = a["type"]
    if t == "counter":
        return {"type": t, "value": a["value"] + b["value"]}
    if t == "gauge":                      # last-write-wins: right argument
        return {"type": t, "value": b["value"]}
    if t == "histogram":
        if a["bounds"] != b["bounds"]:
            raise ValueError("histogram bounds differ — not mergeable")
        lo = [x["min"] for x in (a, b) if x["min"] is not None]
        hi = [x["max"] for x in (a, b) if x["max"] is not None]
        return {
            "type": t, "bounds": list(a["bounds"]),
            "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
            "count": a["count"] + b["count"], "sum": a["sum"] + b["sum"],
            "min": min(lo) if lo else None, "max": max(hi) if hi else None,
        }
    if t == "vector":
        if a["size"] != b["size"]:
            raise ValueError("vector sizes differ — not mergeable")
        out = {"type": t, "size": a["size"]}
        if "counts" in a and "counts" in b:
            counts = [x + y for x, y in zip(a["counts"], b["counts"])]
            out["counts"] = counts
            out.update(load_balance_stats(counts))
        else:       # raw counts dropped (over RAW_LIMIT): only sum survives
            out.update({"sum": a["sum"] + b["sum"], "min": 0.0, "max": 0.0,
                        "std": 0.0, "kl_vs_uniform": 0.0})
        return out
    raise ValueError(f"unknown metric type {t!r}")


def merge_snapshots(a: dict, b: dict) -> dict:
    """Merge two ``MetricRegistry.snapshot()`` dicts. Associative (counters
    and histogram counts add; gauges take the right-most write; min/max
    combine), so shard-level snapshots can be tree-reduced in any grouping
    — property-tested in tests/test_obs.py."""
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge_one(a[k], v) if k in a else v
    return out
