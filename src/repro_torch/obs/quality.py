"""Live quality observability: shadow-audited recall, query-drift scoring,
and SLO health (docs/quality.md). Copy of ``repro/obs/quality.py`` (numpy
only): the same hyperplanes from the same seed, the same scores and state
machine. Tensors (on any device) are accepted wherever the reference takes
arrays and come to the host once, at the boundary.

The paper's claims are QUALITY claims — recall at a candidate budget under
balanced loads — but a serving stack natively observes only speed. This
module closes that gap with three cooperating pieces, all numpy-only (the
obs package is a LEAF: no repro_torch.core imports — anything index-shaped is
injected as a callable):

  ShadowAuditor   samples served (query, ids, epoch, latency) rows into its
                  own :class:`~repro_torch.obs.qlog.QueryLog` and re-executes them
                  against an injected EXACT oracle (full-probe search over
                  the fp32 exact tier — ``MutableIRLIIndex.exact_oracle``),
                  emitting ``quality_live_recall`` gauges labeled by
                  artifact version so every install swap gets before/after
                  quality attribution. The oracle runs HERE, off the hot
                  path, at sample rate — never inside the serve pipeline
                  (contract ``query.audit_oracle_off_hot_path``).
  QuerySketch /   a random-hyperplane bucket histogram of query vectors.
  DriftDetector   The fit-time reference histogram is frozen into the
                  IndexArtifact (meta ``sketch_planes``/``sketch_seed``
                  rebuild the planes deterministically); the live window is
                  scored against it with smoothed KL + chi-square into the
                  ``query_drift_score`` gauge.
  SLOSpec /       declarative thresholds (p99 latency, min live recall,
  SLOMonitor      max drift, max load-KL) evaluated on a cadence into an
                  ok/warn/critical state machine with hysteresis
                  (``trip_after`` consecutive breaches escalate,
                  ``clear_after`` consecutive clears recover), exposed as
                  ``slo_state{slo=...}`` gauges and the ``/healthz`` /
                  ``/statusz`` endpoints (obs.exposition).

The OnlineRefitLoop consumes these signals as refit triggers (``on_drift``
/ ``on_recall_alert``) and reports each cycle's effectiveness as the
audited recall delta across the version swap (docs/online.md).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.obs.qlog import QueryLog, host
from repro_torch.obs.registry import load_balance_stats

__all__ = [
    "RECALL_BUCKETS", "QuerySketch", "DriftDetector", "ShadowAuditor",
    "SLOSpec", "SLOMonitor", "recall_rows", "kl_divergence", "chi_square",
    "OK", "WARN", "CRITICAL", "STATE_NAMES", "uptime_source",
]

#: recall lives in [0, 1]: linear 0.05-wide buckets (log-spaced latency
#: buckets would waste resolution where recall regressions actually happen)
RECALL_BUCKETS = tuple(round(0.05 * i, 2) for i in range(1, 21))

OK, WARN, CRITICAL = 0, 1, 2
STATE_NAMES = ("ok", "warn", "critical")


def _registry(registry):
    from repro_torch.obs import get_registry   # lazy: obs/__init__ imports us
    return get_registry(registry)


# ---------------------------------------------------------------- recall --
def recall_rows(served, exact) -> np.ndarray:
    """Per-row recall of ``served`` [n, k] against exact ``exact`` [n, k']:
    fraction of each exact row found among the served ids. Pads (< 0) are
    ignored on both sides — a -1 the oracle emitted (fewer than k' live
    rows) shrinks the denominator instead of counting as a miss."""
    served = host(served)
    exact = host(exact)
    if served.ndim != 2 or exact.ndim != 2 or \
            served.shape[0] != exact.shape[0]:
        raise ValueError(
            f"expected served [n, k] and exact [n, k'] with matching n, "
            f"got {served.shape} and {exact.shape}")
    valid = exact >= 0
    found = (exact[:, :, None] == served[:, None, :]).any(-1) & valid
    return found.sum(1) / np.maximum(valid.sum(1), 1)


class ShadowAuditor:
    """Background recall auditor over a sampled slice of live traffic.

    oracle    callable ``queries [n, d] -> exact ids [n, k']`` — the
              full-probe ground truth (injected; obs stays a leaf package)
    searcher  optional callable ``queries -> served ids`` re-executing the
              SERVE path; the refit loop uses it to audit the same queries
              against old and new artifacts across a swap
    sample    fraction of observed rows retained for auditing
    capacity  audit ring size (oldest sampled rows overwritten first)

    ``observe`` is the hot-path hook (sampling + a ring write — no device
    work); ``run_audit`` drains the ring, runs the oracle once over the
    window, and publishes ``quality_*`` series with per-artifact-version
    attribution. ``start(interval_s)`` runs audits on a daemon cadence.
    """

    def __init__(self, oracle, *, sample: float = 0.05, capacity: int = 2048,
                 seed: int = 0, registry=None, searcher=None):
        self.oracle = oracle
        self.searcher = searcher
        self.log = QueryLog(capacity=capacity, sample=sample, seed=seed)
        self.registry = _registry(registry)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def observe(self, queries, ids, *, epoch: int = 0,
                latency_s=None) -> int:
        """Offer one served batch to the sampler. Returns rows retained."""
        kept = self.log.record(queries, ids, epoch=epoch,
                               latencies=latency_s)
        reg = self.registry
        reg.counter("quality_observed_total").inc(
            float(len(queries)))
        if kept:
            reg.counter("quality_sampled_total").inc(float(kept))
        return kept

    def recall_of(self, queries, served_ids) -> float:
        """One-shot audited recall of ``served_ids`` for ``queries`` (no
        sampling, no metric emission) — the refit loop's swap-delta probe."""
        exact = host(self.oracle(host(queries, np.float32)))
        return float(recall_rows(served_ids, exact).mean())

    def run_audit(self) -> dict | None:
        """Drain the sampled window, re-execute it against the oracle, and
        publish live recall (overall + per artifact version). Returns the
        audit summary, or None when nothing was sampled since last time."""
        w = self.log.drain()
        if len(w) == 0:
            return None
        exact = host(self.oracle(w.x))
        rows = recall_rows(w.ids, exact)
        reg = self.registry
        reg.histogram("quality_recall", bounds=RECALL_BUCKETS).observe_many(
            rows)
        lat = w.latency[np.isfinite(w.latency)]
        if lat.size:
            reg.histogram("quality_served_latency_seconds").observe_many(lat)
        by_version: dict = {}
        for v in np.unique(w.epoch):
            sel = w.epoch == v
            r = float(rows[sel].mean())
            by_version[int(v)] = r
            reg.gauge("quality_live_recall",
                      {"version": str(int(v))}).set(r)
            reg.counter("quality_audited_total",
                        {"version": str(int(v))}).inc(float(sel.sum()))
        overall = float(rows.mean())
        reg.gauge("quality_live_recall").set(overall)
        reg.counter("quality_audited_total").inc(float(len(w)))
        reg.counter("quality_audits_total").inc()
        return {"live_recall": overall, "n_audited": int(len(w)),
                "by_version": by_version}

    # ------------------------------------------------------- background --
    def start(self, interval_s: float = 5.0) -> None:
        """Run ``run_audit`` every ``interval_s`` s on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("ShadowAuditor already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.run_audit()
                except Exception:       # noqa: BLE001 — auditor must survive
                    self.registry.counter("quality_audit_errors_total").inc()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obs-shadow-auditor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None


# ----------------------------------------------------------------- drift --
class QuerySketch:
    """Random-hyperplane bucket sketch of a query distribution.

    ``n_planes`` seeded hyperplanes hash a query to a sign-bit bucket in
    [0, 2^n_planes); a distribution becomes a bucket histogram. Fully
    determined by (d, n_planes, seed), so an IndexArtifact only freezes the
    reference HISTOGRAM plus the two meta ints — any consumer rebuilds the
    identical planes."""

    def __init__(self, d: int, n_planes: int = 6, seed: int = 0):
        if not 1 <= int(n_planes) <= 24:
            raise ValueError(f"n_planes must be in [1, 24], got {n_planes}")
        self.d, self.n_planes, self.seed = int(d), int(n_planes), int(seed)
        rng = np.random.default_rng(self.seed)
        self._planes = rng.standard_normal(
            (self.d, self.n_planes)).astype(np.float32)
        self._weights = (1 << np.arange(self.n_planes)).astype(np.int64)

    @property
    def n_buckets(self) -> int:
        return 1 << self.n_planes

    def bucket_ids(self, queries) -> np.ndarray:
        """[n, d] -> [n] int64 bucket ids."""
        q = host(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(f"expected queries [n, {self.d}], got {q.shape}")
        return ((q @ self._planes) > 0) @ self._weights

    def histogram(self, queries) -> np.ndarray:
        """[n, d] -> [2^n_planes] float64 bucket counts."""
        return np.bincount(self.bucket_ids(queries),
                           minlength=self.n_buckets).astype(np.float64)


def _smoothed(counts, eps: float) -> np.ndarray:
    p = np.asarray(counts, np.float64) + eps
    return p / p.sum()


def kl_divergence(live, ref, eps: float = 1e-3) -> float:
    """Smoothed KL(live || ref) over two count histograms. Additive-eps
    smoothing keeps buckets the reference never saw finite; >= 0, and 0
    iff the smoothed distributions coincide."""
    p, q = _smoothed(host(live), eps), _smoothed(host(ref), eps)
    return float(np.sum(p * np.log(p / q)))


def chi_square(live, ref, eps: float = 1e-3) -> float:
    """Smoothed chi-square distance between two count histograms."""
    p, q = _smoothed(host(live), eps), _smoothed(host(ref), eps)
    return float(np.sum((p - q) ** 2 / q))


class DriftDetector:
    """Scores the live query window against a fit-time reference sketch.

    ``record`` accumulates served queries into the live bucket histogram
    (hot-path cheap: one matmul over the batch + a bincount); ``score``
    publishes smoothed KL as the ``query_drift_score`` gauge (plus
    ``drift_query_kl`` / ``drift_chi_square`` / ``drift_window_total``).
    After a refit swap the loop re-anchors via ``set_reference`` (the new
    artifact's frozen sketch) and ``reset_window`` so recovery is visible
    on the next score. Below ``min_count`` live rows the score reports 0 —
    an empty window is "no evidence", not "no drift alarm"."""

    def __init__(self, sketch: QuerySketch, reference=None, *,
                 registry=None, min_count: int = 16):
        self.sketch = sketch
        self.min_count = int(min_count)
        self.registry = _registry(registry)
        self._lock = threading.Lock()
        self._live = np.zeros(sketch.n_buckets, np.float64)
        self._ref = None
        if reference is not None:
            self.set_reference(reference)

    @property
    def reference(self) -> np.ndarray | None:
        with self._lock:
            return None if self._ref is None else self._ref.copy()

    def set_reference(self, hist) -> None:
        hist = host(hist, np.float64).ravel()
        if hist.shape[0] != self.sketch.n_buckets:
            raise ValueError(
                f"reference histogram has {hist.shape[0]} buckets, sketch "
                f"has {self.sketch.n_buckets}")
        with self._lock:
            self._ref = hist.copy()

    def record(self, queries) -> None:
        hist = self.sketch.histogram(queries)
        with self._lock:
            self._live += hist

    def reset_window(self) -> None:
        with self._lock:
            self._live[:] = 0.0

    def score(self) -> float:
        """Score the live window vs the reference and publish the gauges.
        Returns the KL score (0 when no reference or not enough data)."""
        with self._lock:
            live = self._live.copy()
            ref = None if self._ref is None else self._ref.copy()
        reg = self.registry
        reg.counter("drift_scores_total").inc()
        n_live = float(live.sum())
        reg.gauge("drift_window_total").set(n_live)
        if ref is None or n_live < self.min_count:
            kl = chi = 0.0
        else:
            kl = kl_divergence(live, ref)
            chi = chi_square(live, ref)
        reg.gauge("query_drift_score").set(kl)
        reg.gauge("drift_query_kl").set(kl)
        reg.gauge("drift_chi_square").set(chi)
        return kl


# ------------------------------------------------------------------- SLO --
@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declarative serving SLOs (None disables a rule; docs/quality.md).

    Rules read the shared registry: ``p99_latency_s`` against the
    ``latency_metric`` histogram's q99, ``min_live_recall`` against the
    shadow auditor's ``quality_live_recall`` gauge, ``max_drift`` against
    ``query_drift_score``, ``max_load_kl`` against the ``probe_metric``
    VectorCounter's KL-vs-uniform. Hysteresis: a rule enters ``warn`` on
    its first breach, escalates to ``critical`` after ``trip_after``
    consecutive breaching evaluations, and recovers to ``ok`` only after
    ``clear_after`` consecutive clear evaluations."""
    p99_latency_s: float | None = None
    min_live_recall: float | None = None
    max_drift: float | None = None
    max_load_kl: float | None = None
    trip_after: int = 2
    clear_after: int = 2
    latency_metric: str = "serve_batch_seconds"
    probe_metric: str = "serve_bucket_probes"


class SLOMonitor:
    """Evaluates an :class:`SLOSpec` into per-rule ok/warn/critical states.

    ``evaluate()`` is one cadence tick (``start(interval_s)`` runs it on a
    daemon thread): read each configured signal from the registry, update
    the hysteresis state machine, and publish ``slo_state{slo=...}``
    (0/1/2), ``slo_breaches_total{slo=...}``, ``slo_transitions_total`` and
    the worst-of ``slo_health`` gauge. A signal nothing has recorded yet is
    "no data" — the rule holds its state instead of false-alarming at
    startup. ``health()`` is the ``/healthz`` source: 503 iff any rule is
    critical."""

    def __init__(self, spec: SLOSpec, registry=None):
        self.spec = spec
        self.registry = _registry(registry)
        self._lock = threading.Lock()
        self._state: dict[str, int] = {}
        self._breach: dict[str, int] = {}
        self._clear: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------- signals --
    def _read(self, rule: str) -> float | None:
        """Current value of a rule's signal, or None when nothing recorded
        it yet (``MetricRegistry.get`` never creates)."""
        reg = self.registry
        if rule == "p99_latency":
            h = reg.get(self.spec.latency_metric)
            if h is None or h.count == 0:
                return None
            return float(h.quantile(0.99))
        if rule == "live_recall":
            audits = reg.get("quality_audits_total")
            if audits is None or audits.value <= 0:
                return None
            g = reg.get("quality_live_recall")
            return None if g is None else float(g.value)
        if rule == "drift":
            scored = reg.get("drift_scores_total")
            if scored is None or scored.value <= 0:
                return None
            g = reg.get("query_drift_score")
            return None if g is None else float(g.value)
        if rule == "load_kl":
            v = reg.get(self.spec.probe_metric)
            if v is None:
                return None
            counts = v.value
            if counts.sum() <= 0:
                return None
            return float(load_balance_stats(counts)["kl_vs_uniform"])
        raise ValueError(f"unknown SLO rule {rule!r}")

    def _rules(self):
        s = self.spec
        if s.p99_latency_s is not None:
            yield "p99_latency", (lambda v: v > s.p99_latency_s)
        if s.min_live_recall is not None:
            yield "live_recall", (lambda v: v < s.min_live_recall)
        if s.max_drift is not None:
            yield "drift", (lambda v: v > s.max_drift)
        if s.max_load_kl is not None:
            yield "load_kl", (lambda v: v > s.max_load_kl)

    # ---------------------------------------------------------- evaluate --
    def evaluate(self) -> dict:
        """One cadence tick. Returns {rule: state} after the update."""
        reg = self.registry
        spec = self.spec
        with self._lock:
            for rule, breached in self._rules():
                value = self._read(rule)
                state = self._state.get(rule, OK)
                if value is not None:
                    if breached(value):
                        reg.counter("slo_breaches_total",
                                    {"slo": rule}).inc()
                        self._breach[rule] = self._breach.get(rule, 0) + 1
                        self._clear[rule] = 0
                        new = (CRITICAL if self._breach[rule]
                               >= spec.trip_after else WARN)
                        state = max(state, new)
                    else:
                        self._clear[rule] = self._clear.get(rule, 0) + 1
                        self._breach[rule] = 0
                        if state != OK and \
                                self._clear[rule] >= spec.clear_after:
                            state = OK
                    reg.gauge("slo_value", {"slo": rule}).set(value)
                if state != self._state.get(rule, OK):
                    reg.counter("slo_transitions_total", {"slo": rule}).inc()
                self._state[rule] = state
                reg.gauge("slo_state", {"slo": rule}).set(state)
            states = dict(self._state)
        reg.gauge("slo_health").set(max(states.values(), default=OK))
        reg.counter("slo_evaluations_total").inc()
        return states

    @property
    def state(self) -> dict:
        """{rule: 0|1|2} as of the last evaluation."""
        with self._lock:
            return dict(self._state)

    def health(self) -> dict:
        """The ``/healthz`` payload: overall status + per-rule states."""
        states = self.state
        worst = max(states.values(), default=OK)
        return {"status": STATE_NAMES[worst],
                "states": {r: STATE_NAMES[s] for r, s in sorted(
                    states.items())}}

    # -------------------------------------------------------- background --
    def start(self, interval_s: float = 1.0) -> None:
        """Evaluate every ``interval_s`` s on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("SLOMonitor already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:       # noqa: BLE001 — monitor must survive
                    self.registry.counter("slo_monitor_errors_total").inc()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obs-slo-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None


def uptime_source():
    """A ``/statusz`` helper: returns a closure reporting seconds since it
    was created (server construction time)."""
    t0 = time.monotonic()
    return lambda: {"uptime_s": round(time.monotonic() - t0, 3)}
