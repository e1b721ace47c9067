"""OnlineRefitLoop — background query-aware re-partitioning with
zero-downtime artifact swap (docs/online.md). Port of
``repro/online/refit.py``.

The serving stack already produces everything a refit needs as a side
effect: the IRLIServer counts per-bucket probe frequencies into a
``serve_bucket_probes`` VectorCounter and (when given an ``obs.QueryLog``)
samples (query, served ids) pairs. One refit cycle:

  1. **drain** the query log — the sampled live traffic since last cycle;
  2. **fit** ``rounds_per_cycle`` incremental :class:`~repro_torch.fit.
     engine.FitEngine` rounds AGAINST THAT TRAFFIC: queries are the train
     points, the ids the server returned are their (self-)labels, and the
     label vectors are the index's own live rows — so buckets re-balance
     toward what is actually being asked. The rounds train COPIES of the
     serving scorer (the port's AdamW updates in place), so searches keep
     the old scorer, bit for bit, until the swap. On the card a round runs
     bce_logits once a train step (sigmoid_bce), irli_topk once an affinity
     label chunk and kchoice once;
  3. **seal** the result as a versioned :class:`repro_torch.artifact.
     IndexArtifact`: new scorer params + assignment, member matrix rebuilt
     via :func:`repro_torch.artifact.rebuild_members`, vecs / quantized
     codes / tombstone carried from the serving snapshot BY REFERENCE,
     optional hot-bucket replicas from the decayed probe counters
     (:mod:`repro_torch.online.policy`);
  4. **swap** it into the serving index — ``install_artifact`` is a
     single snapshot-pointer flip guarded by the same machinery as
     compaction: readers pin a snapshot per batch, inserts that raced the
     refit are re-placed under the new scorer inside the swap, stale
     versions are rejected;
  5. **age** the probe counters (``VectorCounter.decay``) so the next
     cycle's hot-bucket view is a sliding window, and optionally persist
     the artifact through a CheckpointManager (atomic write-rename).

``run_cycle()`` is the synchronous unit (tests, benchmarks); ``start()``
runs it on a daemon thread. The trigger policy (docs/quality.md) decides
WHEN: the classic fixed cadence (``interval_s``), and/or quality signals —
``on_drift`` fires when the DriftDetector's live-vs-reference KL crosses a
threshold, ``on_recall_alert`` when the SLOMonitor's ``live_recall`` rule
goes critical — so re-partitioning happens when the query distribution
actually moved, not on a blind clock. Each cycle also: freezes the drained
window's query sketch into the sealed artifact (the NEXT reference), re-
anchors the DriftDetector on it after the swap, and reports its own
effectiveness as the shadow-audited recall delta across the version swap
(``refit_audited_recall_pre``/``_post``/``_delta``).

``mesh=`` (a ("data", "rep") DeviceMesh, ``launch/mesh.make_fit_mesh``)
runs the cycle's rounds through ``FitEngine.make_sharded_fit_round``:
every rank runs the cycle in lockstep over the same index and query log,
fits its rep rows, and gathers the reps before sealing the artifact. The
static contracts at the end of this module hold the refit round to the
no-[.., L, B] guarantee and the swap to no copy of the vector payload
(``repro_torch.launch.audit``). The round's random stream is a
``torch.Generator`` seeded ``seed + round counter`` where the reference
seeds ``jax.random.PRNGKey``; parity tests inject the reference's batch
order and insertion orders.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.artifact import IndexArtifact, rebuild_members
from repro_torch.core import query as Q
from repro_torch.core.network import ScorerConfig
from repro_torch.fit.engine import FitData, FitEngine
from repro_torch.fit.state import FitState
from repro_torch.obs.qlog import host
from repro_torch.online.policy import build_replicas
from repro_torch.stream.delta import delta_init

PROBE_COUNTER = "serve_bucket_probes"   # the server's [R·B] probe vector


def _round_up(x: int, mult: int = 8) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


@dataclasses.dataclass
class RefitConfig:
    """Knobs of one background refit loop (docs/online.md).

    Trigger policy (docs/quality.md): ``interval_s`` is the classic fixed
    cadence (None disables it); ``on_drift`` fires a cycle as soon as the
    wired DriftDetector's KL score exceeds the threshold; ``on_recall_alert``
    fires when the wired SLOMonitor's ``live_recall`` rule is critical.
    With any quality trigger armed the loop polls at ``poll_s`` instead of
    sleeping a whole interval."""
    interval_s: float | None = 5.0  # fixed cadence (None = triggers only)
    rounds_per_cycle: int = 1      # fit rounds per drained traffic batch
    epochs_per_round: int | None = None   # None -> the index cfg's value
    min_queries: int = 32          # leave the log accumulating below this
    counter_decay: float = 0.5     # probe-counter aging per cycle (1 = off)
    hot_frac: float = 0.0          # >0 enables hot-bucket replication
    replica_len: int = 8           # replica segment length [R, B, RL]
    probe_mass: float = 0.9        # m(q) telemetry target mass
    telemetry_m: int = 5           # probe budget the m(q) gauge is over
    persist: bool = False          # save each artifact via the manager
    seed: int = 0
    on_drift: float | None = None  # KL threshold firing a cycle (needs drift)
    on_recall_alert: bool = False  # fire on critical live_recall (needs monitor)
    poll_s: float = 0.5            # trigger-poll period when quality-armed
    audit_queries: int = 128       # swap-delta audit window (needs auditor)
    sketch_planes: int = 6         # frozen-reference sketch (no drift wired)
    sketch_seed: int = 0


def make_refit_round(cfg, *, params, assign, x, label_ids, label_mask,
                     label_vecs, rng, rounds: int,
                     epochs_per_round: int | None = None):
    """(engine, data, state) for incremental rounds over a traffic batch,
    on the device of ``label_vecs``.

    ``cfg`` is the serving index's IRLIConfig re-anchored at ``n_labels =
    len(label_vecs)`` (the live corpus is the label set); the round streams
    the query->bucket affinity in label chunks — never a dense [L, B]
    table. ``rng``: a torch.Generator, its state or an int seed.
    """
    L = int(label_vecs.shape[0])
    dev = label_vecs.device
    rcfg = dataclasses.replace(
        cfg, n_labels=L, rounds=int(rounds),
        epochs_per_round=int(epochs_per_round if epochs_per_round is not None
                             else cfg.epochs_per_round),
        affinity_chunk=min(cfg.affinity_chunk, L))
    scfg = ScorerConfig(d_in=rcfg.d, d_hidden=rcfg.d_hidden,
                        n_buckets=rcfg.n_buckets, n_reps=rcfg.n_reps,
                        loss=rcfg.loss)
    data = FitData.build(x, label_ids, label_mask, label_vecs=label_vecs,
                         n_labels=L, chunk=rcfg.affinity_chunk, device=dev)
    engine = FitEngine(rcfg, scfg)
    # train COPIES: the round updates its state in place, and the serving
    # snapshot's params must keep serving until the swap (and survive a
    # refit that dies mid-cycle)
    params = {k: v.detach().clone() for k, v in params.items()}
    state = FitState.create(params, engine.opt.init(params),
                            torch.as_tensor(assign).to(device=dev,
                                                       dtype=torch.int32),
                            rng)
    return engine, data, state


class OnlineRefitLoop:
    """Background loop re-partitioning a MutableIRLIIndex against its
    own serve traffic. Single-writer: at most one cycle runs at a time
    (``run_cycle`` is not re-entrant; the daemon thread serializes them).
    Mutations and searches keep flowing throughout — the only serialized
    moment is ``install_artifact``'s pointer flip."""

    def __init__(self, index, qlog: "obs.QueryLog", *,
                 config: RefitConfig | None = None, registry=None,
                 manager=None, mesh=None, auditor=None, drift=None,
                 monitor=None):
        self.index = index
        self.qlog = qlog
        self.config = config if config is not None else RefitConfig()
        # share the SERVER's registry so the loop sees serve_bucket_probes
        self.registry = obs.get_registry(registry)
        self.manager = manager
        self.mesh = mesh
        # quality wiring (all optional; docs/quality.md): the ShadowAuditor
        # scores the swap delta, the DriftDetector arms on_drift and gets
        # re-anchored on each new artifact's sketch, the SLOMonitor arms
        # on_recall_alert
        self.auditor = auditor
        self.drift = drift
        self.monitor = monitor
        self._round_counter = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------- triggers --
    def should_fire(self, elapsed_s: float) -> str | None:
        """The trigger policy: why a cycle should run NOW, or None.
        Quality triggers outrank the clock — a drift spike must not wait
        out the cadence (and must fire even with ``interval_s=None``)."""
        rc = self.config
        trigger = None
        if rc.on_drift is not None and self.drift is not None:
            if self.drift.score() > rc.on_drift:
                trigger = "drift"
        if trigger is None and rc.on_recall_alert and self.monitor is not None:
            from repro_torch.obs.quality import CRITICAL
            if self.monitor.state.get("live_recall", 0) >= CRITICAL:
                trigger = "recall"
        if trigger is None and rc.interval_s is not None \
                and elapsed_s >= rc.interval_s * 0.999:
            trigger = "interval"
        if trigger is not None:
            self.registry.counter("refit_trigger_total",
                                  {"trigger": trigger}).inc()
        return trigger

    # ------------------------------------------------------------- cycle --
    def run_cycle(self) -> IndexArtifact | None:
        """One synchronous refit cycle; returns the installed artifact, or
        None when the query log has not accumulated ``min_queries`` yet."""
        rc = self.config
        reg = self.registry
        if len(self.qlog) < rc.min_queries:
            reg.counter("refit_cycles_skipped_total").inc()
            return None
        t0 = time.perf_counter()
        x, ids = self.qlog.drain()
        # swap-delta audit (docs/quality.md): replay a slice of the drained
        # window through the SERVE path now and again after the install, and
        # score both against the exact oracle — the cycle's effectiveness
        aud = self.auditor if (self.auditor is not None
                               and self.auditor.searcher is not None) else None
        xs = pre = None
        if aud is not None and x.shape[0]:
            xs = np.asarray(x[: min(int(x.shape[0]), rc.audit_queries)],
                            np.float32)
            pre = aud.recall_of(xs, aud.searcher(xs))
        midx = self.index
        s = midx.snapshot               # ONE read: the cycle's base state
        n = int(s.n_total)
        B = midx.cfg.n_buckets
        tomb = host(s.tombstone)
        # served ids self-label the traffic; -1 pads, out-of-range rows
        # (an id from an older epoch) and tombstoned targets drop out
        cids = np.clip(ids, 0, n - 1).astype(np.int32)
        mask = ((ids >= 0) & (ids < n)
                & ~tomb[cids]).astype(np.float32)
        engine, data, state = make_refit_round(
            midx.cfg, params=s.params,
            # dead/unused sentinel B is out of the scorer's range; the fit
            # re-derives every assignment anyway, so clamp for the round
            assign=torch.clamp(s.assign[:, :n], max=B - 1),
            x=x, label_ids=cids, label_mask=mask, label_vecs=s.vecs[:n],
            rng=rc.seed + self._round_counter,
            rounds=rc.rounds_per_cycle,
            epochs_per_round=rc.epochs_per_round)
        if self.mesh is None:
            round_fn = engine.make_fit_round(data)
        else:
            state = engine.shard_state(state, self.mesh)
            round_fn = engine.make_sharded_fit_round(self.mesh, data, state)
        nq = int(x.shape[0])
        t_fit = time.perf_counter()
        for _ in range(rc.rounds_per_cycle):
            idx_b, w = self._round_batches(engine, nq)
            self._round_counter += 1
            state, met = round_fn(state, idx_b, w,
                                  self._round_orders(state))
            reg.counter("refit_rounds_total").inc()
            reg.gauge("refit_loss").set(float(met["loss"]))
            reg.gauge("refit_n_reassigned").set(int(met["n_reassigned"]))
        if self.mesh is not None:
            state = engine.gather_state(state, self.mesh)
        reg.histogram("refit_fit_seconds").observe(
            time.perf_counter() - t_fit)

        art = self._build_artifact(state, s, n, sketch_hist=self._sketch(x))
        try:
            midx.install_artifact(art)
        except ValueError:
            # the epoch moved while we fit (a compaction, a concurrent
            # install): same content, re-versioned past the new epoch
            art = art.with_version(midx.epoch + 1)
            midx.install_artifact(art)
        if self.drift is not None and art.sketch is not None:
            # re-anchor drift on the distribution this artifact was fitted
            # to; clearing the live window makes recovery visible at the
            # next score
            self.drift.set_reference(art.sketch)
            self.drift.reset_window()
        if xs is not None:
            post = aud.recall_of(xs, aud.searcher(xs))
            reg.gauge("refit_audited_recall_pre").set(pre)
            reg.gauge("refit_audited_recall_post").set(post)
            reg.gauge("refit_audited_recall_delta").set(post - pre)
        # age the probe window AFTER replica building consumed this cycle's
        # counts; next cycle sees a sliding, recency-weighted view
        R = midx.cfg.n_reps
        if rc.counter_decay < 1.0:
            reg.vector(PROBE_COUNTER, R * B).decay(rc.counter_decay)
        if rc.persist and self.manager is not None:
            art.save(self.manager)
        # m(q) telemetry: what the LIRA-style adaptive policy would probe
        # for this cycle's traffic under the NEW scorer
        pm = Q.predicted_probe_counts(
            state.params, torch.from_numpy(x[: min(nq, 256)]).to(
                s.vecs.device), m=rc.telemetry_m, probe_mass=rc.probe_mass)
        reg.gauge("refit_predicted_m_mean").set(float(
            pm.to(torch.float32).mean()))
        reg.counter("refit_cycles_total").inc()
        reg.counter("refit_queries_total").inc(nq)
        reg.gauge("refit_artifact_version").set(int(art.version))
        reg.histogram("refit_cycle_seconds").observe(
            time.perf_counter() - t0)
        return art

    def _round_batches(self, engine: FitEngine, nq: int):
        """The round's batch order: ``engine.round_batches`` (a pure
        function of (nq, seed, round counter)). Parity tests replace it
        with the reference's order."""
        return engine.round_batches(nq, self.config.seed,
                                    self._round_counter)

    def _round_orders(self, state: FitState):
        """The re-partition's insertion orders: None draws them from the
        state's generator. Parity tests replace it with the reference's."""
        del state
        return None

    def _sketch(self, x):
        """The drained window's query-sketch histogram (frozen into the
        sealed artifact as the NEXT drift reference), or None on an empty
        window. Uses the wired DriftDetector's sketch so reference and live
        scoring share identical hyperplanes."""
        if x.shape[0] == 0:
            return None
        rc = self.config
        if self.drift is not None:
            sk = self.drift.sketch
        else:
            from repro_torch.obs.quality import QuerySketch
            sk = QuerySketch(int(x.shape[1]), rc.sketch_planes,
                             rc.sketch_seed)
        return sk, sk.histogram(x)

    def _build_artifact(self, state: FitState, s, n: int,
                        sketch_hist=None) -> IndexArtifact:
        """Seal the fit result + carried payload as the next artifact."""
        rc = self.config
        midx = self.index
        cfg = midx.cfg
        B, R = cfg.n_buckets, cfg.n_reps
        dev = s.assign.device
        tomb_n = s.tombstone[:n]
        new_assign = torch.where(tomb_n[None, :],
                                 torch.full((), B, dtype=torch.int32,
                                            device=dev),
                                 state.assign.to(torch.int32))    # [R, n]
        cap_assign = s.assign.clone()
        cap_assign[:, :n] = new_assign
        live = torch.zeros((R, B + 1), dtype=torch.int32, device=dev)
        live.scatter_add_(1, new_assign.long(),
                          torch.ones_like(new_assign))
        live_max = int(live[:, :B].max())
        # keep the member-matrix shape stable when possible: a constant
        # shape keeps the serving pipeline's cache entries warm across
        # swaps
        max_load = max(int(s.members.shape[-1]), _round_up(live_max, 8))
        members, load = rebuild_members(cap_assign, s.tombstone,
                                        B=B, max_load=max_load)
        replicas = None
        if rc.hot_frac > 0.0:
            counts = self.registry.vector(PROBE_COUNTER, R * B).value
            replicas = build_replicas(
                state.params, s.vecs, members, s.tombstone, counts,
                hot_frac=rc.hot_frac, replica_len=rc.replica_len)
        tmp = dataclasses.replace(
            s, params=state.params, members=members, load=load,
            assign=cap_assign,
            delta=delta_init(R, B, int(s.delta.members.shape[-1]), dev),
            replicas=replicas)
        sk, hist = sketch_hist if sketch_hist is not None else (None, None)
        return IndexArtifact.from_snapshot(
            tmp, cfg, version=midx.epoch + 1, capacity=midx.capacity,
            store_block=midx.store_block, n_base=midx.n_base,
            sketch=hist,
            sketch_planes=sk.n_planes if sk is not None else 0,
            sketch_seed=sk.seed if sk is not None else 0)

    # -------------------------------------------------------- background --
    def start(self) -> None:
        """Run the trigger policy on a daemon thread: poll ``should_fire``
        and run a cycle whenever it names a trigger (with no quality
        trigger armed this degrades to the classic every-``interval_s``
        cadence)."""
        if self._thread is not None:
            raise RuntimeError("OnlineRefitLoop already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        rc = self.config
        armed = (rc.on_drift is not None and self.drift is not None) or \
                (rc.on_recall_alert and self.monitor is not None)
        poll = rc.poll_s if (armed or rc.interval_s is None) \
            else rc.interval_s
        last = time.monotonic()
        while not self._stop.wait(poll):
            trigger = self.should_fire(time.monotonic() - last)
            if trigger is None:
                continue
            try:
                if self.run_cycle() is not None:
                    last = time.monotonic()
            except Exception as e:   # noqa: BLE001 — loop must survive
                self.registry.counter("refit_errors_total").inc()
                warnings.warn(f"online refit cycle failed: {e!r}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None


# ------------------------------------------------------- static contracts --
# The refit round must stay [.., L, B]-free (the live corpus can be 100M
# rows) and the swap's device work must never copy the [capacity, d]
# payload. Fixtures live in analysis/fixtures.py.
from repro_torch.analysis import contracts as _C  # noqa: E402


def _refit_round_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.online_refit_round()


def _refit_dense_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.online_refit_dense_control()


def _swap_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.online_swap_no_copy()


def _swap_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.online_swap_copy_control()


_C.register(_C.Contract(
    id="online.refit_round_no_dense_affinity",
    site="repro_torch.online.refit.make_refit_round",
    description="the incremental refit round over drained serve traffic "
                "streams query->bucket affinity in label chunks (held on "
                "chip by irli_topk on the card) — it never materializes "
                "[.., L, B] even though the label set is the live corpus; "
                "the seed-style dense re-partition is the control",
    fixture=_refit_round_fixture,
    checks=[
        _C.forbid_dims("L", "B"),
        _C.require_dims("chunk", "B", on_chip="irli_topk"),
        _C.require_dims("L", "K"),
    ],
    control=_refit_dense_control,
))

_C.register(_C.Contract(
    id="online.swap_no_index_copy",
    site="repro_torch.stream.mutable_index.MutableIRLIIndex."
         "install_artifact",
    description="the swap's only device work (member-matrix rebuild, "
                "artifact.rebuild_members) never materializes a "
                "[capacity, d] copy of the vector payload and stays under "
                "a small intermediate budget — vecs/codes move between "
                "artifact and snapshot by reference; a variant that "
                "touches the payload is the control",
    fixture=_swap_fixture,
    checks=[
        _C.forbid_dims("cap", "d"),
        _C.require_dims("cap"),
        _C.max_intermediate_bytes(1 << 19),
    ],
    control=_swap_control,
))
