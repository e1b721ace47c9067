"""MutableIRLIIndex — online insert/delete over a fitted IRLI index. Port of
``repro/stream/mutable_index.py``.

Adding or removing an item never requires retraining (paper §3.3). A new
item is scored by the R trained scorers and placed into the least loaded of
its top-K buckets given the LIVE loads — the power-of-K rule the fit ran
(``kchoice``) — so the load balance keeps holding as the corpus grows.
Deletion tombstones the id.

  - The queryable state is ONE immutable :class:`StreamSnapshot`; every
    mutation builds new tensors (it never writes the current snapshot's)
    and swaps the new snapshot in with one attribute store. A reader takes
    ``self._snapshot`` once per batch and never sees a half-applied
    mutation.
  - Inserted items go to fixed-capacity delta segments (delta.py); when a
    segment would overflow, compaction (compaction.py) folds deltas and
    tombstones into a rebuilt member matrix and the insert retries.
  - Vectors live in a preallocated [capacity, d] buffer, so the rerank
    covers inserted items with no reallocation.

On the card an insert batch is one ``irli_topk`` launch (the scorer's
top-K, no [R, n, B] probabilities) and one ``kchoice`` launch (the
placement against the live loads); the exact oracle is one
``distance_topk`` launch.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch import obs
from repro_torch.core import query as Q
from repro_torch.core import search_api as SA
from repro_torch.core.repartition import insertion_orders
from repro_torch.kernels import resolve_device
from repro_torch.kernels.kchoice.ops import kchoice_assign
from repro_torch.store.quantized import (QuantizedStore, encode,
                                         store_from_arrays, store_to_arrays,
                                         to_tensor)
from repro_torch.stream import compaction
from repro_torch.stream.delta import (DeltaState, default_delta_len,
                                      delta_append, delta_init)


@dataclasses.dataclass(frozen=True)
class StreamSnapshot:
    """The complete queryable state at one epoch. Scorer params live inside
    it, so a restore is also one atomic store."""
    params: dict             # stacked R-rep scorer params
    members: torch.Tensor    # [R, B, ML] base member matrix (pad -1)
    delta: DeltaState        # [R, B, DL] append segments + fill
    tombstone: torch.Tensor  # [capacity] bool — True = deleted
    load: torch.Tensor       # [R, B] int32 LIVE loads (base + delta - dead)
    assign: torch.Tensor     # [R, capacity] int32 bucket per id (B = unused)
    vecs: torch.Tensor       # [capacity, d] float32 vector buffer
    n_total: int             # high-water mark of issued ids
    epoch: int               # bumped on every mutation / compaction
    store: QuantizedStore | None = None   # quantized coarse tier over the
    #                          same [capacity, d] rows: inserts encode into
    #                          it, compaction re-encodes it from vecs
    replicas: torch.Tensor | None = None  # [R, B, RL] int32 hot-bucket
    #                          replica segments (pad -1), gathered like delta
    #                          members when SearchParams.hot_replicas=True


def _score_and_place(params: dict, load: torch.Tensor, vecs: torch.Tensor,
                     valid: torch.Tensor, *, B: int, K: int) -> torch.Tensor:
    """Score new vectors with the R scorers and place each, per rep, into
    the least loaded of its top-K buckets against the live loads, in id
    order -> buckets [R, n_pad] int32. ``valid`` [n_pad] masks padding rows
    (weight 0 in the placement). The top-K is taken over the logits (one
    irli_topk launch on the card): softmax and sigmoid are monotone, so it
    is the reference's top-K of the probabilities, which at 4096 inserts
    would be a 10.5 GB [R, n, B] tensor."""
    _, topk = Q.scorer_top_m(params, vecs, K)                    # [R, n, K]
    R, n, _ = topk.shape
    order = insertion_orders(R, n, topk.device)
    return kchoice_assign(topk, order, load0=load,
                          weights=valid.to(torch.float32), B=B)


def snapshot_from_arrays(tree: dict, extra: dict,
                         device: torch.device) -> StreamSnapshot:
    """A snapshot from a ``state_dict``'s arrays (numpy or tensors; either
    package's) and its ``meta`` on ``device``."""
    st = tree["stream"]

    def t(name, dtype):
        return to_tensor(st[name], dtype, device)

    store = store_from_arrays(st, str(extra.get("store_dtype", "fp32")),
                              int(extra.get("store_block", 32)),
                              device=device)
    return StreamSnapshot(
        params={k: to_tensor(v, torch.float32, device)
                for k, v in tree["scorer"].items()},
        members=t("members", torch.int32),
        delta=DeltaState(members=t("delta_members", torch.int32),
                         fill=t("delta_fill", torch.int32)),
        tombstone=t("tombstone", torch.bool),
        load=t("load", torch.int32),
        assign=t("assign", torch.int32),
        vecs=t("vecs", torch.float32),
        n_total=int(extra["n_total"]), epoch=int(extra["epoch"]),
        store=store,
        replicas=t("replicas", torch.int32) if "replicas" in st else None)


class MutableIRLIIndex:
    """Streaming wrapper around a fitted :class:`IRLIIndex`.

    Single writer, many readers: mutations (``insert``/``delete``/
    ``compact``/``install_artifact``) serialize on an internal lock;
    searches read one snapshot and may run from any thread. The state lives
    on ``device`` (default: the index's). The snapshot shares the index's
    scorer tensors, which ``IRLIIndex.fit`` updates in place: refit a
    wrapped index through an artifact install (repro_torch.online.refit,
    whose rounds train copies).
    """

    def __init__(self, index, base_vecs, capacity: int | None = None,
                 delta_len: int | None = None, store_dtype: str = "fp32",
                 store_block: int = 32, registry=None,
                 device: str | torch.device | None = None):
        if index.index is None:
            raise RuntimeError("fit() or build_index() first")
        self.cfg = index.cfg
        self.device = (index.device if device is None
                       else resolve_device(device))
        # streaming telemetry: mutation counters, delta-occupancy /
        # tombstone-ratio gauges, compaction timings
        self.registry = obs.get_registry(registry)
        dev = self.device
        base_vecs = torch.as_tensor(base_vecs, dtype=torch.float32).to(dev)
        L, d = base_vecs.shape
        if L != self.cfg.n_labels:
            raise ValueError(f"{L} base vectors for an index of "
                             f"{self.cfg.n_labels} labels")
        B, R = self.cfg.n_buckets, self.cfg.n_reps
        self.capacity = int(capacity if capacity is not None else 2 * L)
        if self.capacity < L:
            raise ValueError(f"capacity {self.capacity} < {L} base rows")
        self.n_base = L
        self.store_dtype = store_dtype
        self.store_block = store_block
        DL = (delta_len if delta_len is not None
              else default_delta_len(self.capacity, L, B))
        vecs = torch.zeros((self.capacity, d), dtype=torch.float32,
                           device=dev)
        vecs[:L] = base_vecs
        assign = torch.full((R, self.capacity), B, dtype=torch.int32,
                            device=dev)                       # B = unused
        assign[:, :L] = index.assign.to(dev)
        store = (None if store_dtype == "fp32"
                 else encode(vecs, store_dtype, store_block))
        self._snapshot = StreamSnapshot(
            params={k: v.to(dev) for k, v in index.params.items()},
            members=index.index.members.to(dev),
            delta=delta_init(R, B, DL, dev),
            tombstone=torch.zeros((self.capacity,), dtype=torch.bool,
                                  device=dev),
            load=index.index.load.to(device=dev, dtype=torch.int32),
            assign=assign, vecs=vecs, n_total=L, epoch=0, store=store)
        # A frozen index may truncate over-full buckets (max_load), leaving
        # members ⊊ assign. Delete's load accounting and compaction both
        # rebuild from assign, so re-derive an untruncated member matrix.
        if int(index.index.load.max()) > index.index.max_load:
            self._snapshot = dataclasses.replace(
                compaction.compact_snapshot(self._snapshot, B), epoch=0)
        self._mu = threading.RLock()
        # (delta.members, replicas) -> their concatenation, built once per
        # snapshot for the hot-replica gather
        self._replica_memo = None

    # ------------------------------------------------------------ reading --
    @property
    def snapshot(self) -> StreamSnapshot:
        return self._snapshot

    @property
    def params(self) -> dict:
        return self._snapshot.params

    @property
    def epoch(self) -> int:
        return self._snapshot.epoch

    @property
    def n_total(self) -> int:
        return self._snapshot.n_total

    @property
    def n_live(self) -> int:
        s = self._snapshot
        return s.n_total - int(s.tombstone[:s.n_total].sum())

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, dtype=torch.float32).to(self.device)

    def query(self, queries, m: int = 5, tau: int = 1):
        """-> (cand_mask [Q, capacity] bool, freq [Q, capacity] f32,
        n_candidates [Q] int32) over the live corpus."""
        s = self._snapshot
        return Q.query_members(s.params, s.members, self._queries(queries),
                               m=m, tau=tau, L=self.capacity,
                               loss_kind=self.cfg.loss,
                               delta_members=s.delta.members,
                               tombstone=s.tombstone)

    def search(self, queries, params: SA.SearchParams | None = None, *,
               cache: SA.PipelineCache | None = None, staged: bool = False,
               m=None, tau=None, k=None, metric=None, mode=None, topC=None):
        """Candidate generation + true-distance re-rank over the LIVE corpus
        (base + inserted - deleted).

        Typed path: ``search(queries, SearchParams(...))`` -> SearchResult
        served against ONE snapshot (``result.epoch`` names it). mode="auto"
        resolves against the vector-buffer capacity. The bare kwargs are a
        deprecated shim returning the old ``(ids, n_candidates)`` tuple."""
        if params is None:
            params = SA.params_from_legacy_kwargs(
                "MutableIRLIIndex.search", m=m, tau=tau, k=k, metric=metric,
                mode=mode, topC=topC)
            res = self._search_typed(queries, params, cache, staged=staged)
            return res.ids, res.n_candidates
        SA.check_params("MutableIRLIIndex.search", params)
        if any(v is not None for v in (m, tau, k, metric, mode, topC)):
            raise TypeError("pass either SearchParams or legacy kwargs, "
                            "not both")
        return self._search_typed(queries, params, cache, staged=staged)

    def _search_typed(self, queries, params: SA.SearchParams,
                      cache: SA.PipelineCache | None, *,
                      staged: bool = False) -> SA.SearchResult:
        s = self._snapshot          # ONE read: a consistent view throughout
        cache = cache if cache is not None else SA.DEFAULT_CACHE
        if params.store_dtype == "fp32":
            base = s.vecs
        elif s.store is None:
            raise ValueError(
                f"params.store_dtype={params.store_dtype!r} but this index "
                "was built without a quantized store — construct "
                "MutableIRLIIndex(..., store_dtype=...)")
        else:
            # the fp32 buffer is the exact refine tier: coarse scoring
            # gathers code rows, the k' survivors re-score in fp32
            base = dataclasses.replace(s.store, exact=s.vecs)
        delta_members = s.delta.members
        if params.hot_replicas and s.replicas is not None:
            # replica segments ride the delta gather: concatenated once per
            # (delta, replicas) pair, memoised by identity (a mutation swaps
            # in new tensors, never writes these)
            memo = self._replica_memo
            if memo is None or memo[0] is not delta_members \
                    or memo[1] is not s.replicas:
                memo = (delta_members, s.replicas,
                        torch.cat([delta_members, s.replicas], dim=-1))
                self._replica_memo = memo
            delta_members = memo[2]
        return cache.search(params, s.params, s.members, base,
                            self._queries(queries), delta_members,
                            s.tombstone, epoch=s.epoch, staged=staged)

    def exact_oracle(self, k: int, metric: str = "angular"):
        """A ``queries [n, d] -> exact ids [n, k]`` closure over the LIVE
        corpus: the audit's ground truth. Full probe over the fp32 buffer
        through ``core.query.exact_topk`` (one distance_topk launch on the
        card, no [n, L] table); each call reads ONE snapshot. Returns numpy
        int32, -1 where fewer than k live rows exist."""
        def oracle(queries):
            s = self._snapshot
            n = s.n_total
            ids = Q.exact_topk(self._queries(queries), s.vecs[:n],
                               s.tombstone[:n], k=k, metric=metric)
            return ids.cpu().numpy()
        return oracle

    def _record_state_gauges(self) -> None:
        """Refresh the streaming state gauges from the current snapshot
        (after every mutation, under ``_mu``): live count, epoch, mean
        delta-segment occupancy (fill / DL), tombstone ratio."""
        s = self._snapshot
        reg = self.registry
        dead = int(s.tombstone[:s.n_total].sum()) if s.n_total else 0
        DL = s.delta.members.shape[2]
        reg.gauge("stream_live").set(s.n_total - dead)
        reg.gauge("stream_epoch").set(s.epoch)
        reg.gauge("stream_delta_occupancy").set(
            float(s.delta.fill.to(torch.float32).mean()) / max(DL, 1))
        reg.gauge("stream_tombstone_ratio").set(dead / max(s.n_total, 1))

    # ----------------------------------------------------------- mutation --
    def insert(self, vecs) -> torch.Tensor:
        """Insert new items -> their global ids [n] int32 (on the index's
        device). Each item is placed, per rep, into the least loaded of its
        top-K buckets given the live loads, and is retrievable by the next
        search. Compacts when a segment would overflow; a batch too large
        for the empty segments is split, so placement order is kept at any
        batch size."""
        vecs = torch.as_tensor(vecs, dtype=torch.float32).to(self.device)
        if vecs.shape[0] == 0:
            return torch.empty((0,), dtype=torch.int32, device=self.device)
        with self._mu:
            if self._snapshot.n_total + vecs.shape[0] > self.capacity:
                raise ValueError(
                    f"capacity exceeded: {self._snapshot.n_total} + "
                    f"{vecs.shape[0]} > {self.capacity}")
            ids = self._insert_locked(vecs)
            self.registry.counter("stream_inserts_total").inc(len(ids))
            self._record_state_gauges()
            return ids

    def _insert_locked(self, vecs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dev = self.device
        n_new, d = vecs.shape
        # pad to the next power of two, as the reference does for its jit
        # (padding rows carry weight 0, so they move no load)
        n_pad = 1 << (n_new - 1).bit_length()
        vj = torch.cat([vecs, torch.zeros((n_pad - n_new, d),
                                          dtype=torch.float32, device=dev)])
        valid = torch.arange(n_pad, device=dev) < n_new
        for attempt in range(2):
            s = self._snapshot
            buckets = _score_and_place(
                s.params, s.load.to(torch.float32), vj, valid,
                B=cfg.n_buckets, K=cfg.K)[:, :n_new]              # [R, n]
            new_ids = torch.arange(s.n_total, s.n_total + n_new,
                                   dtype=torch.int32, device=dev)
            new_delta, ok = delta_append(s.delta, buckets, new_ids)
            if bool(ok):
                break
            if attempt == 0:
                self.compact()            # frees every delta segment
        else:
            if n_new == 1:
                raise RuntimeError(
                    "delta segments too small to hold a single insert — "
                    "increase delta_len")
            half = n_new // 2             # batch > empty-delta capacity
            return torch.cat([self._insert_locked(vecs[:half]),
                              self._insert_locked(vecs[half:])])
        rows = new_ids.long()
        dload = torch.zeros_like(s.load).scatter_add_(
            1, buckets.long(), torch.ones_like(buckets, dtype=torch.int32))
        assign = s.assign.clone()
        assign[:, rows] = buckets
        buf = s.vecs.clone()
        buf[rows] = vecs
        self._snapshot = dataclasses.replace(
            s, delta=new_delta, load=s.load + dload, assign=assign, vecs=buf,
            # quantize the inserted rows in the SAME swap: an item is never
            # searchable before its codes
            store=(s.store.append(new_ids, vecs)
                   if s.store is not None else None),
            n_total=s.n_total + n_new, epoch=s.epoch + 1)
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone ids (base or inserted) -> the number newly deleted.
        Deleted items stop appearing in results at once; their slots are
        reclaimed at the next compaction. Ids and vector slots are never
        reused, so ``capacity`` bounds lifetime inserts, not the live
        count. The load decrements are one scatter over every rep on the
        device."""
        ids = torch.unique(torch.as_tensor(ids).to(self.device).long())
        with self._mu:
            s = self._snapshot
            if ids.numel() and (int(ids.min()) < 0
                                or int(ids.max()) >= s.n_total):
                raise ValueError("delete: id out of range")
            live_ids = ids[~s.tombstone[ids]]
            n = int(live_ids.numel())
            if n == 0:
                return 0
            self.registry.counter("stream_deletes_total").inc(n)
            # decrement the live loads at each rep's bucket of the dying ids
            # (the sentinel B marks rows no member list carries: dropped)
            B, R = self.cfg.n_buckets, self.cfg.n_reps
            a = s.assign[:, live_ids].long()                    # [R, n]
            dec = torch.zeros((R, B + 1), dtype=torch.int32,
                              device=self.device)
            dec.scatter_add_(1, a, torch.ones_like(a, dtype=torch.int32))
            tomb = s.tombstone.clone()
            tomb[live_ids] = True
            self._snapshot = dataclasses.replace(
                s, tombstone=tomb, load=s.load - dec[:, :B],
                epoch=s.epoch + 1)
            self._record_state_gauges()
            return n

    def compact(self) -> None:
        """Fold delta segments + tombstones into a rebuilt base member
        matrix (one snapshot swap). Results are exactly preserved: each
        bucket's live member set, hence every candidate frequency and
        re-ranked id, is the same before and after."""
        with self._mu:
            with obs.trace(self.registry,
                           "stream_compaction_seconds") as sp:
                new = compaction.compact_snapshot(self._snapshot,
                                                  self.cfg.n_buckets)
                # fence the rebuilt tensors, so the span covers the device
                # rebuild
                sp.fence((new.members, new.load, new.delta.members))
                self._snapshot = new
            self.registry.counter("stream_compactions_total").inc()
            self._record_state_gauges()

    # ------------------------------------------------------------ refit swap --
    def _check_artifact(self, artifact) -> None:
        meta = artifact.meta_dict
        expect = {"d": self.cfg.d, "n_buckets": self.cfg.n_buckets,
                  "n_reps": self.cfg.n_reps, "capacity": self.capacity,
                  "loss": self.cfg.loss}
        for key, want in expect.items():
            if key in meta and meta[key] != want:
                raise ValueError(
                    f"install_artifact: config mismatch on {key}: artifact "
                    f"has {meta[key]!r}, this index has {want!r}")

    def install_artifact(self, artifact) -> None:
        """Zero-downtime swap: publish a refit artifact as the serving
        snapshot with one attribute store. Readers in flight finish on the
        old snapshot; the next batch reads the new one (``result.epoch`` ==
        artifact.version names which).

        The payload tiers (vecs, quantized codes) come from the CURRENT
        snapshot by reference: a refit never touches vector content, and
        rows inserted while it ran live only there. Those tail rows (ids >=
        artifact.n_total) are re-placed under the NEW scorer into fresh
        delta segments inside the same swap (:meth:`_place_tail`: one
        irli_topk and one kchoice launch on the card); deletes that
        post-date the artifact keep masking through the carried-over
        tombstone, and their load decrements are re-applied here. The card
        is synchronised before the pointer flip, so the swap's device work
        is done when readers see the new snapshot and
        ``stream_swap_seconds`` times it.

        Versions must advance: an artifact whose version does not exceed
        the current epoch is stale and is rejected."""
        cfg = self.cfg
        B, R = cfg.n_buckets, cfg.n_reps
        dev = self.device
        with self._mu:
            cur = self._snapshot
            self._check_artifact(artifact)
            if artifact.version <= cur.epoch:
                raise ValueError(
                    f"install_artifact: stale artifact version "
                    f"{artifact.version} <= serving epoch {cur.epoch}")
            t0 = time.perf_counter()
            assign = artifact.assign.to(dev)
            load = artifact.load.to(device=dev, dtype=torch.int32)
            n_fit = int(artifact.n_total)
            # deletes issued after the artifact was built: re-apply their
            # load decrements (the sentinel B marks rows no list carries)
            dead_new = cur.tombstone[:n_fit] & \
                ~artifact.tombstone[:n_fit].to(dev)
            if bool(dead_new.any()):
                a = assign[:, :n_fit][:, dead_new].long()          # [R, nd]
                dec = torch.zeros((R, B + 1), dtype=torch.int32, device=dev)
                dec.scatter_add_(1, a, torch.ones_like(a, dtype=torch.int32))
                load = load - dec[:, :B]
            snap = StreamSnapshot(
                params={k: v.to(dev) for k, v in artifact.params.items()},
                members=artifact.members.to(dev),
                delta=delta_init(*artifact.delta.members.shape, dev),
                tombstone=cur.tombstone,
                load=load, assign=assign, vecs=cur.vecs,
                n_total=cur.n_total, epoch=int(artifact.version),
                store=cur.store,
                replicas=(artifact.replicas.to(dev)
                          if artifact.replicas is not None else None))
            live_tail = torch.nonzero(
                ~cur.tombstone[n_fit:cur.n_total]).flatten() + n_fit
            if live_tail.numel():
                snap = self._place_tail(snap, live_tail.to(torch.int32))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)   # honest swap-pause timing
            self._snapshot = snap
            self.registry.histogram("stream_swap_seconds").observe(
                time.perf_counter() - t0)
            self.registry.counter("stream_swaps_total").inc()
            self.registry.gauge("artifact_version").set(artifact.version)
            self._record_state_gauges()

    def _place_tail(self, snap: StreamSnapshot, ids: torch.Tensor
                    ) -> StreamSnapshot:
        """Re-place live rows the artifact has never seen (inserted during
        the refit) under the artifact's NEW scorer: power-of-K against the
        new loads, appended to the fresh delta (``_score_and_place``: one
        irli_topk and one kchoice launch on the card). Falls back to an
        immediate compaction when the tail alone overflows a segment."""
        cfg = self.cfg
        dev = self.device
        n = int(ids.numel())
        n_pad = 1 << max(0, (n - 1).bit_length())
        rows = torch.cat([ids.long(), torch.zeros(n_pad - n,
                                                  dtype=torch.int64,
                                                  device=dev)])
        valid = torch.arange(n_pad, device=dev) < n
        buckets = _score_and_place(
            snap.params, snap.load.to(torch.float32), snap.vecs[rows], valid,
            B=cfg.n_buckets, K=cfg.K)[:, :n]                      # [R, n]
        new_delta, ok = delta_append(snap.delta, buckets, ids)
        dload = torch.zeros_like(snap.load).scatter_add_(
            1, buckets.long(), torch.ones_like(buckets, dtype=torch.int32))
        assign = snap.assign.clone()
        assign[:, ids.long()] = buckets
        snap = dataclasses.replace(snap, load=snap.load + dload,
                                   assign=assign)
        if bool(ok):
            return dataclasses.replace(snap, delta=new_delta)
        # assign already carries the tail: fold everything into the base
        # members (the epoch bumps past the artifact version: still
        # monotone)
        return compaction.compact_snapshot(snap, cfg.n_buckets)

    # ------------------------------------------------------- checkpointing --
    def state_dict(self, snapshot: StreamSnapshot | None = None) -> dict:
        """Tensors of the full mutable state, nested for CheckpointManager,
        in the reference's layout. Quantized-store codes and scales go
        alongside (bf16 codes widened to fp32, re-cast on restore)."""
        s = snapshot if snapshot is not None else self._snapshot
        stream = {
            "members": s.members, "delta_members": s.delta.members,
            "delta_fill": s.delta.fill, "tombstone": s.tombstone,
            "load": s.load, "assign": s.assign, "vecs": s.vecs,
        }
        stream.update(store_to_arrays(s.store))
        if s.replicas is not None:
            stream["replicas"] = s.replicas
        return {"scorer": s.params, "stream": stream}

    def meta(self, snapshot: StreamSnapshot | None = None) -> dict:
        s = snapshot if snapshot is not None else self._snapshot
        return {"n_total": s.n_total, "epoch": s.epoch,
                "capacity": self.capacity, "n_base": self.n_base,
                "n_buckets": self.cfg.n_buckets, "n_reps": self.cfg.n_reps,
                "d": self.cfg.d, "loss": self.cfg.loss,
                "store_dtype": (s.store.dtype if s.store is not None
                                else "fp32"),
                "store_block": (s.store.block if s.store is not None
                                else self.store_block)}

    def save(self, manager, step: int) -> None:
        """Checkpoint through ``checkpoint.checkpointer.CheckpointManager``
        (either package's). Captures the snapshot once, so arrays and meta
        cannot tear against a concurrent mutation."""
        s = self._snapshot
        manager.save(step, self.state_dict(s), extra=self.meta(s))

    def load_state(self, tree: dict, extra: dict) -> None:
        """Restore from a CheckpointManager.restore() result (either
        package's). Fails fast on any config mismatch: arrays shaped for
        another B/R/d would corrupt results silently."""
        expect = {"capacity": self.capacity, "n_buckets": self.cfg.n_buckets,
                  "n_reps": self.cfg.n_reps, "d": self.cfg.d,
                  "loss": self.cfg.loss, "store_dtype": self.store_dtype}
        for key, want in expect.items():
            if key in extra and extra[key] != want:
                raise ValueError(
                    f"checkpoint config mismatch: {key}={extra[key]!r}, "
                    f"this index has {want!r}")
        if "store_codes" not in tree["stream"] and self.store_dtype != "fp32":
            raise ValueError(
                "checkpoint has no quantized store but this index was "
                f"built with store_dtype={self.store_dtype!r}")
        extra = {"store_dtype": self.store_dtype,
                 "store_block": self.store_block, **extra}
        snap = snapshot_from_arrays(tree, extra, self.device)
        with self._mu:
            self._snapshot = snap
