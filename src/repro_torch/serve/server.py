"""Batched query serving for the IRLI index: admission queue + micro-batcher,
with online mutation admission for the streaming mutable index. Port of
``repro/serve/server.py``.

The paper reports per-point latencies at batch sizes 1-10k (Figs. 5-6); real
deployments amortize the R-net forward over a micro-batch. This server:
  - speaks the typed API (core/search_api): a default ``SearchParams`` at
    construction, overridable PER REQUEST (``submit(q, params)``); futures
    resolve to a per-request ``SearchResult``
  - collects requests up to ``max_batch`` or ``max_wait_ms``, grouping by
    params: same-params requests batch together, a differing-params request
    closes the current group and starts the next (arrival order preserved).
    ``SearchParams.store_dtype`` rides along like every other knob: a server
    over a quantized-store index (or with ``base`` given as a
    QuantizedStore) serves the tiered coarse+refine rerank, and fp32 vs
    int8 requests simply land in different param groups (docs/store.md)
  - pads each group to a bucket size (ladder derived from ``max_batch``, so
    a full batch never pads past itself) — one pipeline entry per
    (params, bucket), built once and reused via this server's
    ``PipelineCache`` (hit/miss/compile counters in ``stats["cache"]``)
  - on the card, stacks and pads a batch's host queries on the host and
    moves them to the device ONCE (queries sent as tensors on the card are
    stacked there); the same tensor feeds the probe counter and the search, and the batch's results (ids, scores, survivor counts and
    the probed cells) come back to the host in ONE copy. Futures resolve
    to a ``SearchResult`` of numpy rows, as in the reference
  - admits ``insert``/``delete`` mutations through the SAME queue, so
    updates are serialized with queries in arrival order: a mutation acts as
    a batch barrier (the in-flight query batch is served against the old
    snapshot, then the mutation is applied and the snapshot epoch advances).
    Requires the wrapped index to be a stream.MutableIRLIIndex.
  - fails all still-pending futures on close() instead of leaving callers
    blocked forever.

The old ``IRLIServer(index, m=, tau=, k=, metric=, mode=, topC=)``
constructor kwargs are a deprecated shim; a server built with EXPLICIT
legacy kwargs keeps the old future payloads (bare top-k id rows) for
bit-compatibility. A server built with no search knobs at all
(``IRLIServer(idx, base=...)``) is typed: it serves ``SearchParams()``
defaults and its futures resolve to ``SearchResult`` — callers that
unpacked bare id rows must read ``result.ids``.

Kernels launch from the batcher thread, on the current stream of the
index's device (the wrappers' ``card_scope``), so a snapshot flip by
another thread is ordered after its own synchronise.
"""
from __future__ import annotations

import inspect
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import query as Q
from repro_torch.core import search_api as SA
from repro_torch.core.search_api import (PipelineCache, SearchParams,
                                         SearchResult)
from repro_torch.obs.qlog import host
from repro_torch.store.quantized import QuantizedStore


def _fulfill(fut: Future, value) -> None:
    """set_result that tolerates a concurrently cancelled/completed future
    (client cancel() or the close() drain can race any completion)."""
    try:
        if not fut.done():
            fut.set_result(value)
    except InvalidStateError:
        pass


def _fail(fut: Future, exc: BaseException) -> None:
    try:
        if not fut.done():
            fut.set_exception(exc)
    except InvalidStateError:
        pass


def _to_host(res: SearchResult, cells):
    """(ids, scores, n_candidates, probed cells or None) of a batch as
    numpy, in ONE device-to-host copy when they are tensors: the four are
    packed as 32-bit words into one flat tensor, copied, and split."""
    parts = (res.ids, res.scores, res.n_candidates, cells)
    if not all(isinstance(t, torch.Tensor) for t in parts[:3]):
        return tuple(None if t is None else host(t) for t in parts)
    dtypes = (torch.int32, torch.float32, torch.int32, torch.int32)
    words = [t.to(dt).contiguous().view(torch.float32).reshape(-1)
             for t, dt in zip(parts, dtypes) if t is not None]
    flat = torch.cat(words).cpu().numpy()
    out, at = [], 0
    for t, dtype in zip(parts, (np.int32, np.float32, np.int32, np.int32)):
        if t is None:
            out.append(None)
            continue
        size = t.numel()
        out.append(flat[at:at + size].view(dtype).reshape(tuple(t.shape)))
        at += size
    return tuple(out)


def _bucket_ladder(max_batch: int) -> tuple:
    """Pad-bucket sizes clamped to max_batch: 1, 8, 32, 128, 512, ... but
    never past the largest batch the collector can form — with max_batch=64
    a full 64-request batch pads to 64, not 128 (pad_waste would otherwise
    double)."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b = 8 if b == 1 else b * 4
    out.append(max_batch)
    return tuple(out)


class IRLIServer:
    def __init__(self, index, *, params: SearchParams | None = None,
                 max_batch: int = 512, max_wait_ms: float = 2.0,
                 base=None, cache: PipelineCache | None = None,
                 registry: "obs.MetricRegistry | None" = None,
                 staged: bool = False, probe_stats: bool = True,
                 qlog: "obs.QueryLog | None" = None,
                 auditor=None, drift=None,
                 m=None, tau=None, k=None, metric=None, mode=None, topC=None):
        legacy = (params is None
                  and any(v is not None
                          for v in (m, tau, k, metric, mode, topC)))
        if legacy:
            params = SA.params_from_legacy_kwargs(
                "IRLIServer", m=m, tau=tau, k=k, metric=metric, mode=mode,
                topC=topC)
        elif params is None:
            params = SearchParams()
        elif any(v is not None for v in (m, tau, k, metric, mode, topC)):
            raise TypeError("pass either SearchParams or legacy kwargs, "
                            "not both")
        else:
            SA.check_params("IRLIServer", params)
        self.index = index
        # where a batch's queries go: the index's device (a backend with
        # none takes CPU tensors)
        self.device = getattr(index, "device", torch.device("cpu"))
        self.default_params = params
        # legacy-constructed servers keep the old future payload (a bare
        # [k] id row); typed servers resolve futures to SearchResult
        self._legacy_results = legacy
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        if base is not None and not isinstance(base, QuantizedStore):
            # a raw corpus goes to the index's device once, not per batch
            base = torch.as_tensor(host(base, np.float32)
                                   if not isinstance(base, torch.Tensor)
                                   else base, dtype=torch.float32
                                   ).to(self.device)
        self.base = base
        self.buckets = _bucket_ladder(max_batch)
        # per-server registry by default: two servers must not mix their
        # request counters (pass one explicitly to aggregate deliberately)
        self.registry = (registry if registry is not None
                         else obs.MetricRegistry())
        self.staged = staged
        self.cache = (cache if cache is not None
                      else PipelineCache(registry=self.registry))
        # mutable (stream.MutableIRLIIndex) indexes carry their own vector
        # buffer and mutation API; frozen IRLIIndex needs ``base`` to rerank
        self._mutable = hasattr(index, "insert") and hasattr(index, "delete")
        self._searcher = self._bind_searcher()
        self._probe = self._bind_probe() if probe_stats else None
        # sampled query stream for the online refit loop (docs/online.md):
        # every served batch logs (query, result ids) pairs the
        # OnlineRefitLoop later drains as incremental training data
        self.qlog = qlog
        # quality hooks (docs/quality.md) — both are hot-path cheap: the
        # auditor's observe is a sampled ring write (the exact oracle runs
        # on ITS background cadence, proven off the hot path by the
        # query.audit_oracle_off_hot_path contract), the drift recorder one
        # matmul + bincount over the batch
        self.auditor = auditor
        self.drift = drift
        self.q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.registry.gauge("serve_epoch").set(getattr(index, "epoch", 0))
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _bind_searcher(self):
        """One callable ``(queries, params) -> SearchResult`` for whatever
        backend this server wraps: a MutableIRLIIndex or any one-arg
        ``Searcher`` takes (queries, params); a frozen IRLIIndex needs
        ``base`` threaded in. None means the mask-only fallback
        (``index.query``) for a frozen index given no corpus. A backend
        whose ``search`` accepts a ``cache`` kwarg shares this server's
        PipelineCache, so ``stats["cache"]`` reflects its compilations."""
        search = getattr(self.index, "search", None)
        if search is None:
            return None
        sig = inspect.signature(search).parameters
        ckw = {"cache": self.cache} if "cache" in sig else {}
        if self.staged:
            if "staged" not in sig:
                raise TypeError(
                    "staged=True needs a backend whose search() takes a "
                    f"staged kwarg; {type(self.index).__name__}.search "
                    "does not")
            ckw["staged"] = True
        if not self._mutable and self.base is not None:
            return lambda qs, p: search(qs, self.base, p, **ckw)
        if self._mutable or not hasattr(self.index, "query"):
            return lambda qs, p: search(qs, p, **ckw)
        return None     # frozen index, no corpus: candidate-mask fallback

    def _bind_probe(self):
        """Per-bucket probe-frequency observability (the LIRA access-stats
        prerequisite): find the scorer params + (R, B) geometry on the
        wrapped index — frozen IRLIIndex directly, MutableIRLIIndex via its
        inner ``.index`` — and a flat [R·B] VectorCounter to count into.
        Returns None (disabled) when the backend exposes neither."""
        for src in (self.index, getattr(self.index, "index", None)):
            cfg = getattr(src, "cfg", None)
            if (cfg is not None and hasattr(src, "params")
                    and hasattr(cfg, "n_reps") and hasattr(cfg, "n_buckets")):
                R, B = int(cfg.n_reps), int(cfg.n_buckets)
                return src, R, B, self.registry.vector("serve_bucket_probes",
                                                       R * B)
        return None

    def _record_probes(self, queries: torch.Tensor, n: int,
                       m: int) -> torch.Tensor:
        """The (rep, bucket) cells this batch probed, flat [R·n·m] int32
        on the queries' device: the probe head only (one irli_topk launch
        on the card), pad rows sliced off so padding never inflates a
        bucket's load. :meth:`_run_batch` brings them back with the
        batch's results and counts them into ``serve_bucket_probes``."""
        src, R, B, _ = self._probe
        bidx = Q.probe_buckets(src.params, queries, m)[:, :n, :]
        rep = torch.arange(R, dtype=torch.int32, device=bidx.device)
        return (rep[:, None, None] * B + bidx).reshape(-1)

    @property
    def stats(self) -> dict:
        """Counters snapshot, including the pipeline-cache hit/miss/compile
        counts (per-request params must not mean per-request compiles).

        A VIEW over ``self.registry`` (the counters live there now — the
        old ``_stats`` dict was mutated from the batcher thread without a
        lock) kept in the legacy dict shape; the full picture is
        ``self.registry.snapshot()``."""
        reg = self.registry
        return {
            "batches": int(reg.counter("serve_batches_total").value),
            "requests": int(reg.counter("serve_requests_total").value),
            "pad_waste": int(reg.counter("serve_pad_waste_total").value),
            "param_groups": int(
                reg.counter("serve_param_groups_total").value),
            "mutations": int(reg.counter("serve_mutations_total").value),
            "epoch": int(reg.gauge("serve_epoch").value),
            "cache": self.cache.stats(),
        }

    # ------------------------------------------------------------- client --
    def _enqueue(self, op: str, payload) -> Future:
        fut: Future = Future()
        if self._stop.is_set():   # closed: fail fast instead of hanging
            fut.set_exception(RuntimeError("IRLIServer is closed"))
            return fut
        self.q.put((op, payload, fut, time.perf_counter()))
        # close() may have set _stop and drained BETWEEN the check above and
        # the put — then nobody will ever pop this item, so fail it here
        # (this path, the drain, and the batcher all use the race-safe
        # _fulfill/_fail helpers).
        if self._stop.is_set():
            _fail(fut, RuntimeError("IRLIServer is closed"))
        return fut

    def submit(self, query: np.ndarray,
               params: SearchParams | None = None) -> Future:
        """Enqueue one query; ``params`` overrides the server default for
        THIS request (it will batch with equal-params neighbors)."""
        if params is not None:
            SA.check_params("IRLIServer.submit", params)
        return self._enqueue(
            "query", (query, params if params is not None
                      else self.default_params))

    def search(self, query: np.ndarray, params: SearchParams | None = None,
               *, timeout: float | None = None):
        """Blocking submit; ``timeout`` (seconds) forwards to
        ``Future.result`` — a stuck batcher raises TimeoutError instead of
        hanging the caller forever."""
        return self.submit(query, params).result(timeout)

    def insert(self, vecs: np.ndarray) -> Future:
        """Enqueue an insert; the future resolves to the assigned ids."""
        return self._enqueue("insert", vecs)

    def delete(self, ids) -> Future:
        """Enqueue a delete; the future resolves to #newly deleted."""
        return self._enqueue("delete", ids)

    # ------------------------------------------------------------- server --
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def _apply_mutation(self, op: str, payload, fut: Future):
        try:
            if not self._mutable:
                raise TypeError(
                    f"{op} requires a MutableIRLIIndex; this server wraps a "
                    "frozen index")
            res = (self.index.insert(payload) if op == "insert"
                   else self.index.delete(payload))
            self.registry.counter("serve_mutations_total").inc()
            self.registry.gauge("serve_epoch").set(self.index.epoch)
            _fulfill(fut, res)                      # caller may have cancelled
        except Exception as e:                      # surface to the caller
            _fail(fut, e)

    def _stack(self, batch, nb: int):
        """The batch's queries stacked and padded to ``nb`` rows (the last
        row repeated) -> (fp32 tensor on the index's device, host rows or
        None). Rows that are tensors on one device are stacked there;
        others are stacked on the host and moved to the device in one
        copy."""
        rows = [b[0] for b in batch]
        if all(isinstance(r, torch.Tensor) and r.device == rows[0].device
               for r in rows):
            qdev = torch.stack(rows).to(self.device, torch.float32)
            if nb > len(rows):  # pad to bucket -> one cache entry a bucket
                qdev = torch.cat(
                    [qdev, qdev[-1:].expand(nb - len(rows), -1)])
            return qdev, None
        queries = np.stack([host(r, np.float32) for r in rows])
        if nb > len(rows):
            queries = np.concatenate(
                [queries, np.repeat(queries[-1:], nb - len(rows), 0)])
        return torch.from_numpy(queries).to(self.device), queries

    def _run_batch(self, batch, params: SearchParams):
        n = len(batch)
        nb = self._bucket(n)
        reg = self.registry
        t0 = time.perf_counter()
        try:
            # stack/pad inside the try: one malformed query (wrong shape)
            # must fail ITS batch, not kill the batcher thread
            qdev, queries = self._stack(batch, nb)
            if self._searcher is not None:
                cells = (self._record_probes(qdev, n, params.m)
                         if self._probe is not None else None)
                res: SearchResult = self._searcher(qdev, params)
                ids, scores, n_cand, cells = _to_host(res, cells)
                if cells is not None:
                    self._probe[3].inc_at(cells)
                reg.histogram("serve_candidates",
                              bounds=obs.COUNT_BUCKETS).observe_many(
                                  n_cand[:n])
                # serve seconds for THIS batch, synchronized by the copy
                # to the host above; logged per entry so the shadow
                # auditor can audit latency from the sampled stream
                dt = time.perf_counter() - t0
                if queries is None and any(
                        h is not None
                        for h in (self.qlog, self.auditor, self.drift)):
                    queries = host(qdev[:n])   # rows sent from the card
                if self.qlog is not None:   # pad rows sliced off first
                    self.qlog.record(queries[:n], ids[:n],
                                     epoch=int(res.epoch), latencies=dt)
                if self.auditor is not None:
                    self.auditor.observe(queries[:n], ids[:n],
                                         epoch=int(res.epoch), latency_s=dt)
                if self.drift is not None:
                    self.drift.record(queries[:n])
                if self._legacy_results:
                    out = [ids[i] for i in range(n)]
                else:
                    out = [SearchResult(ids=ids[i], scores=scores[i],
                                        n_candidates=int(n_cand[i]),
                                        epoch=res.epoch, mode=res.mode)
                           for i in range(n)]
            else:
                mask, freq, _ = self.index.query(qdev, m=params.m,
                                                 tau=params.tau)
                out = list(host(mask)[:n])
        except Exception as e:
            for _, fut in batch:
                _fail(fut, e)
            return
        # the copy to the host above already synchronized, so this
        # duration covers launch + compute, not just the launch
        reg.histogram("serve_batch_seconds").observe(time.perf_counter() - t0)
        reg.histogram("serve_batch_fill",
                      bounds=obs.COUNT_BUCKETS).observe(n)
        reg.counter("serve_batches_total").inc()
        reg.counter("serve_requests_total").inc(n)
        reg.counter("serve_pad_waste_total").inc(nb - n)
        for i, (_, fut) in enumerate(batch):
            _fulfill(fut, out[i])                   # cancelled while queued


    def _loop(self):
        pending = None   # barrier popped mid-collection: a mutation, or a
        #                  query whose params differ from the open group
        while not self._stop.is_set():
            # queue wait = enqueue -> first pop by the batcher (a parked
            # barrier item is observed at its ORIGINAL pop below, never
            # again when taken up here)
            wait_hist = self.registry.histogram("serve_queue_wait_seconds")
            if pending is not None:
                item, pending = pending, None
            else:
                try:
                    item = self.q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if len(item) > 3:   # tolerate raw 3-tuples (tests, clients)
                    wait_hist.observe(time.perf_counter() - item[3])
            op, payload, fut = item[:3]
            if op != "query":
                self._apply_mutation(op, payload, fut)
                continue
            group_params = payload[1]
            batch = [(payload[0], fut)]
            deadline = time.time() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=timeout)
                except queue.Empty:
                    break
                if len(nxt) > 3:
                    wait_hist.observe(time.perf_counter() - nxt[3])
                if nxt[0] != "query" or nxt[1][1] != group_params:
                    pending = nxt        # barrier: serve this group first
                    break
                batch.append((nxt[1][0], nxt[2]))
            self.registry.counter("serve_param_groups_total").inc()
            self._run_batch(batch, group_params)
        # loop exited with an item parked: fail it directly — re-queueing
        # would race with close()'s drain (which may already have finished)
        if pending is not None:
            _fail(pending[2],
                  RuntimeError("IRLIServer closed before this request "
                               "was served"))

    def close(self):
        """Stop the batcher and FAIL every still-queued request — callers
        blocked on a future get an immediate error instead of hanging."""
        self._stop.set()
        # the batcher may be mid-batch; draining while it still runs would
        # race completions, so wait until it has actually exited (daemon
        # thread — a stuck batch still finishes or dies with us)
        while self.thread.is_alive():
            self.thread.join(timeout=5)
        while True:
            try:
                fut = self.q.get_nowait()[2]
            except queue.Empty:
                break
            if fut is not None:
                _fail(fut, RuntimeError("IRLIServer closed before this "
                                        "request was served"))
