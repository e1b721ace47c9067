"""The port's serving stack against the JAX package's, on the CPU: the
staged search, fit(registry=), IRLIServer (batching, the probe counter,
mutation barriers, close) and the serve launcher.

A small JAX index is fitted once and carried across with
repro_torch.convert; both packages serve the same numpy requests. Ids and
n_candidates must be equal, scores within 1e-5 + 1e-5·|b|.
"""
import io
import threading
import time
from concurrent.futures import Future
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as JO  # noqa: E402
from repro.core import query as JQ  # noqa: E402
from repro.core.index import IRLIConfig, IRLIIndex  # noqa: E402
from repro.core.search_api import SearchParams as JParams  # noqa: E402
from repro.data.synthetic import _topk_l2, clustered_ann  # noqa: E402
from repro.serve import server as JS  # noqa: E402
from repro.store.quantized import encode as jencode  # noqa: E402
from repro.stream import MutableIRLIIndex as JMutable  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.core import query as TQ  # noqa: E402
from repro_torch.core.index import IRLIIndex as TIndex  # noqa: E402
from repro_torch.core.search_api import SearchParams  # noqa: E402
from repro_torch.serve import server as TS  # noqa: E402
from repro_torch.store.quantized import encode  # noqa: E402
from repro_torch.stream import MutableIRLIIndex  # noqa: E402

D, N, M_PROBE, K_TOP = 16, 900, 4, 10
STAGES = {"compact": {"scorer_logits", "top_m", "gather", "freq_topc"},
          "dense": {"scorer_logits", "top_m", "gather", "freq_dense",
                    "rerank"},
          "mega": {"mega"}}


@pytest.fixture(scope="module")
def data():
    return clustered_ann(n_base=N + 100, n_queries=48, d=D, n_clusters=30,
                         seed=0)


@pytest.fixture(scope="module")
def fitted(data):
    base = data.base[:N]
    gt = _topk_l2(base, base, k=10, metric="angular")
    cfg = IRLIConfig(d=D, n_labels=N, n_buckets=32, n_reps=2, d_hidden=32,
                     K=M_PROBE, rounds=1, epochs_per_round=2,
                     batch_size=256, seed=0)
    jidx = IRLIIndex(cfg)
    jidx.fit(base, gt, label_vecs=base)
    tidx, _ = convert.from_reference(
        cfg, params={k: np.asarray(v) for k, v in jidx.params.items()},
        assign=np.asarray(jidx.assign),
        members=np.asarray(jidx.index.members), device="cpu")
    return jidx, tidx


def _same(jres, tres, ids_of=lambda r: r.ids):
    np.testing.assert_array_equal(np.asarray(ids_of(tres)),
                                  np.asarray(ids_of(jres)))
    np.testing.assert_allclose(np.asarray(tres.scores),
                               np.asarray(jres.scores), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------- staged search --
@pytest.mark.parametrize("mode,store,metric", [
    ("compact", "fp32", "angular"), ("compact", "fp32", "l2"),
    ("compact", "int8", "angular"), ("compact", "int8", "l2"),
    ("compact", "bf16", "l2"), ("dense", "fp32", "angular"),
    ("dense", "fp32", "l2"), ("mega", "fp32", "angular"),
    ("mega", "int8", "l2")])
def test_staged_is_bit_identical_with_the_reference_labels(
        fitted, data, mode, store, metric):
    """The staged search returns the unstaged search's exact tensors (on
    the CPU "mega" is the compact sequence, its plain version), records the
    reference's stage labels, and agrees with the reference's staged
    search."""
    jidx, tidx = fitted
    base = data.base[:N]
    tbase, jbase = torch.from_numpy(base), base
    if store != "fp32":
        tbase = encode(tbase, store, 8, keep_exact=store == "int8")
        jbase = jencode(jax.numpy.asarray(base), dtype=store, block=8,
                        keep_exact=store == "int8")
    q = torch.from_numpy(data.queries)
    pipe = TQ.QueryPipeline(mode=mode, m=M_PROBE, tau=1, k=K_TOP, topC=128,
                            metric=metric, store_dtype=store)
    treg, jreg = TO.MetricRegistry(), JO.MetricRegistry()
    plain = pipe.search(tidx.params, tidx.index.members, tbase, q)
    staged = pipe.search_staged(tidx.params, tidx.index.members, tbase, q,
                                registry=treg)
    for a, b in zip(plain, staged):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jpipe = JQ.QueryPipeline(mode=mode, m=M_PROBE, tau=1, k=K_TOP,
                             topC=128, metric=metric, store_dtype=store)
    jout = jpipe.search_staged(jidx.params, jidx.index.members, jbase,
                               jax.numpy.asarray(data.queries),
                               registry=jreg)
    np.testing.assert_array_equal(staged[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(staged[1].numpy(), np.asarray(jout[1]),
                               rtol=1e-5, atol=1e-5)
    labels = {k for k in treg.snapshot()
              if k.startswith("serve_stage_seconds")}
    assert labels == {k for k in jreg.snapshot()
                      if k.startswith("serve_stage_seconds")}
    names = {k.split('"')[1] for k in labels}
    assert STAGES[mode] <= names
    if mode == "mega":
        assert treg.counter("serve_mega_dispatch_total").value == 1


def test_staged_streaming_search_matches_unstaged(fitted, data):
    """Through MutableIRLIIndex.search with delta and tombstone state."""
    _, tidx = fitted
    tm = MutableIRLIIndex(tidx, data.base[:N], store_dtype="int8")
    tm.insert(data.base[N:])
    tm.delete(np.arange(0, N, 7))
    sp = SearchParams(m=M_PROBE, tau=1, k=K_TOP, mode="compact",
                      store_dtype="int8")
    a = tm.search(data.queries, sp)
    b = tm.search(data.queries, sp, staged=True)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    assert not np.isin(b.ids.numpy(), np.arange(0, N, 7)).any()


# ------------------------------------------------------- fit(registry=) --
def test_fit_registry_gauges_are_the_references():
    """The same fit_* names and counters as the reference's fit; the values
    to the whole fit's tolerances (same initial weights, own random
    streams), and exactly equal when both record the same round."""
    rng = np.random.default_rng(0)
    L = 256
    cfg = IRLIConfig(d=D, n_labels=L, n_buckets=16, n_reps=2, d_hidden=32,
                     K=M_PROBE, rounds=2, epochs_per_round=1, batch_size=64,
                     seed=0)
    x = rng.normal(size=(128, D)).astype(np.float32)
    gt = rng.integers(0, L, (128, 4)).astype(np.int32)
    jidx = IRLIIndex(cfg)
    tidx, _ = convert.from_reference(
        cfg, params={k: np.asarray(v) for k, v in jidx.params.items()},
        assign=np.asarray(jidx.assign), device="cpu")
    jreg, treg = JO.MetricRegistry(), TO.MetricRegistry()
    jidx.fit(x, gt, registry=jreg)
    tidx.fit(x, gt, registry=treg)
    js, ts = jreg.snapshot(), treg.snapshot()
    assert sorted(ts) == sorted(js)
    assert ts["fit_rounds_total"] == js["fit_rounds_total"]
    for key in ("fit_loss", "fit_load_std"):
        assert ts[key]["value"] == pytest.approx(js[key]["value"], rel=0.1)
    assert 0.0 <= ts["fit_churn"]["value"] <= 1.0
    met = {"loss": 0.5, "n_reassigned": 12, "load_std": 1.25,
           "grad_norm": 0.75, "load_min": 3.0, "load_max": 40.0,
           "load_kl": 0.125}
    jreg, treg = JO.MetricRegistry(), TO.MetricRegistry()
    rows = (jidx._record_fit_round(0, met, 0.5, jreg),
            TIndex._record_fit_round(tidx, 0, met, 0.5, treg))
    assert rows[0] == rows[1] and jreg.snapshot() == treg.snapshot()


# ----------------------------------------------------------------- server --
@pytest.mark.parametrize("max_batch", [1, 7, 64, 512, 1000])
def test_bucket_ladder_is_the_references(max_batch):
    assert TS._bucket_ladder(max_batch) == JS._bucket_ladder(max_batch)


def _parked(server):
    """Stop the batcher so requests queue up; :func:`_release` restarts it
    over the whole queue, so batches form the same way in both packages."""
    server._stop.set()
    server.thread.join(timeout=10)
    assert not server.thread.is_alive()


def _release(server):
    server._stop.clear()
    server.thread = threading.Thread(target=server._loop, daemon=True)
    server.thread.start()


def _put(server, op, payload):
    fut = Future()
    server.q.put((op, payload, fut, time.perf_counter()))
    return fut


def test_server_matches_the_reference_server(fitted, data):
    """Both servers over the same carried index and the same queued
    requests (full groups of the default, then a wider override): equal
    results row by row, equal stats, equal serve_bucket_probes (pads
    excluded)."""
    jidx, tidx = fitted
    base = data.base[:N]
    sp = dict(m=M_PROBE, tau=1, k=K_TOP, mode="compact")
    jp, tp = JParams(**sp), SearchParams(**sp)
    jw, tw = jp.replace(m=M_PROBE + 2), tp.replace(m=M_PROBE + 2)
    js = JS.IRLIServer(jidx, params=jp, base=base, max_batch=8,
                       max_wait_ms=200.0)
    ts = TS.IRLIServer(tidx, params=tp, base=base, max_batch=8,
                       max_wait_ms=200.0)
    try:
        futs = []
        for srv, p, w in ((js, jp, jw), (ts, tp, tw)):
            _parked(srv)
            futs.append([_put(srv, "query", (q, w if i >= 40 else p))
                         for i, q in enumerate(data.queries[:45])])
            _release(srv)
        jr = [f.result(timeout=120) for f in futs[0]]
        tr = [f.result(timeout=120) for f in futs[1]]
    finally:
        js.close()
        ts.close()
    for a, b in zip(jr, tr):
        assert isinstance(b.ids, np.ndarray) and b.ids.dtype == np.int32
        _same(a, b)
        assert int(a.n_candidates) == b.n_candidates and a.epoch == b.epoch
        assert a.mode == b.mode
    assert ts.stats == js.stats
    assert ts.stats["batches"] == 6 and ts.stats["pad_waste"] == 3
    jv = js.registry.snapshot()["serve_bucket_probes"]
    tv = ts.registry.snapshot()["serve_bucket_probes"]
    assert tv == jv
    assert tv["sum"] == 2 * (40 * M_PROBE + 5 * (M_PROBE + 2))


def test_server_legacy_kwargs_return_bare_rows(fitted, data):
    _, tidx = fitted
    with pytest.warns(DeprecationWarning, match="SearchParams"):
        srv = TS.IRLIServer(tidx, base=data.base[:N], m=M_PROBE, k=5,
                            mode="compact", max_wait_ms=1.0)
    try:
        row = srv.search(data.queries[0], timeout=60)
        typed = tidx.search(data.queries[:1], data.base[:N],
                            SearchParams(m=M_PROBE, k=5, mode="compact"))
        np.testing.assert_array_equal(row, typed.ids[0].numpy())
        with pytest.raises(TypeError, match="either SearchParams"):
            TS.IRLIServer(tidx, params=SearchParams(), m=3)
        with pytest.raises(TypeError, match="SearchParams"):
            srv.submit(data.queries[0], params={"m": 3})
    finally:
        srv.close()


def test_mutation_barriers_keep_epoch_order(fitted, data):
    """Queries, inserts and deletes through one queue in both packages: a
    query sees every mutation that arrived before it and none after, so
    its epoch is the index's epoch after the last earlier mutation, and the
    epochs, inserted ids and served rows equal the reference's."""
    jidx, tidx = fitted
    sp = dict(m=M_PROBE, tau=1, k=K_TOP, mode="compact")
    jm = JMutable(jidx, data.base[:N])
    tm = MutableIRLIIndex(tidx, data.base[:N])
    outs = []
    for mod, idx, p in ((JS, jm, JParams(**sp)), (TS, tm,
                                                  SearchParams(**sp))):
        srv = mod.IRLIServer(idx, params=p, max_batch=4, max_wait_ms=50.0)
        try:
            _parked(srv)
            q = data.queries
            plan = [("query", (q[0], p)), ("query", (q[1], p)),
                    ("insert", data.base[N:N + 40]), ("query", (q[2], p)),
                    ("delete", np.arange(0, 50)), ("query", (q[3], p)),
                    ("query", (q[4], p)), ("insert", data.base[N + 40:])]
            futs = [_put(srv, op, pl) for op, pl in plan]
            _release(srv)
            got = [f.result(timeout=120) for f in futs]
        finally:
            srv.close()
        outs.append(got)
        assert srv.stats["mutations"] == 3 and srv.stats["epoch"] == 3
    jr, tr = outs
    assert [r.epoch for r in tr[:2]] == [0, 0]
    assert tr[3].epoch == 1 and tr[5].epoch == tr[6].epoch == 2
    for i in (0, 1, 3, 5, 6):
        _same(jr[i], tr[i])
        assert jr[i].epoch == tr[i].epoch
    assert isinstance(tr[2], torch.Tensor)         # the port's insert ids
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
    assert tr[4] == jr[4] == 50
    assert not np.isin(tr[5].ids, np.arange(50)).any()


def test_close_fails_pending_futures():
    class _NeverIndex:
        def query(self, *a, **kw):
            raise AssertionError("should not be called")

    server = TS.IRLIServer(_NeverIndex(), max_wait_ms=1.0)
    _parked(server)
    futs = [_put(server, "query", (np.zeros(4, np.float32), None))
            for _ in range(3)]
    futs.append(_put(server, "insert", np.zeros((1, 4), np.float32)))
    server.close()
    for f in futs:
        with pytest.raises(RuntimeError, match="closed"):
            f.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(np.zeros(4, np.float32)).result(timeout=5)


def test_server_quality_hooks_and_frozen_mutation_refusal(fitted, data):
    """qlog=, auditor= and drift= see each served batch's real rows (pads
    sliced off) with its epoch and latency; a frozen index refuses
    mutations through the future."""
    _, tidx = fitted
    reg = TO.MetricRegistry()
    qlog = TO.QueryLog(capacity=64, seed=0)
    oracle = TQ.exact_topk
    base_t = torch.from_numpy(data.base[:N])
    aud = TO.ShadowAuditor(
        lambda q: oracle(torch.as_tensor(q), base_t,
                         torch.zeros(N, dtype=torch.bool), k=K_TOP),
        sample=1.0, registry=reg)
    drift = TO.DriftDetector(TO.QuerySketch(D, 4, 0), registry=reg)
    srv = TS.IRLIServer(tidx, params=SearchParams(m=M_PROBE, k=K_TOP,
                                                  mode="compact"),
                        base=data.base[:N], max_batch=8, registry=reg,
                        qlog=qlog, auditor=aud, drift=drift)
    try:
        res = [srv.submit(q).result(timeout=60) for q in data.queries[:5]]
        with pytest.raises(TypeError, match="MutableIRLIIndex"):
            srv.insert(data.base[:2]).result(timeout=60)
    finally:
        srv.close()
    w = qlog.drain()
    assert len(w) == 5 and np.isfinite(w.latency).all()
    np.testing.assert_array_equal(w.x, data.queries[:5])
    np.testing.assert_array_equal(w.ids, np.stack([r.ids for r in res]))
    audit = aud.run_audit()
    assert audit["n_audited"] == 5 and 0.0 <= audit["live_recall"] <= 1.0
    assert drift._live.sum() == 5


def test_server_stacks_tensor_queries_where_they_lie(fitted, data):
    """Queries sent as tensors are stacked and padded on their own device
    (no copy a row): the same rows served as numpy rows give the same
    results, and the query log records the same rows."""
    _, tidx = fitted
    out = {}
    for sent in ("numpy", "tensor"):
        qlog = TO.QueryLog(capacity=64, seed=0)
        srv = TS.IRLIServer(tidx, params=SearchParams(m=M_PROBE, k=K_TOP,
                                                      mode="compact"),
                            base=data.base[:N], max_batch=8,
                            max_wait_ms=200.0, qlog=qlog)
        try:
            _parked(srv)
            rows = (data.queries[:7] if sent == "numpy"
                    else torch.from_numpy(data.queries[:7]))
            futs = [_put(srv, "query", (q, srv.default_params))
                    for q in rows]
            _release(srv)
            res = [f.result(timeout=60) for f in futs]
        finally:
            srv.close()
        assert srv.stats["batches"] == 1 and srv.stats["pad_waste"] == 1
        out[sent] = (res, qlog.drain())
    (a, wa), (b, wb) = out["numpy"], out["tensor"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.ids, y.ids)
        np.testing.assert_array_equal(x.scores, y.scores)
    np.testing.assert_array_equal(wb.x, data.queries[:7])
    np.testing.assert_array_equal(wa.ids, wb.ids)


def test_launch_serve_main_runs_on_the_cpu():
    from repro_torch.launch import serve
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main(["--requests", "24", "--base", "300", "--rounds", "1",
                    "--device", "cpu", "--audit-sample", "0.5",
                    "--slo-p99-ms", "1000", "--staged"])
    text = out.getvalue()
    assert "served 24 requests" in text and "slo health: ok" in text
    assert "staged: 5 stage histograms" in text
    assert "shadow audit: live_recall=" in text
