"""The port's obs modules (logger, query log, quality, exposition) against
the JAX package's copies, on the CPU.

The obs modules are numpy and the standard library in both packages, so
the port is held to equality: the same seeds keep the same rows, build the
same hyperplanes and histograms, the scores agree to 1e-12, the SLO state
machine follows the same trace, and the HTTP bodies are equal for the same
registry content. Tensors go in wherever the reference takes arrays.
"""
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as J  # noqa: E402
from repro_torch import obs as T  # noqa: E402

D = 12


def _batches(seed=0, n_batches=5):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        n = int(rng.integers(1, 40))
        out.append((rng.normal(size=(n, D)).astype(np.float32),
                    rng.integers(-1, 500, (n, 7)).astype(np.int32), b,
                    float(rng.random())))
    return out


# ------------------------------------------------------------- query log --
@pytest.mark.parametrize("capacity,sample,seed", [
    (64, 1.0, 0), (64, 0.3, 1), (16, 0.7, 2), (200, 0.05, 3)])
def test_qlog_same_seed_keeps_the_same_rows(capacity, sample, seed):
    """Each batch goes to the reference as numpy and to the port as
    tensors: the kept rows, epochs, latencies, ring order, counters and
    fill gauge are equal."""
    jreg, treg = J.MetricRegistry(), T.MetricRegistry()
    jl = J.QueryLog(capacity=capacity, sample=sample, seed=seed,
                    registry=jreg)
    tl = T.QueryLog(capacity=capacity, sample=sample, seed=seed,
                    registry=treg)
    for q, ids, ep, lat in _batches(seed):
        kj = jl.record(q, ids, epoch=ep, latencies=lat)
        kt = tl.record(torch.from_numpy(q), torch.from_numpy(ids), epoch=ep,
                       latencies=lat)
        assert kj == kt
        assert len(jl) == len(tl) and jl.total_logged == tl.total_logged
    assert jreg.snapshot() == treg.snapshot()
    jw, tw = jl.drain(), tl.drain()
    for f in ("x", "ids", "epoch", "latency"):
        a, b = getattr(jw, f), getattr(tw, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    x, ids = tw                                    # the legacy unpacking
    assert x is tw.x and ids is tw.ids
    assert len(tl.drain()) == 0 and len(tl) == 0


def test_drained_windows_merge_and_refuse_mismatch():
    tl = T.QueryLog(capacity=32, seed=0)
    q, ids, _, _ = _batches(4, 1)[0]
    tl.record(q, ids, epoch=3)
    a = tl.drain()
    tl.record(q[:2], ids[:2], epoch=4)
    b = tl.drain()
    m = a.merge(b)
    assert len(m) == len(a) + 2 and list(m.epoch[-2:]) == [4, 4]
    assert np.isnan(m.latency).all()
    bad = T.DrainedLog(x=np.zeros((1, D + 1), np.float32),
                       ids=np.zeros((1, 7), np.int32),
                       epoch=np.zeros(1, np.int64),
                       latency=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="cannot merge"):
        a.merge(bad)
    with pytest.raises(ValueError, match="shape drift"):
        tl.record(np.zeros((2, D + 1), np.float32), np.zeros((2, 7)))


# ---------------------------------------------------------- the sketches --
@pytest.mark.parametrize("d,planes,seed", [(16, 6, 0), (96, 6, 0),
                                           (8, 12, 5)])
def test_sketch_planes_and_histograms_are_equal(d, planes, seed):
    js, ts = J.QuerySketch(d, planes, seed), T.QuerySketch(d, planes, seed)
    np.testing.assert_array_equal(js._planes, ts._planes)
    q = np.random.default_rng(seed).normal(size=(300, d)).astype(np.float32)
    np.testing.assert_array_equal(js.bucket_ids(q),
                                  ts.bucket_ids(torch.from_numpy(q)))
    np.testing.assert_array_equal(js.histogram(q),
                                  ts.histogram(torch.from_numpy(q)))


@pytest.mark.parametrize("eps", [1e-3, 1e-1])
def test_kl_and_chi_square_agree(eps):
    rng = np.random.default_rng(7)
    live = rng.integers(0, 50, 64).astype(np.float64)
    ref = rng.integers(0, 50, 64).astype(np.float64)
    assert abs(T.kl_divergence(torch.from_numpy(live), ref, eps)
               - J.kl_divergence(live, ref, eps)) <= 1e-12
    assert abs(T.chi_square(live, torch.from_numpy(ref), eps)
               - J.chi_square(live, ref, eps)) <= 1e-12
    assert T.kl_divergence(live, live) == pytest.approx(0.0, abs=1e-15)


def test_drift_detector_scores_alike():
    rng = np.random.default_rng(8)
    ref_q = rng.normal(size=(400, D)).astype(np.float32)
    live_q = (rng.normal(size=(200, D)) + 0.7).astype(np.float32)
    jreg, treg = J.MetricRegistry(), T.MetricRegistry()
    jd = J.DriftDetector(J.QuerySketch(D, 6, 1),
                         reference=J.QuerySketch(D, 6, 1).histogram(ref_q),
                         registry=jreg)
    tsk = T.QuerySketch(D, 6, 1)
    td = T.DriftDetector(tsk, reference=torch.from_numpy(
        tsk.histogram(ref_q)), registry=treg)
    assert jd.score() == td.score() == 0.0          # below min_count
    jd.record(live_q)
    td.record(torch.from_numpy(live_q))
    assert abs(jd.score() - td.score()) <= 1e-12
    assert jreg.snapshot() == treg.snapshot()
    td.reset_window()
    assert td.score() == 0.0


# --------------------------------------------------------- recall + audit --
def test_recall_rows_and_shadow_audit_match():
    rng = np.random.default_rng(9)
    served = rng.integers(-1, 30, (50, 10))
    exact = rng.integers(-1, 30, (50, 10))
    np.testing.assert_array_equal(
        T.recall_rows(torch.from_numpy(served), torch.from_numpy(exact)),
        J.recall_rows(served, exact))
    table = rng.integers(0, 30, (1000, 10)).astype(np.int32)

    def oracle(q):                     # deterministic in the query values
        return table[(np.abs(q[:, 0]) * 997).astype(np.int64) % 1000]

    jreg, treg = J.MetricRegistry(), T.MetricRegistry()
    ja = J.ShadowAuditor(oracle, sample=0.5, seed=3, registry=jreg)
    ta = T.ShadowAuditor(lambda q: torch.from_numpy(oracle(q)), sample=0.5,
                         seed=3, registry=treg)
    for q, ids, ep, lat in _batches(10):
        ja.observe(q, ids, epoch=ep, latency_s=lat)
        ta.observe(torch.from_numpy(q), torch.from_numpy(ids), epoch=ep,
                   latency_s=lat)
    assert ja.run_audit() == ta.run_audit()
    assert ta.run_audit() is None
    assert jreg.snapshot() == treg.snapshot()
    q = _batches(11, 1)[0][0]
    assert ta.recall_of(torch.from_numpy(q), oracle(q)) == 1.0


# ------------------------------------------------------------------- SLO --
def _slo_trace(mod, reg):
    spec = mod.SLOSpec(p99_latency_s=0.05, min_live_recall=0.8,
                       max_load_kl=0.5, trip_after=2, clear_after=2)
    mon = mod.SLOMonitor(spec, registry=reg)
    states = [mon.evaluate()]                        # no data: holds ok
    lat = reg.histogram("serve_batch_seconds")
    for v in (0.01, 0.2, 0.3, 0.01, 0.01, 0.01, 0.01, 0.01):
        for _ in range(40):
            lat.observe(v)
        reg.gauge("quality_live_recall").set(0.9 if v < 0.1 else 0.5)
        reg.counter("quality_audits_total").inc()
        vec = reg.vector("serve_bucket_probes", 8)
        vec.add(np.array([5, 1, 1, 1, 1, 1, 1, 1]) if v > 0.1
                else np.ones(8))
        states.append(mon.evaluate())
    return states, mon.health()


def test_slo_state_machine_follows_the_same_trace():
    jreg, treg = J.MetricRegistry(), T.MetricRegistry()
    js, jh = _slo_trace(J, jreg)
    ts, th = _slo_trace(T, treg)
    assert js == ts and jh == th
    assert any(T.CRITICAL in s.values() for s in ts)
    assert jreg.snapshot() == treg.snapshot()


# ------------------------------------------------------------- exposition --
def _fill(reg):
    reg.counter("serve_requests_total").inc(41)
    reg.counter("quality_audited_total", {"version": "3"}).inc(7)
    reg.gauge("serve_epoch").set(3)
    h = reg.histogram("serve_batch_seconds")
    for v in (1e-4, 2e-3, 2e-3, 0.5):
        h.observe(v)
    reg.vector("serve_bucket_probes", 6).add(np.array([1, 2, 3, 0, 0, 9]))


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("critical", [False, True])
def test_exposition_bodies_are_equal(critical):
    """/metrics, /metrics.json, /healthz and /statusz (uptime aside) are
    the same bytes for the same registry content, on 127.0.0.1 port 0."""
    state = "critical" if critical else "ok"

    def health():
        return {"status": state, "states": {"p99_latency": state}}

    servers = []
    try:
        for mod in (J, T):
            reg = mod.MetricRegistry()
            _fill(reg)
            servers.append(mod.start_metrics_server(
                reg, 0, host="127.0.0.1", health=health,
                status=lambda: {"artifact_version": 3}))
        ports = [s.server_address[1] for s in servers]
        for path in ("/metrics", "/metrics.json", "/healthz", "/nope"):
            a, b = (_get(p, path) for p in ports)
            assert a == b, path
        assert _get(ports[1], "/healthz")[0] == (503 if critical else 200)
        js, ts = (json.loads(_get(p, "/statusz")[2]) for p in ports)
        js.pop("uptime_s"), ts.pop("uptime_s")
        assert js == ts == {"artifact_version": 3, "health": health()}
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


# ---------------------------------------------------------------- logger --
def test_metrics_logger_round_trips(tmp_path):
    """Rows with tensors (any device), numpy scalars and snapshots come back
    from the JSONL file as the reference's logger writes them."""
    rows = []
    for mod, name, conv in ((J, "j.jsonl", np.asarray),
                            (T, "t.jsonl", torch.as_tensor)):
        reg = mod.MetricRegistry()
        _fill(reg)
        path = tmp_path / name
        with mod.MetricsLogger(str(path)) as log:
            log.log({"loss": conv(np.float32(0.25)), "n": conv(7),
                     "vec": conv(np.arange(3)), "tag": "a",
                     "nested": {"x": conv(np.array([[1.5, 2.0]]))}}, step=2)
            log.log_snapshot(reg, step=3)
        with pytest.raises(ValueError, match="closed"):
            log.log({"late": 1})
        got = [json.loads(line) for line in path.read_text().splitlines()]
        for r in got:
            assert r.pop("ts") > 0
        rows.append(got)
    assert rows[0] == rows[1]
    assert rows[1][0] == {"step": 2, "loss": 0.25, "n": 7, "vec": [0, 1, 2],
                          "tag": "a", "nested": {"x": [[1.5, 2]]}}


def test_obs_exports_are_the_references():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert T.RECALL_BUCKETS == J.RECALL_BUCKETS
    assert T.STATE_NAMES == J.STATE_NAMES
    up = T.uptime_source()
    assert up()["uptime_s"] >= 0.0
