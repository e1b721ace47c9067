"""Observability smoke (CI): one registry must end up holding every metric
family the telemetry subsystem promises (docs/observability.md). Port of
``repro/launch/obs_smoke.py``.

Fits a tiny index for one round, then serves 32 requests through a staged
IRLIServer over a streaming index (so inserts/deletes/compaction record
too), and asserts the registry snapshot is non-empty and contains:

  - fit-round load-balance + training metrics (fit_churn, fit_load_kl,
    fit_load_min/max, fit_grad_norm, fit_loss)
  - per-stage serve latency histograms (serve_stage_seconds{stage=...})
  - per-bucket probe-frequency vector (serve_bucket_probes) with its
    KL-vs-uniform load summary
  - batching + cache counters (serve_requests_total, queue wait,
    cache_hits/misses/compiles)
  - streaming gauges (stream_live, stream_delta_occupancy, ...)
  - online-refit series: query-log traffic counters, one background refit
    cycle's fit/cycle timings + loss, and the artifact-swap counters the
    zero-downtime install records (stream_swaps_total, artifact_version)
  - live-quality series (docs/quality.md): a shadow-audit batch scored
    against the exact oracle (quality_*), a FORCED drift spike that flips
    ``/healthz`` to 503 and fires a drift-triggered refit cycle whose swap
    re-anchors the detector and flips health back to 200 (drift_*, slo_*,
    refit_trigger_total, refit_audited_recall_*)

The metrics surface itself is exercised registry-first (complete even with
exposition off); only the /healthz flip opens an ephemeral loopback port.

    PYTHONPATH=src python -m repro_torch.launch.obs_smoke [--device cpu]

``main(device)`` runs on the card unless the caller asks for the CPU; its
tensors (ids, scores) come to the host as numpy where the reference's
arrays are read.
"""
import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def main(device: str = "cuda"):
    from repro_torch import obs
    from repro_torch.core.index import IRLIIndex, IRLIConfig
    from repro_torch.core.search_api import SearchParams
    from repro_torch.data.synthetic import clustered_ann
    from repro_torch.serve.server import IRLIServer
    from repro_torch.stream import MutableIRLIIndex

    registry = obs.MetricRegistry()
    n_base, n_req = 512, 32
    data = clustered_ann(n_base=n_base, n_queries=n_req, d=16,
                         n_clusters=16, seed=0)

    # ---- fit: 1 round, telemetry into the shared registry ----------------
    cfg = IRLIConfig(d=16, n_labels=n_base, n_buckets=32, n_reps=2,
                     d_hidden=32, K=5, rounds=1, epochs_per_round=2,
                     batch_size=128, seed=0)
    idx = IRLIIndex(cfg, device=device)
    idx.fit(data.train_queries, data.train_gt, label_vecs=data.base,
            registry=registry)
    snap = registry.snapshot()
    for key in ("fit_rounds_total", "fit_loss", "fit_grad_norm", "fit_churn",
                "fit_load_std", "fit_load_min", "fit_load_max",
                "fit_load_kl"):
        assert key in snap, f"fit metric {key!r} missing: {sorted(snap)}"
    assert snap["fit_load_kl"]["value"] >= 0.0

    # ---- serve: 32 staged requests + mutations through the server --------
    midx = MutableIRLIIndex(idx, data.base, capacity=2 * n_base,
                            registry=registry)
    # mode pinned compact: the 100M-scale serving path (and its freq_topc
    # stage) is the one the smoke must prove observable
    qlog = obs.QueryLog(capacity=256, registry=registry)
    server = IRLIServer(midx,
                        params=SearchParams(m=4, tau=1, k=10, mode="compact"),
                        max_batch=16, max_wait_ms=1.0, registry=registry,
                        staged=True, qlog=qlog)
    try:
        futs = [server.submit(data.queries[i]) for i in range(n_req)]
        results = [f.result(timeout=600) for f in futs]
        assert all(r.ids.shape == (10,) for r in results)
        ins = server.insert(np.asarray(data.queries[:4], np.float32))
        new_ids = ins.result(timeout=600)
        server.delete(new_ids[:2]).result(timeout=600)
        server.search(data.queries[0], timeout=600)   # post-mutation epoch
    finally:
        server.close()
    midx.compact()
    # the fused path (staged mode bypasses the jit cache by design) must
    # record cache lookups + first-call compile latency: miss, then hit
    fused = SearchParams(m=4, tau=1, k=10, mode="compact")
    for _ in range(2):
        midx.search(data.queries[:8], fused, cache=server.cache)
    # the megakernel path: staged mode="mega" serves the whole query as ONE
    # dispatch, records a stage="mega" histogram + the dispatch counter the
    # single-dispatch contract pins, and must stay bit-identical to compact
    ref = midx.search(data.queries[:8], fused, cache=server.cache)
    mega = SearchParams(m=4, tau=1, k=10, mode="mega")
    for _ in range(2):
        got = midx.search(data.queries[:8], mega, cache=server.cache,
                          staged=True)
    for a, b in ((got.ids, ref.ids), (got.scores, ref.scores),
                 (got.n_candidates, ref.n_candidates)):
        assert _host(a).tobytes() == _host(b).tobytes(), \
            "mode='mega' diverged from the compact path"

    # ---- online refit: one cycle off the server's query log + one swap ---
    from repro_torch.online import OnlineRefitLoop, RefitConfig
    assert len(qlog) >= n_req          # the server sampled every batch
    epoch0 = midx.epoch
    loop = OnlineRefitLoop(midx, qlog, config=RefitConfig(
        min_queries=n_req, rounds_per_cycle=1, hot_frac=0.05),
        registry=registry)
    art = loop.run_cycle()
    assert art is not None and midx.epoch > epoch0, "refit swap did not land"
    art.verify()

    snap = registry.snapshot()
    assert snap, "registry snapshot is empty"
    for key in ("qlog_seen_total", "qlog_logged_total", "qlog_fill",
                "refit_cycles_total", "refit_rounds_total", "refit_loss",
                "refit_n_reassigned", "refit_queries_total",
                "refit_fit_seconds", "refit_cycle_seconds",
                "refit_predicted_m_mean", "refit_artifact_version",
                "stream_swaps_total", "stream_swap_seconds",
                "artifact_version"):
        assert key in snap, f"refit metric {key!r} missing: {sorted(snap)}"
    assert snap["refit_cycles_total"]["value"] >= 1
    assert snap["stream_swaps_total"]["value"] >= 1
    assert snap["artifact_version"]["value"] == midx.epoch
    stages = sorted(k for k in snap if k.startswith("serve_stage_seconds"))
    assert stages, f"no per-stage histograms: {sorted(snap)}"
    for stage in ("scorer_logits", "top_m", "gather", "freq_topc", "mega"):
        assert any(f'stage="{stage}"' in k for k in stages), \
            f"stage {stage!r} missing from {stages}"
    assert snap["serve_mega_dispatch_total"]["value"] >= 2, \
        "mega staged serves did not count dispatches"
    for key in ("serve_requests_total", "serve_batches_total",
                "serve_queue_wait_seconds", "serve_batch_seconds",
                "serve_candidates", "serve_bucket_probes",
                "serve_mutations_total", "cache_hits_total",
                "cache_misses_total", "cache_compiles_total",
                "cache_compile_seconds", "stream_inserts_total",
                "stream_deletes_total", "stream_compactions_total",
                "stream_live", "stream_delta_occupancy",
                "stream_tombstone_ratio"):
        assert key in snap, f"serve metric {key!r} missing: {sorted(snap)}"
    assert snap["serve_requests_total"]["value"] >= n_req
    probes = snap["serve_bucket_probes"]
    assert probes["sum"] > 0 and "kl_vs_uniform" in probes
    # the exposition path must render the same registry, including the
    # derived le-bucket quantile series
    text = registry.to_text()
    assert "serve_requests_total" in text and "_bucket{" in text
    assert 'quantile="0.99"' in text, "derived p99 missing from exposition"

    # ---- quality: shadow audit, drift spike -> 503 -> refit -> 200 -------
    import json
    import urllib.request
    from repro_torch.obs.quality import (DriftDetector, QuerySketch,
                                         ShadowAuditor, SLOMonitor, SLOSpec)

    serve = SearchParams(m=4, tau=1, k=10, mode="compact")
    sketch = QuerySketch(d=16, n_planes=6, seed=0)
    drift = DriftDetector(sketch, reference=sketch.histogram(data.queries),
                          registry=registry, min_count=8)
    auditor = ShadowAuditor(
        midx.exact_oracle(k=10), sample=1.0, registry=registry,
        searcher=lambda q: _host(midx.search(q, serve).ids))
    monitor = SLOMonitor(SLOSpec(max_drift=0.5, trip_after=2, clear_after=1),
                         registry=registry)
    http = obs.start_metrics_server(registry, 0, host="127.0.0.1",
                                    health=monitor.health,
                                    status=lambda: {
                                        "artifact_version": midx.epoch})

    def healthz():
        url = f"http://127.0.0.1:{http.server_address[1]}/healthz"
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        # one shadow-audit batch against the exact oracle
        res = midx.search(data.queries, serve)
        auditor.observe(np.asarray(data.queries, np.float32),
                        _host(res.ids), epoch=midx.epoch,
                        latency_s=1e-3)
        audit = auditor.run_audit()
        assert audit is not None and 0.0 <= audit["live_recall"] <= 1.0
        assert midx.epoch in audit["by_version"]

        # healthy before the spike
        monitor.evaluate()
        code, body = healthz()
        assert code == 200, f"pre-spike healthz {code}: {body}"

        # forced drift spike: shifted/negated traffic, then two breaching
        # evaluations (trip_after=2) -> critical -> 503
        drifted = np.asarray(-data.queries + 2.0, np.float32)
        qlog2 = obs.QueryLog(capacity=256, registry=registry)
        for _ in range(4):
            r2 = midx.search(drifted, serve)
            drift.record(drifted)
            qlog2.record(drifted, _host(r2.ids), epoch=midx.epoch)
        assert drift.score() > 0.5, "forced spike did not register"
        monitor.evaluate(), monitor.evaluate()
        code, body = healthz()
        assert code == 503, f"spiked healthz {code}: {body}"
        assert body["status"] == "critical"

        # the drift trigger (not a cadence) fires a refit cycle; its swap
        # freezes the drained window's sketch, re-anchors the detector,
        # and health recovers
        loop2 = OnlineRefitLoop(
            midx, qlog2,
            config=RefitConfig(interval_s=None, on_drift=0.5,
                               min_queries=32, rounds_per_cycle=1),
            registry=registry, auditor=auditor, drift=drift)
        assert loop2.should_fire(0.0) == "drift"
        art2 = loop2.run_cycle()
        assert art2 is not None and art2.sketch is not None
        assert drift.score() < 0.5, "swap did not re-anchor the detector"
        monitor.evaluate()                           # clear_after=1
        code, body = healthz()
        assert code == 200, f"post-refit healthz {code}: {body}"
    finally:
        http.shutdown()

    snap = registry.snapshot()
    for key in ("quality_observed_total", "quality_sampled_total",
                "quality_live_recall", "quality_recall",
                "quality_audited_total", "quality_audits_total",
                "query_drift_score", "drift_query_kl", "drift_chi_square",
                "drift_window_total", "drift_scores_total",
                'slo_state{slo="drift"}', 'slo_value{slo="drift"}',
                'slo_breaches_total{slo="drift"}', "slo_health",
                "slo_evaluations_total",
                'refit_trigger_total{trigger="drift"}',
                "refit_audited_recall_pre", "refit_audited_recall_post",
                "refit_audited_recall_delta"):
        assert key in snap, f"quality metric {key!r} missing: {sorted(snap)}"
    assert snap['refit_trigger_total{trigger="drift"}']["value"] >= 1

    print(f"obs smoke OK: {len(snap)} series, "
          f"{len(stages)} stage histograms, "
          f"probe KL={probes['kl_vs_uniform']:.3f}, "
          f"refit epoch={midx.epoch}, "
          f"live recall={audit['live_recall']:.2f}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    main(ap.parse_args().device)
