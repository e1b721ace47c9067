"""Serving launcher CLI: build an IRLI index over a synthetic corpus and
serve batched online queries through the micro-batching server via the
typed search API (SearchParams in, SearchResult out), printing recall +
latency percentiles and the pipeline-cache counters. A slice of the
requests carries a per-request SearchParams override (wider probe), so the
run also exercises the server's params-grouped micro-batching.

    PYTHONPATH=src python -m repro_torch.launch.serve [--requests 256]
        [--base 4096] [--metrics-port 9100] [--staged]
        [--metrics-log PATH.jsonl] [--audit-sample 0.05] [--slo-p99-ms 50]
        [--slo-min-recall 0.5] [--slo-max-drift 1.0] [--device cuda]

Port of ``repro/launch/serve.py``: the same flags, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels).

--metrics-port exposes the run's MetricRegistry over HTTP (GET /metrics for
Prometheus text, /metrics.json for the raw snapshot, /healthz + /statusz
when SLOs are armed) while serving; --staged serves every request through
the per-stage debug pipeline (bit-identical results, per-stage latency
histograms); --metrics-log appends per-fit-round rows + a final registry
snapshot as JSONL (docs/observability.md). --audit-sample arms the shadow
auditor (exact-oracle live recall over that fraction of traffic) and the
drift detector; the --slo-* thresholds arm the SLOMonitor whose health
feeds /healthz (docs/quality.md).
"""
import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--base", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="expose /metrics on this port (0 = off)")
    ap.add_argument("--staged", action="store_true",
                    help="serve through the per-stage debug pipeline")
    ap.add_argument("--metrics-log", default="",
                    help="append fit rounds + final snapshot to this JSONL")
    ap.add_argument("--audit-sample", type=float, default=0.0,
                    help="shadow-audit sample rate (0 = auditing off)")
    ap.add_argument("--slo-p99-ms", type=float, default=0.0,
                    help="p99 serve-latency SLO in ms (0 = rule off)")
    ap.add_argument("--slo-min-recall", type=float, default=0.0,
                    help="min shadow-audited live recall (0 = rule off)")
    ap.add_argument("--slo-max-drift", type=float, default=0.0,
                    help="max query-drift KL score (0 = rule off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import obs
    from repro_torch.core import query as Q
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.search_api import SearchParams
    from repro_torch.data.synthetic import clustered_ann
    from repro_torch.kernels import resolve_device
    from repro_torch.serve.server import IRLIServer

    dev = resolve_device(args.device)

    registry = obs.MetricRegistry()
    mlog = obs.MetricsLogger(args.metrics_log) if args.metrics_log else None

    data = clustered_ann(n_base=args.base, n_queries=args.requests, d=16,
                         n_clusters=max(2, args.base // 20), seed=0)

    # quality wiring (docs/quality.md): exact oracle over the frozen corpus,
    # sampled shadow audits, drift vs the train-query sketch, SLO health
    auditor = drift = monitor = None
    if args.audit_sample > 0:
        tomb = torch.zeros((args.base,), dtype=torch.bool, device=dev)
        base_dev = torch.as_tensor(data.base, dtype=torch.float32).to(dev)
        auditor = obs.ShadowAuditor(
            lambda q: Q.exact_topk(
                torch.as_tensor(q, dtype=torch.float32).to(dev), base_dev,
                tomb, k=10).cpu().numpy(),
            sample=args.audit_sample, registry=registry)
        sketch = obs.QuerySketch(d=16, n_planes=6, seed=0)
        drift = obs.DriftDetector(
            sketch, reference=sketch.histogram(data.train_queries),
            registry=registry)
    slo = obs.SLOSpec(
        p99_latency_s=args.slo_p99_ms / 1e3 if args.slo_p99_ms else None,
        min_live_recall=args.slo_min_recall or None,
        max_drift=args.slo_max_drift or None)
    if any(v is not None for v in (slo.p99_latency_s, slo.min_live_recall,
                                   slo.max_drift)):
        monitor = obs.SLOMonitor(slo, registry=registry)

    http_srv = None
    if args.metrics_port:
        http_srv = obs.start_metrics_server(
            registry, args.metrics_port,
            health=monitor.health if monitor is not None else None,
            status=lambda: {"n_base": args.base,
                            "audit_sample": args.audit_sample})
        print(f"metrics on http://{http_srv.server_address[0]}:"
              f"{http_srv.server_address[1]}/metrics")

    print(f"fitting index over {args.base} vectors ...")
    cfg = IRLIConfig(d=16, n_labels=args.base, n_buckets=64, n_reps=4,
                     d_hidden=96, K=10, rounds=args.rounds, epochs_per_round=3,
                     batch_size=512, lr=2e-3, seed=0)
    idx = IRLIIndex(cfg, device=dev)
    idx.fit(data.train_queries, data.train_gt, label_vecs=data.base,
            registry=registry, log=mlog)

    default = SearchParams(m=4, tau=1, k=10)
    wide = default.replace(m=8)           # per-request override: probe wider
    server = IRLIServer(idx, params=default, base=data.base,
                        max_batch=64, max_wait_ms=2.0,
                        registry=registry, staged=args.staged,
                        auditor=auditor, drift=drift)
    futs, lat = [], []
    t0 = time.time()
    for i in range(args.requests):
        p = wide if i % 8 == 0 else default
        futs.append((time.time(), server.submit(data.queries[i], p)))
    hits = 0
    for i, (t, f) in enumerate(futs):
        res = f.result(timeout=600)
        lat.append((time.time() - t) * 1000)
        hits += len(set(map(int, res.ids)) & set(map(int, data.gt[i]))) / 10
    total = time.time() - t0
    lat = np.sort(np.asarray(lat))
    print(f"served {args.requests} requests in {total:.2f}s "
          f"({args.requests / total:.0f} qps), recall10@10="
          f"{hits / args.requests:.3f}")
    print(f"latency ms: p50={lat[len(lat) // 2]:.1f} "
          f"p95={lat[int(len(lat) * .95)]:.1f} "
          f"p99={lat[int(len(lat) * .99)]:.1f}")
    print(f"stats={server.stats}")
    snap = registry.snapshot()
    qw = snap.get("serve_queue_wait_seconds", {})
    print(f"registry: {len(snap)} series; queue_wait n={qw.get('count', 0)} "
          f"mean={qw.get('sum', 0.0) / max(qw.get('count', 1), 1) * 1e3:.2f}ms")
    if args.staged:
        stages = [k for k in snap if k.startswith("serve_stage_seconds")]
        print(f"staged: {len(stages)} stage histograms "
              f"({', '.join(sorted(stages))})")
    if auditor is not None:
        audit = auditor.run_audit()
        score = drift.score()
        if audit is not None:
            print(f"shadow audit: live_recall={audit['live_recall']:.3f} "
                  f"over {audit['n_audited']} sampled queries, "
                  f"drift KL={score:.3f}")
    if monitor is not None:
        monitor.evaluate()
        health = monitor.health()
        print(f"slo health: {health['status']} {health['states']}")
    if mlog is not None:
        mlog.log_snapshot(registry)
        mlog.close()
        print(f"metrics log -> {args.metrics_log}")
    if http_srv is not None:
        http_srv.shutdown()
    server.close()


if __name__ == "__main__":
    main()
