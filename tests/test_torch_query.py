"""The port's query slice against the JAX package, end to end on the CPU.

One untrained JAX index (the tests/test_mega_query.py fixture pattern) is
carried across with repro_torch.convert, and both packages' IRLIIndex.search
run on the same numpy queries and corpus: ids and n_candidates must be
equal, scores agree to 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import query as JQ  # noqa: E402
from repro.core.index import IRLIConfig, IRLIIndex  # noqa: E402
from repro.core.search_api import SearchParams as JParams  # noqa: E402
from repro.store.quantized import encode as jencode  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import query as TQ  # noqa: E402
from repro_torch.core.search_api import SearchParams  # noqa: E402
from repro_torch.kernels.mega_query.ref import mega_search_ref  # noqa: E402

D, B, R, M_PROBE, K_TOP = 16, 16, 2, 4, 5
SRC = Path(__file__).resolve().parents[1] / "src"


def _fixture(L=400, n_q=8, seed=1):
    rng = np.random.default_rng(seed)
    cfg = IRLIConfig(d=D, n_labels=L, n_buckets=B, n_reps=R, d_hidden=32,
                     K=M_PROBE, seed=seed)
    idx = IRLIIndex(cfg)
    idx.build_index()
    base = rng.normal(size=(L, D)).astype(np.float32)
    queries = rng.normal(size=(n_q, D)).astype(np.float32)
    return idx, base, queries


def _port(jidx, jstore=None):
    store = None
    if jstore is not None:
        store = {"dtype": jstore.dtype, "block": jstore.block,
                 "codes": np.asarray(jstore.codes.astype(jnp.float32)
                                     if jstore.dtype == "bf16"
                                     else jstore.codes),
                 "scales": (None if jstore.scales is None
                            else np.asarray(jstore.scales)),
                 "exact": (None if jstore.exact is None
                           else np.asarray(jstore.exact))}
    params = {k: np.asarray(v) for k, v in jidx.params.items()}
    return convert.from_reference(
        jidx.cfg, params=params, assign=np.asarray(jidx.assign),
        members=np.asarray(jidx.index.members), store=store, device="cpu")


def _assert_same(got, ref):
    ids, scores, n_cand = (t.numpy() for t in got)
    rids, rscores, rn = (np.asarray(a) for a in ref)
    assert ids.dtype == np.int32 and n_cand.dtype == np.int32
    assert scores.dtype == np.float32
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(n_cand, rn)
    assert (ids >= 0).any()                      # the search found rows
    np.testing.assert_allclose(scores, rscores, rtol=1e-5, atol=1e-5)


CASES = [(mode, metric, dt, adaptive)
         for mode in ("compact", "dense", "mega")
         for metric in ("angular", "l2")
         for dt in ("fp32", "int8", "bf16")
         for adaptive in (False, True)
         if mode != "dense" or dt == "fp32"]


@pytest.mark.parametrize("mode,metric,store_dtype,adaptive", CASES)
def test_index_search_matches_reference(mode, metric, store_dtype, adaptive):
    jidx, base, queries = _fixture()
    jbase = jnp.asarray(base)
    if store_dtype != "fp32":
        jbase = jencode(jbase, dtype=store_dtype, block=8,
                        keep_exact=(store_dtype == "int8"))
    tidx, tstore = _port(jidx, jbase if store_dtype != "fp32" else None)
    kw = dict(m=M_PROBE, tau=1, k=K_TOP, topC=64, metric=metric, mode=mode,
              store_dtype=store_dtype,
              refine_k=16 if store_dtype != "fp32" else 0,
              adaptive_m=adaptive, probe_mass=0.6 if adaptive else 1.0)
    ref = jidx.search(jnp.asarray(queries), jbase, JParams(**kw))
    got = tidx.search(queries, tstore if tstore is not None else base,
                      SearchParams(**kw))
    assert got.mode == ref.mode == mode
    _assert_same((got.ids, got.scores, got.n_candidates),
                 (ref.ids, ref.scores, ref.n_candidates))
    if mode == "mega":                  # the plain version, called directly
        plain = mega_search_ref(
            tidx.params, tidx.index.members,
            tstore if tstore is not None else torch.from_numpy(base),
            torch.from_numpy(queries), m=M_PROBE, tau=1, topC=64, k=K_TOP,
            refine_k=kw["refine_k"], metric=metric, adaptive_m=adaptive,
            probe_mass=kw["probe_mass"])
        for a, b in zip((got.ids, got.scores, got.n_candidates), plain):
            assert torch.equal(a, b)


@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_mega_dequant_refine_matches_reference(metric):
    """An int8 store without an exact tier: the refine re-scores the k'
    survivors on dequantized codes."""
    jidx, base, queries = _fixture(seed=4)
    jstore = jencode(jnp.asarray(base), dtype="int8", block=8)
    tidx, tstore = _port(jidx, jstore)
    assert tstore.exact is None
    kw = dict(m=M_PROBE, tau=1, k=K_TOP, topC=64, metric=metric,
              mode="mega", store_dtype="int8", refine_k=16)
    ref = jidx.search(jnp.asarray(queries), jstore, JParams(**kw))
    got = tidx.search(queries, tstore, SearchParams(**kw))
    _assert_same((got.ids, got.scores, got.n_candidates),
                 (ref.ids, ref.scores, ref.n_candidates))


@pytest.mark.parametrize("tau", [1, 2])
def test_auto_mode_and_tau_match_reference(tau):
    """auto resolves to dense at this size in both packages; tau=2 filters
    single-probe candidates."""
    jidx, base, queries = _fixture(seed=3)
    tidx, _ = _port(jidx)
    kw = dict(m=M_PROBE, tau=tau, k=K_TOP, topC=64)
    ref = jidx.search(jnp.asarray(queries), jnp.asarray(base), JParams(**kw))
    got = tidx.search(queries, base, SearchParams(**kw))
    assert got.mode == ref.mode
    _assert_same((got.ids, got.scores, got.n_candidates),
                 (ref.ids, ref.scores, ref.n_candidates))


@pytest.mark.parametrize("mode", ["compact", "dense", "mega"])
def test_delta_and_tombstone_match_reference(mode):
    """The streaming state through QueryPipeline.search: delta segments are
    unioned into the gather and tombstoned ids never survive."""
    jidx, base, queries = _fixture(seed=2)
    L = base.shape[0]
    rng = np.random.default_rng(7)
    delta = np.full((R, B, 3), -1, np.int32)
    delta[:, :, 0] = rng.integers(0, L, (R, B))
    tomb = np.zeros(L, bool)
    tomb[rng.choice(L, 60, replace=False)] = True
    kw = dict(m=M_PROBE, tau=1, k=K_TOP, topC=64, mode=mode)
    jpipe = JQ.QueryPipeline(**kw)
    ref = jpipe.search(jidx.params, jidx.index.members, jnp.asarray(base),
                       jnp.asarray(queries), jnp.asarray(delta),
                       jnp.asarray(tomb))
    tidx, _ = _port(jidx)
    got = TQ.QueryPipeline(**kw).search(
        tidx.params, tidx.index.members, torch.from_numpy(base),
        torch.from_numpy(queries), torch.from_numpy(delta),
        torch.from_numpy(tomb))
    _assert_same(got, ref)
    assert not np.isin(got[0].numpy(), np.flatnonzero(tomb)).any()


def test_auto_resolves_mega_like_reference():
    """SearchParams(mode="auto") over a quantized store resolves "mega" in
    both packages (the paper's serve request) and serves the same
    results."""
    jidx, base, queries = _fixture(seed=5)
    jstore = jencode(jnp.asarray(base), dtype="int8", block=8)
    tidx, tstore = _port(jidx, jstore)
    kw = dict(m=M_PROBE, tau=2, k=K_TOP, topC=64, store_dtype="int8")
    ref = jidx.search(jnp.asarray(queries), jstore, JParams(**kw))
    got = tidx.search(queries, tstore, SearchParams(**kw))
    assert got.mode == ref.mode == "mega"
    _assert_same((got.ids, got.scores, got.n_candidates),
                 (ref.ids, ref.scores, ref.n_candidates))


# the combos tests/test_mega_query.py pins, and the deep1b cell's knobs
RESOLVE_CASES = [
    dict(L=100_000_000, knobs=dict(m=5, topC=1024, refine_k=0, k=10)),
    dict(L=100_000_000, knobs=dict(m=512, topC=32768, refine_k=0, k=10)),
    dict(L=100_000_000, knobs=dict(m=4, topC=256, refine_k=64, k=10)),
    dict(L=1_000, knobs=dict(m=5, topC=1024, refine_k=0, k=10)),
    dict(L=1_000, knobs=None),
    dict(L=100_000_000, knobs=None),
    dict(L=2_000_000, knobs=dict(m=5, topC=1024, refine_k=0, k=10),
         store_dtype="int8"),
]


@pytest.mark.parametrize("case", RESOLVE_CASES,
                         ids=lambda c: f"{c['L']}-{c['knobs']}")
def test_select_mode_and_resolve_match_reference(case):
    """select_mode with and without the knobs, and SearchParams.resolve,
    give the reference's mode."""
    from repro.core.search_api import SearchParams as JP
    L, knobs = case["L"], case["knobs"]
    dt = case.get("store_dtype", "fp32")
    got = TQ.select_mode(L, store_dtype=dt, **(knobs or {}))
    assert got == JQ.select_mode(L, store_dtype=dt, **(knobs or {}))
    if knobs is not None:
        sp = dict(knobs, store_dtype=dt)
        assert (SearchParams(**sp).resolve(L).mode
                == JP(**sp).resolve(L).mode)
        assert TQ.QueryPipeline.make(L, **sp).mode == JQ.QueryPipeline.make(
            L, **sp).mode


def test_mega_fits_the_card():
    """The H100 footprint model: the deep1b cell fits (n = 32768 sort row,
    two 107 KB scorer tiles: the 96 KB ring of GEMM slices, which each
    column tile's logits reuse, the lse halves and 256 half-row top-m
    lists, plus 1 KB to align them), rows past the freq_topc sort width do
    not, nor does a footprint past one block's shared memory."""
    from repro.kernels.mega_query.ops import mega_fits as jfits
    from repro_torch.kernels.mega_query import ops as mops
    cell = dict(R=32, B=20000, ML=200, d=96, D=96)
    assert mops.mega_fits(5, 1024, 0, 10, geom=cell)
    assert mops.mega_smem_bytes(5, 1024, 0, 10, geom=cell) == 1024 + 2 * (
        3 * 32768 + 2 * 128 * 4 + 256 * 5 * 8)
    p = mops.plan(32, 200, 5, 1024, 0, 10)
    assert (p.W, p.n, p.C, p.kp, p.k_eff) == (32000, 32768, 1024, 40, 10)
    assert not mops.mega_fits(6, 1024, 0, 10, geom=cell)     # W = 38400
    assert not mops.mega_fits(5, 1024, 0, 10, geom=dict(cell, ML=205))
    for args, geom in (((512, 32768, 0, 10), None),
                       ((128, 32768, 32768, 10), dict(ML=128)),
                       ((4, 256, 64, 10), dict(ML=128)),
                       ((5, 1024, 0, 10), None)):
        assert mops.mega_fits(*args, geom=geom) == jfits(*args, geom=geom)
    assert not mops.mega_fits(65, 64, 0, 10, geom=dict(R=1, ML=1))


def test_probe_counts_and_buckets_match_reference():
    jidx, _, queries = _fixture(seed=6)
    tidx, _ = _port(jidx)
    jq, tq = jnp.asarray(queries), torch.from_numpy(queries)
    for pm in (0.5, 0.9, 1.0):
        got = TQ.predicted_probe_counts(tidx.params, tq, M_PROBE, pm)
        ref = JQ.predicted_probe_counts(jidx.params, jq, M_PROBE, pm)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = TQ.probe_buckets(tidx.params, tq, M_PROBE)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.probe_buckets(jidx.params, jq, M_PROBE)))


def test_auto_tau_hits_budget():
    """The reference's test (tests/test_query_and_serving.py), held
    against repro.core.query.auto_tau on the same near-distinct freq."""
    freq = (np.random.default_rng(0).random((4, 100)) * 6).astype(np.float32)
    tau = TQ.auto_tau(torch.from_numpy(freq), budget=10)
    np.testing.assert_array_equal(
        tau.numpy(), np.asarray(JQ.auto_tau(jnp.asarray(freq), budget=10)))
    for q in range(4):
        n = int((torch.from_numpy(freq[q]) >= tau[q]).sum())
        assert n <= 10, n
    # a budget past L keeps the smallest count, and tau never drops below 1
    small = np.array([[0.0, 0.5, 3.0]], np.float32)
    for budget in (1, 2, 3, 7):
        np.testing.assert_array_equal(
            TQ.auto_tau(torch.from_numpy(small), budget).numpy(),
            np.asarray(JQ.auto_tau(jnp.asarray(small), budget)))


def test_auto_tau_rejects_nonpositive_budget():
    """The reference's test (tests/test_query_pipeline.py): budget <= 0
    raises in both packages."""
    freq = np.ones((2, 8), np.float32)
    for budget in (0, -3):
        with pytest.raises(ValueError, match="budget"):
            TQ.auto_tau(torch.from_numpy(freq), budget=budget)
        with pytest.raises(ValueError, match="budget"):
            JQ.auto_tau(jnp.asarray(freq), budget=budget)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.core.index import IRLIConfig as TConfig
    from repro_torch.core.index import IRLIIndex as TIndex
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TIndex(TConfig(d=D, n_labels=50, n_buckets=B, n_reps=R))
    jidx, _, _ = _fixture()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference(
            jidx.cfg, params={k: np.asarray(v) for k, v in
                              jidx.params.items()},
            assign=np.asarray(jidx.assign))


def test_port_imports_no_jax_and_no_reference():
    """Every module of the port imports neither jax nor the JAX package."""
    mods = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (SRC / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro_torch.core.query" in mods and len(mods) >= 53


# ------------------------------------------- rerank, oracle, dense helpers --
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_rerank_and_exact_topk_match_reference(metric):
    """rerank (a [Q, L] candidate mask) and exact_topk (a tombstone, the
    audit oracle), now through rerank_topk, give the reference's ids."""
    jidx, base, queries = _fixture(seed=8)
    rng = np.random.default_rng(8)
    L = base.shape[0]
    mask = rng.uniform(size=(len(queries), L)) < 0.02     # few survivors
    mask[0] = False                                       # none at all
    tomb = np.zeros(L, bool)
    tomb[rng.choice(L, 150, replace=False)] = True
    tq, tb = torch.from_numpy(queries), torch.from_numpy(base)
    jq, jb = jnp.asarray(queries), jnp.asarray(base)
    got = TQ.rerank(tq, tb, torch.from_numpy(mask), 12, metric)
    ref = JQ.rerank(jq, jb, jnp.asarray(mask), 12, metric)
    assert got.dtype == torch.int32 and (got[0] == -1).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = TQ.exact_topk(tq, tb, torch.from_numpy(tomb), k=10, metric=metric)
    ref = JQ.exact_topk(jq, jb, jnp.asarray(tomb), k=10, metric=metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.isin(got.numpy(), np.flatnonzero(tomb)).any()


def test_query_members_recall_and_precision_match_reference():
    """top_buckets, gather_candidates, frequency_filter, query_index (with
    delta segments and tombstones), IRLIIndex.query, recall_at and
    precision_at against the reference's."""
    jidx, base, queries = _fixture(seed=9)
    tidx, _ = _port(jidx)
    L = base.shape[0]
    rng = np.random.default_rng(9)
    delta = np.full((R, B, 2), -1, np.int32)
    delta[:, :, 0] = rng.integers(0, L, (R, B))
    tomb = np.zeros(L, bool)
    tomb[rng.choice(L, 40, replace=False)] = True
    jq, tq = jnp.asarray(queries), torch.from_numpy(queries)
    for loss in ("softmax_bce", "sigmoid_bce"):
        js, ji = JQ.top_buckets(jidx.params, jq, M_PROBE, loss)
        ts, ti = TQ.top_buckets(tidx.params, tq, M_PROBE, loss)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-6)
    got = TQ.gather_candidates(tidx.index, ti)
    ref = JQ.gather_candidates(jidx.index, ji)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = JQ.query_index(jidx.params, jidx.index, jq, m=M_PROBE, tau=2, L=L,
                         delta_members=jnp.asarray(delta),
                         tombstone=jnp.asarray(tomb))
    got = TQ.query_index(tidx.params, tidx.index, tq, m=M_PROBE, tau=2, L=L,
                         delta_members=torch.from_numpy(delta),
                         tombstone=torch.from_numpy(tomb))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(
        TQ.frequency_filter(got[1], 3).numpy(),
        np.asarray(JQ.frequency_filter(jnp.asarray(got[1].numpy()), 3)))
    for a, b in zip(tidx.query(queries, m=M_PROBE, tau=1),
                    jidx.query(jq, m=M_PROBE, tau=1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mask, freq, _ = got
    gt = rng.integers(-1, L, (len(queries), 10)).astype(np.int32)
    assert float(TQ.recall_at(mask, torch.from_numpy(gt))) == pytest.approx(
        float(JQ.recall_at(jnp.asarray(mask.numpy()), jnp.asarray(gt))))
    labels = rng.integers(0, L, (len(queries), 3)).astype(np.int32)
    labels[:, 0] = np.asarray(ref[1]).argmax(1)           # some hits
    tp = TQ.precision_at(mask, freq, tq, None, torch.from_numpy(labels))
    jp = JQ.precision_at(jnp.asarray(mask.numpy()),
                         jnp.asarray(freq.numpy()), jq, None,
                         jnp.asarray(labels))
    assert sorted(tp) == sorted(jp) == ["P@1", "P@3", "P@5"]
    for key in jp:
        assert float(tp[key]) == pytest.approx(float(jp[key]))
    assert float(tp["P@1"]) > 0


# ------------------------------------------------------------------ cache --
def test_pipeline_cache_matches_reference():
    """The same searches through both packages' PipelineCache: the same
    hits, misses, compiles and entries, the same object per key, unresolved
    params refused, and the cache_* counters mirrored into the registry."""
    from repro.core.search_api import PipelineCache as JCache
    from repro.obs import MetricRegistry as JRegistry
    from repro_torch.core.search_api import PipelineCache
    from repro_torch.obs import MetricRegistry
    jidx, base, queries = _fixture(seed=10)
    tidx, _ = _port(jidx)
    jreg, treg = JRegistry(), MetricRegistry()
    jc, tc = JCache(registry=jreg), PipelineCache(registry=treg)
    L = base.shape[0]
    sweep = [dict(m=M_PROBE, tau=1, k=K_TOP), dict(m=M_PROBE, tau=2, k=K_TOP),
             dict(m=M_PROBE, tau=1, k=K_TOP, mode="compact", topC=64)]
    for kw in sweep + sweep[::-1] + [sweep[0]]:
        for q in (queries, queries[:3]):
            jr = jidx.search(jnp.asarray(q), jnp.asarray(base),
                             JParams(**kw), cache=jc)
            tr = tidx.search(q, base, SearchParams(**kw), cache=tc)
            _assert_same((tr.ids, tr.scores, tr.n_candidates),
                         (jr.ids, jr.scores, jr.n_candidates))
    assert tc.stats() == jc.stats()
    assert tc.stats() == {"hits": 8, "misses": 6, "compiles": 6,
                          "entries": 6}
    js, ts = jreg.snapshot(), treg.snapshot()
    for name in ("cache_hits_total", "cache_misses_total",
                 "cache_compiles_total"):
        assert ts[name]["value"] == js[name]["value"]
    assert ts["cache_compile_seconds"]["count"] == 6
    p = SearchParams(m=M_PROBE).resolve(L, 8)
    assert tc.get(p, L, 8) is tc.get(p, L, 8)
    with pytest.raises(ValueError, match="resolved params"):
        tc.get(SearchParams(), L, 8)
    tc.clear()
    assert len(tc) == 0
    searcher = tidx.as_searcher(base, cache=tc)
    res = searcher.search(queries, SearchParams(m=M_PROBE, k=K_TOP))
    assert tc.stats()["misses"] == 8 and res.ids.shape == (len(queries),
                                                            K_TOP)


def test_index_search_legacy_kwargs_and_default_cache():
    from repro_torch.core.search_api import DEFAULT_CACHE
    jidx, base, queries = _fixture(seed=11)
    tidx, _ = _port(jidx)
    before = DEFAULT_CACHE.stats()
    with pytest.warns(DeprecationWarning, match="SearchParams"):
        ids, n_cand = tidx.search(queries, base, m=M_PROBE, tau=1, k=K_TOP)
    with pytest.warns(DeprecationWarning):
        jids, jn = jidx.search(jnp.asarray(queries), jnp.asarray(base),
                               m=M_PROBE, tau=1, k=K_TOP)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(n_cand.numpy(), np.asarray(jn))
    after = DEFAULT_CACHE.stats()
    assert after["hits"] + after["misses"] == (before["hits"]
                                               + before["misses"] + 1)
    with pytest.raises(TypeError, match="either SearchParams"):
        tidx.search(queries, base, SearchParams(), k=3)
    staged = tidx.search(queries, base, SearchParams(), staged=True)
    plain = tidx.search(queries, base, SearchParams())
    assert torch.equal(staged.ids, plain.ids)
    assert torch.equal(staged.scores, plain.scores)
