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
         for mode in ("compact", "dense")
         for metric in ("angular", "l2")
         for dt in ("fp32", "int8", "bf16")
         for adaptive in (False, True)
         if mode == "compact" or dt == "fp32"]


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


@pytest.mark.parametrize("mode", ["compact", "dense"])
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


def test_mega_mode_raises():
    jidx, base, queries = _fixture()
    tidx, _ = _port(jidx)
    with pytest.raises(NotImplementedError, match="next slice"):
        tidx.search(queries, base, SearchParams(mode="mega", k=K_TOP))


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
    assert "repro_torch.core.query" in mods and len(mods) >= 15
