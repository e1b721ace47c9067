"""The port's artifacts, artifact installs, policies and online refit loop
against the JAX package's, on the CPU.

tests/test_online.py's small fitted index is carried across with
repro_torch.convert. Artifacts cross between the packages through either
CheckpointManager; the digest is the same for the same content in both.
The refit cycle is held by the fit's round-1 rule: with the reference's
batch order and insertion orders injected, the loss within 1e-4 and at
least 95% of the assignments equal.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as JO  # noqa: E402
from repro.artifact import IndexArtifact as JArtifact  # noqa: E402
from repro.checkpoint.checkpointer import (  # noqa: E402
    CheckpointManager as JManager)
from repro.core.index import IRLIConfig, IRLIIndex  # noqa: E402
from repro.core.search_api import SearchParams as JParams  # noqa: E402
from repro.data.synthetic import _topk_l2, clustered_ann  # noqa: E402
from repro.online import OnlineRefitLoop as JLoop  # noqa: E402
from repro.online import RefitConfig as JRefitConfig  # noqa: E402
from repro.online import build_replicas as j_build_replicas  # noqa: E402
from repro.stream import MutableIRLIIndex as JMutable  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.artifact import (ArtifactIntegrityError,  # noqa: E402
                                  IndexArtifact)
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    CheckpointCorruptError, CheckpointManager)
from repro_torch.core.search_api import SearchParams  # noqa: E402
from repro_torch.online import (OnlineRefitLoop, RefitConfig,  # noqa: E402
                                build_replicas, hot_buckets)
from repro_torch.stream import MutableIRLIIndex  # noqa: E402

D, N_INIT, N_NEW, M_PROBE = 16, 900, 120, 4
SP = dict(m=M_PROBE, tau=1, k=10, mode="compact", topC=512)


@pytest.fixture(scope="module")
def data():
    return clustered_ann(n_base=N_INIT + N_NEW, n_queries=60, d=D,
                         n_clusters=30, seed=0)


@pytest.fixture(scope="module")
def fitted(data):
    base = data.base[:N_INIT]
    gt = _topk_l2(base, base, k=10, metric="angular")
    cfg = IRLIConfig(d=D, n_labels=N_INIT, n_buckets=32, n_reps=2,
                     d_hidden=32, K=M_PROBE, rounds=1, epochs_per_round=2,
                     batch_size=256, seed=0)
    jidx = IRLIIndex(cfg)
    jidx.fit(base, gt, label_vecs=base)
    tidx, _ = convert.from_reference(
        cfg, params={k: np.asarray(v) for k, v in jidx.params.items()},
        assign=np.asarray(jidx.assign),
        members=np.asarray(jidx.index.members), device="cpu")
    return jidx, tidx


def _pair(fitted, data, **kw):
    jidx, tidx = fitted
    jm = JMutable(jidx, data.base[:N_INIT], registry=JO.MetricRegistry(),
                  **kw)
    tm = MutableIRLIIndex(tidx, data.base[:N_INIT],
                          registry=TO.MetricRegistry(), **kw)
    return jm, tm


def _same_state(jm, tm):
    jt = jax.tree.map(np.asarray, jm.state_dict())
    tt, tmeta = convert.stream_state_to_reference(tm)
    assert tmeta == jm.meta()
    for name, ref in jt["stream"].items():
        np.testing.assert_array_equal(tt["stream"][name], ref, err_msg=name)
    for name, ref in jt["scorer"].items():
        np.testing.assert_allclose(tt["scorer"][name], ref, rtol=1e-6,
                                   err_msg=name)


def _same_search(jres, tres):
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores),
                               rtol=1e-5, atol=1e-5)
    assert tres.epoch == jres.epoch


def _reference_orders(seed, counter, n, R):
    """The insertion orders the reference's round draws from
    PRNGKey(seed + counter) (fit/engine: split, then fold_in a rep)."""
    _, kr = jax.random.split(jax.random.PRNGKey(seed + counter))
    return np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(kr, r), n)) for r in range(R)])


class _Injected(OnlineRefitLoop):
    """The port's loop with the reference's batch order and insertion
    orders (the round's random streams cannot be reproduced by a
    torch.Generator)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._n = None

    def _round_batches(self, engine, nq):
        from repro.fit.engine import FitEngine as JEngine
        from repro.core.network import ScorerConfig as JScorer
        cfg = engine.cfg
        jeng = JEngine(cfg, JScorer(d_in=cfg.d, d_hidden=cfg.d_hidden,
                                    n_buckets=cfg.n_buckets,
                                    n_reps=cfg.n_reps, loss=cfg.loss))
        idx, w = jeng.round_batches(nq, self.config.seed,
                                    self._round_counter)
        self._n = cfg.n_labels
        return (torch.from_numpy(np.array(idx)).long(),
                torch.from_numpy(np.array(w)))

    def _round_orders(self, state):
        return torch.from_numpy(_reference_orders(
            self.config.seed, self._round_counter - 1, self._n,
            self.index.cfg.n_reps))


def _drive(loop_cls, cfg_cls, midx, qs, ids, **kw):
    qlog = (JO if loop_cls is JLoop else TO).QueryLog(capacity=1024)
    qlog.record(qs, ids)
    loop = loop_cls(midx, qlog, config=cfg_cls(min_queries=1, seed=1, **kw),
                    registry=midx.registry)
    return loop, loop.run_cycle()


# ------------------------------------------------------------ the digest --
@pytest.mark.parametrize("store", ["fp32", "int8", "bf16"])
def test_digest_is_equal_across_packages(fitted, data, store):
    jm, tm = _pair(fitted, data, store_dtype=store)
    for m in (jm, tm):
        m.insert(data.base[N_INIT:N_INIT + 30])
        m.delete(np.arange(0, 40, 3))
    ja = JArtifact.from_mutable(jm, version=5)
    ta = IndexArtifact.from_mutable(tm, version=5)
    assert ta.meta == ja.meta and ta.n_total == ja.n_total
    assert ta.checksum == ja.checksum
    ta.verify()
    assert ta.with_version(6).checksum == ja.with_version(6).checksum
    hist = np.arange(64, dtype=np.float32)
    js = JArtifact.from_snapshot(jm.snapshot, jm.cfg, version=7,
                                 capacity=jm.capacity, sketch=hist,
                                 sketch_planes=6, sketch_seed=2)
    ts = IndexArtifact.from_snapshot(tm.snapshot, tm.cfg, version=7,
                                     capacity=tm.capacity, sketch=hist,
                                     sketch_planes=6, sketch_seed=2)
    assert ts.checksum == js.checksum


def test_from_index_and_tamper_is_refused(fitted, data, tmp_path):
    jidx, tidx = fitted
    ja = JArtifact.from_index(jidx, data.base[:N_INIT], version=1,
                              store_dtype="int8")
    ta = IndexArtifact.from_index(tidx, data.base[:N_INIT], version=1,
                                  store_dtype="int8")
    assert ta.checksum == ja.checksum
    bad = dataclasses.replace(ta, load=ta.load + 1)
    with pytest.raises(ArtifactIntegrityError, match="does not match"):
        bad.verify()
    bad.reseal().verify()
    mgr = CheckpointManager(str(tmp_path / "t"))
    ta.save(mgr)
    mgr.wait()
    again = IndexArtifact.restore(mgr, device="cpu")
    assert again.checksum == ta.checksum and again.digest() == ta.checksum
    # a manifest whose artifact checksum was altered: content refused
    import json
    import os
    step = os.path.join(str(tmp_path / "t"), f"step_{1:012d}")
    man = json.load(open(os.path.join(step, "manifest.json")))
    man["extra"]["checksum"] = "0" * 64
    json.dump(man, open(os.path.join(step, "manifest.json"), "w"))
    with pytest.raises(ArtifactIntegrityError):
        IndexArtifact.restore(mgr, 1, device="cpu")
    # a flipped byte in the npz: the manager's own digest refuses it
    path = os.path.join(step, "arrays.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        IndexArtifact.restore(mgr, 1, device="cpu")


# ------------------------------------------------------ across packages --
@pytest.mark.parametrize("store", ["int8", "bf16"])
def test_artifacts_cross_between_packages_and_serve(fitted, data, tmp_path,
                                                    store):
    """A JAX-sealed refit artifact restores in the port and serves there as
    in JAX; the same artifact sealed by the port restores and serves in
    JAX."""
    jm, tm = _pair(fitted, data, store_dtype=store)
    qs = data.queries
    jres = jm.search(qs, JParams(**SP, store_dtype=store))
    _, ja = _drive(JLoop, JRefitConfig, jm, qs, np.asarray(jres.ids))
    jmgr = JManager(str(tmp_path / "j"))
    ja.save(jmgr)
    jmgr.wait()
    ta = IndexArtifact.restore(CheckpointManager(str(tmp_path / "j")),
                               device="cpu")
    assert ta.checksum == ja.checksum
    ta.install(tm)
    _same_state(jm, tm)
    _same_search(jm.search(qs, JParams(**SP, store_dtype=store)),
                 tm.search(qs, SearchParams(**SP, store_dtype=store)))
    # the other way: the port seals (the same content), JAX restores
    jm2, tm2 = _pair(fitted, data, store_dtype=store)
    tmgr = CheckpointManager(str(tmp_path / "t"))
    ta.save(tmgr)
    tmgr.wait()
    back = JArtifact.restore(JManager(str(tmp_path / "t")))
    assert back.checksum == ta.checksum
    back.install(jm2)
    ta.install(tm2)
    _same_search(jm2.search(qs, JParams(**SP, store_dtype=store)),
                 tm2.search(qs, SearchParams(**SP, store_dtype=store)))


def test_install_rejects_stale_and_mismatched(fitted, data):
    _, tm = _pair(fitted, data)
    art = IndexArtifact.from_mutable(tm)                # version == epoch
    with pytest.raises(ValueError, match="stale"):
        tm.install_artifact(art)
    bad = IndexArtifact.build(
        version=9, params=art.params, members=art.members, delta=art.delta,
        tombstone=art.tombstone, load=art.load, assign=art.assign,
        vecs=art.vecs, n_total=art.n_total,
        meta={**art.meta_dict, "n_buckets": 64})
    with pytest.raises(ValueError, match="n_buckets"):
        tm.install_artifact(bad)
    with pytest.raises(TypeError, match="install_artifact"):
        art.install(object())
    with pytest.raises(ValueError, match="stale"):
        fitted[1].install_artifact(dataclasses.replace(art, version=0))


def test_tail_replacement_and_late_deletes_give_the_references_load(
        fitted, data):
    """Inserts and deletes that arrive after the artifact was built: the
    tail is re-placed under the new scorer and the late deletes' loads are
    re-applied, to the reference's state bit for bit."""
    jm, tm = _pair(fitted, data, store_dtype="int8")
    qs = data.queries
    res = jm.search(qs, JParams(**SP, store_dtype="int8"))
    qlog = JO.QueryLog(capacity=1024)
    qlog.record(qs, np.asarray(res.ids))
    jl = JLoop(jm, qlog, config=JRefitConfig(min_queries=1, seed=1),
               registry=jm.registry)
    # build the artifact without installing it: the reference's own steps
    real_install = jm.install_artifact
    box = {}
    jm.install_artifact = lambda a: box.setdefault("art", a)
    jl.run_cycle()
    jm.install_artifact = real_install
    for m in (jm, tm):
        m.insert(data.base[N_INIT:N_INIT + 40])
        m.delete(np.concatenate([np.arange(0, 30), [N_INIT + 3]]))
    ja = box["art"].with_version(jm.epoch + 1)       # past the mutations
    ta = _carry(ja)
    jm.install_artifact(ja)
    tm.install_artifact(ta)
    _same_state(jm, tm)
    s = tm.snapshot
    assert int(s.load.sum()) == 2 * (N_INIT + 40 - 31)
    assert tm.registry.counter("stream_swaps_total").value == 1
    own = tm.search(data.base[N_INIT + 5:N_INIT + 40],
                    SearchParams(**SP, store_dtype="int8"))
    assert (own.ids[:, 0].numpy()
            == np.arange(N_INIT + 5, N_INIT + 40)).mean() >= 0.9


def _carry(ja):
    """A JAX artifact's arrays as the port's, in memory."""
    from repro.store.quantized import store_to_arrays as j_store_to_arrays
    from repro_torch.store.quantized import store_from_arrays
    from repro_torch.stream.delta import DeltaState

    def t(a, dt):
        return torch.from_numpy(np.array(a)).to(dt)

    store = None
    if ja.store is not None:
        store = store_from_arrays(
            jax.tree.map(np.asarray, j_store_to_arrays(ja.store)),
            ja.store.dtype, ja.store.block)
    return IndexArtifact(
        version=ja.version,
        params={k: t(v, torch.float32) for k, v in ja.params.items()},
        members=t(ja.members, torch.int32),
        delta=DeltaState(t(ja.delta.members, torch.int32),
                         t(ja.delta.fill, torch.int32)),
        tombstone=t(ja.tombstone, torch.bool), load=t(ja.load, torch.int32),
        assign=t(ja.assign, torch.int32), vecs=t(ja.vecs, torch.float32),
        n_total=ja.n_total, meta=ja.meta, store=store,
        checksum=ja.checksum)


def test_frozen_index_install_matches_reference(fitted, data):
    jidx, _ = fitted
    jm, _ = _pair(fitted, data)
    jm.delete(np.arange(0, 60, 2))
    ja = JArtifact.from_mutable(jm, version=3)
    jfresh = IRLIIndex(jidx.cfg)
    jfresh.params, jfresh.assign = jidx.params, jidx.assign
    jfresh.build_index()
    tfresh, _ = convert.from_reference(
        jidx.cfg, params={k: np.asarray(v) for k, v in jidx.params.items()},
        assign=np.asarray(jidx.assign), device="cpu")
    jfresh.install_artifact(ja)
    tfresh.install_artifact(_carry(ja))
    assert tfresh.epoch == jfresh.epoch == 3
    np.testing.assert_array_equal(tfresh.index.members.numpy(),
                                  np.asarray(jfresh.index.members))
    np.testing.assert_array_equal(tfresh.index.load.numpy(),
                                  np.asarray(jfresh.index.load))
    base = data.base[:N_INIT]
    jr = jfresh.search(data.queries, base, JParams(**SP))
    tr = tfresh.search(data.queries, base, SearchParams(**SP))
    _same_search(jr, tr)
    with pytest.raises(ValueError, match="stale"):
        tfresh.install_artifact(_carry(ja))


# ---------------------------------------------------------------- policy --
@pytest.mark.parametrize("hot_frac,rl", [(0.05, 8), (0.25, 3)])
def test_build_replicas_is_equal(fitted, data, hot_frac, rl):
    jidx, tidx = fitted
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 100, 2 * 32).astype(np.float64)
    tomb = np.zeros(N_INIT, bool)
    tomb[rng.choice(N_INIT, 50, replace=False)] = True
    want = np.asarray(j_build_replicas(
        jidx.params, jnp.asarray(data.base[:N_INIT]), jidx.index.members,
        jnp.asarray(tomb), counts, hot_frac=hot_frac, replica_len=rl))
    got = build_replicas(tidx.params, torch.from_numpy(data.base[:N_INIT]),
                         tidx.index.members, torch.from_numpy(tomb),
                         torch.from_numpy(counts), hot_frac=hot_frac,
                         replica_len=rl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    from repro.online.policy import hot_buckets as j_hot
    np.testing.assert_array_equal(hot_buckets(counts, 2, 32, hot_frac),
                                  j_hot(counts, 2, 32, hot_frac))


def test_build_replicas_ties_take_the_host_argsort(fitted, data):
    """Every logit doubled (each w2 column twice): every row ties, and each
    takes np.argsort on its own host copy, as the reference does for
    every row."""
    from repro_torch.core.network import scorer_logits
    _, tidx = fitted
    p = {k: v.clone() for k, v in tidx.params.items()}
    p["w2"][..., 1::2] = p["w2"][..., 0::2]
    p["b2"][..., 1::2] = p["b2"][..., 0::2]
    vecs = torch.from_numpy(data.base[:N_INIT])
    mem = tidx.index.members
    tomb = torch.zeros(N_INIT, dtype=torch.bool)
    counts = np.arange(2 * 32, dtype=np.float64)
    got = build_replicas(p, vecs, mem, tomb, counts, hot_frac=0.1,
                         replica_len=8).numpy()
    want = np.full_like(got, -1)
    fill = np.zeros((2, 32), np.int64)
    for r in range(2):
        p_r = {k: v[r:r + 1] for k, v in p.items()}
        for b in hot_buckets(counts, 2, 32, 0.1)[r]:
            ids = mem[r, b].numpy()
            ids = ids[ids >= 0]
            lg = scorer_logits(p_r, vecs[torch.from_numpy(ids).long()])[0]
            top2 = np.argsort(-lg.numpy(), axis=1)[:, :2]
            second = np.where(top2[:, 0] == b, top2[:, 1], top2[:, 0])
            for i, b2 in zip(ids, second):
                if fill[r, b2] < 8:
                    want[r, b2, fill[r, b2]] = i
                    fill[r, b2] += 1
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any()


# ----------------------------------------------------------------- refit --
@pytest.mark.parametrize("hot_frac", [0.0, 0.1])
def test_refit_cycle_matches_reference_with_injected_orders(fitted, data,
                                                            hot_frac):
    """One cycle over the same drained traffic: the round's loss within
    1e-4, at least 95% of the new assignments equal, the artifact's
    version, ML and gauges the reference's; the swap serves the new
    epoch."""
    jm, tm = _pair(fitted, data, store_dtype="int8")
    qs = data.queries
    ids = np.asarray(jm.search(qs, JParams(**SP, store_dtype="int8")).ids)
    jl, ja = _drive(JLoop, JRefitConfig, jm, qs, ids, hot_frac=hot_frac)
    tl, ta = _drive(_Injected, RefitConfig, tm, qs, ids, hot_frac=hot_frac)
    jg, tg = jm.registry, tm.registry
    assert tg.gauge("refit_loss").value == pytest.approx(
        jg.gauge("refit_loss").value, rel=1e-4)
    n = ta.n_total
    same = (ta.assign[:, :n].numpy() == np.asarray(ja.assign)[:, :n]).mean()
    assert same >= 0.95, same
    assert ta.version == ja.version == tm.epoch == 1
    assert ta.members.shape[-1] >= jm.snapshot.members.shape[-1] - 8
    assert (ta.replicas is None) == (hot_frac == 0.0)
    assert sorted(k for k in tg.snapshot() if k.startswith("refit_")) == \
        sorted(k for k in jg.snapshot() if k.startswith("refit_"))
    res = tm.search(qs, SearchParams(**SP, store_dtype="int8"))
    assert res.epoch == 1 and (res.ids[:, 0] >= 0).all()
    if hot_frac:
        hot = tm.search(qs, SearchParams(**SP, store_dtype="int8",
                                         hot_replicas=True))
        assert hot.epoch == 1


def test_searches_during_a_cycle_are_bit_equal_until_the_swap(fitted, data,
                                                              tmp_path):
    """The rounds train copies: searches before the swap keep the old
    scorer bit for bit, and the index's own scorer tensors are never
    written. The same cycle on a 1 x 1 fit mesh (a one-rank gloo group)
    seals the same artifact, bit for bit."""
    _, tm = _pair(fitted, data)
    qs = data.queries
    sp = SearchParams(**SP)
    before = tm.search(qs, sp)
    w2 = tm.params["w2"].clone()
    seen = []

    class Loop(OnlineRefitLoop):
        def _build_artifact(self, state, s, n, sketch_hist=None):
            seen.append(tm.search(qs, sp))        # mid-cycle, pre-swap
            return super()._build_artifact(state, s, n, sketch_hist)

    qlog = TO.QueryLog(capacity=256)
    qlog.record(qs, before.ids)
    art = Loop(tm, qlog, config=RefitConfig(min_queries=1),
               registry=tm.registry).run_cycle()
    mid = seen[0]
    assert torch.equal(mid.ids, before.ids)
    assert torch.equal(mid.scores, before.scores)
    assert mid.epoch == before.epoch == 0
    assert torch.equal(fitted[1].params["w2"], w2)
    assert not torch.equal(art.params["w2"], w2)
    assert tm.search(qs, sp).epoch == art.version == 1
    from repro_torch.launch.mesh import make_fit_mesh
    from torch_dist_ranks import one_rank_group
    _, tm2 = _pair(fitted, data)
    qlog2 = TO.QueryLog(capacity=256)
    qlog2.record(qs, before.ids)
    with one_rank_group(tmp_path):
        art2 = OnlineRefitLoop(
            tm2, qlog2, config=RefitConfig(min_queries=1),
            registry=tm2.registry,
            mesh=make_fit_mesh(1, device_type="cpu")).run_cycle()
    assert torch.equal(art2.assign, art.assign)
    assert all(torch.equal(art2.params[k], art.params[k])
               for k in art.params)


def test_background_loop_starts_fires_and_stops(fitted, data):
    _, tm = _pair(fitted, data)
    qlog = TO.QueryLog(capacity=256)
    qlog.record(data.queries, tm.search(data.queries,
                                        SearchParams(**SP)).ids)
    drift = TO.DriftDetector(TO.QuerySketch(D, 4, 0),
                             registry=tm.registry)
    loop = OnlineRefitLoop(tm, qlog, config=RefitConfig(
        interval_s=0.05, min_queries=8), registry=tm.registry, drift=drift)
    assert loop.should_fire(0.0) is None
    assert loop.should_fire(1.0) == "interval"
    loop.start()
    with pytest.raises(RuntimeError, match="already started"):
        loop.start()
    try:
        t0 = time.monotonic()
        while tm.registry.counter("refit_cycles_total").value < 1:
            assert time.monotonic() - t0 < 60, "the loop never fired"
            time.sleep(0.02)
    finally:
        loop.stop()
    assert loop._thread is None and tm.epoch >= 1
    assert drift.reference is not None           # re-anchored on the swap
    assert threading.active_count() < 50
