"""The port's streaming mutable index against the JAX package's, on the CPU.

tests/test_streaming.py's fitted index is carried across with
repro_torch.convert, and both packages' MutableIRLIIndex replay the same
inserts, deletes, compactions and searches on the same numpy arrays. The
state (ids, loads, assignment, members, delta segments, tombstones, epoch,
store codes) must be equal at every step, search ids and n_candidates equal
and scores within 1e-5 + 1e-5·|b|.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import (  # noqa: E402
    CheckpointManager as JManager)
from repro.core.index import IRLIConfig, IRLIIndex  # noqa: E402
from repro.core.network import scorer_logits  # noqa: E402
from repro.core.search_api import PipelineCache as JCache  # noqa: E402
from repro.core.search_api import SearchParams as JParams  # noqa: E402
from repro.data.synthetic import _topk_l2, clustered_ann  # noqa: E402
from repro.obs import MetricRegistry as JRegistry  # noqa: E402
from repro.store.quantized import encode as jencode  # noqa: E402
from repro.stream import MutableIRLIIndex as JMutable  # noqa: E402
from repro.stream import mutable_index as JMI  # noqa: E402
from repro.stream.delta import delta_append as j_delta_append  # noqa: E402
from repro.stream.delta import delta_init as j_delta_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    CheckpointCorruptError, CheckpointManager)
from repro_torch.core.search_api import PipelineCache, SearchParams  # noqa: E402,E501
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.obs import MetricRegistry  # noqa: E402
from repro_torch.store.quantized import encode  # noqa: E402
from repro_torch.stream import MutableIRLIIndex  # noqa: E402
from repro_torch.stream import mutable_index as TMI  # noqa: E402
from repro_torch.stream.delta import (  # noqa: E402
    default_delta_len, delta_append, delta_init)

D, N_INIT, N_NEW = 16, 1000, 150
M_PROBE = 4          # probes >= K insertion choices: self-queries hit


@pytest.fixture(scope="module")
def data():
    return clustered_ann(n_base=N_INIT + N_NEW, n_queries=50, d=D,
                         n_clusters=40, seed=0)


@pytest.fixture(scope="module")
def fitted(data):
    """tests/test_streaming.py's fitted JAX index, and the port's copy."""
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
    jreg, treg = kw.pop("jreg", None), kw.pop("treg", None)
    jm = JMutable(jidx, data.base[:N_INIT], registry=jreg, **kw)
    tm = MutableIRLIIndex(tidx, data.base[:N_INIT], registry=treg, **kw)
    return jm, tm


def _state(jm):
    """The JAX index's state_dict and meta as numpy."""
    return jax.tree.map(np.asarray, jm.state_dict()), jm.meta()


def _same_state(jm, tm):
    jt, jmeta = _state(jm)
    tt, tmeta = convert.stream_state_to_reference(tm)
    assert tmeta == jmeta
    assert sorted(tt["stream"]) == sorted(jt["stream"])
    for name, ref in jt["stream"].items():
        got = tt["stream"][name]
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for name, ref in jt["scorer"].items():
        np.testing.assert_array_equal(tt["scorer"][name], ref, err_msg=name)
    assert tm.n_live == jm.n_live and tm.epoch == jm.epoch


def _same_search(jres, tres):
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_array_equal(tres.n_candidates.numpy(),
                                  np.asarray(jres.n_candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores),
                               rtol=1e-5, atol=1e-5)
    assert tres.epoch == jres.epoch and tres.mode == jres.mode
    assert (tres.ids >= 0).any()


# ------------------------------------------------------------------ delta --
@pytest.mark.parametrize("DL,n", [(8, 20), (3, 40)])
def test_delta_append_matches_reference(DL, n):
    """Two appends into [2, 6, DL] segments. At DL = 8 the first fits; at
    DL = 3 the batches overflow: ok is False, and no write lands past a
    segment's end."""
    rng = np.random.default_rng(DL)
    R, B = 2, 6
    jd, td = j_delta_init(R, B, DL), delta_init(R, B, DL)
    oks = []
    for start in (0, n):
        buckets = rng.integers(0, B, (R, n)).astype(np.int32)
        ids = np.arange(100 + start, 100 + start + n, dtype=np.int32)
        jd, jok = j_delta_append(jd, jax.numpy.asarray(buckets),
                                 jax.numpy.asarray(ids))
        td, tok = delta_append(td, torch.from_numpy(buckets),
                               torch.from_numpy(ids))
        assert bool(tok) == bool(jok)
        oks.append(bool(tok))
        assert td.members.dtype == torch.int32
        np.testing.assert_array_equal(td.members.numpy(),
                                      np.asarray(jd.members))
        np.testing.assert_array_equal(td.fill.numpy(), np.asarray(jd.fill))
    assert oks[0] if DL == 8 else not any(oks)
    assert default_delta_len(2000, 1000, 32) == 2 * 32 + 8


# -------------------------------------------------------------- placement --
def test_placement_is_bit_equal_to_reference(fitted, data):
    """The port places by the stable top-K of the logits (one irli_topk
    launch on the card) where the reference takes the top-K of the
    probabilities: the same buckets, given the same live loads, for every
    (rep, item), padding rows included as weight-0 rows."""
    jm, tm = _pair(fitted, data)
    jm.insert(data.base[N_INIT:N_INIT + 40])
    tm.insert(data.base[N_INIT:N_INIT + 40])
    js, ts = jm.snapshot, tm.snapshot
    vecs = np.zeros((128, D), np.float32)
    vecs[:100] = data.base[N_INIT + 40:N_INIT + 140]
    valid = np.arange(128) < 100
    cfg = jm.cfg
    jb = JMI._score_and_place(js.params, js.load.astype(jax.numpy.float32),
                              jax.numpy.asarray(vecs),
                              jax.numpy.asarray(valid), B=cfg.n_buckets,
                              K=cfg.K, loss_kind=cfg.loss)
    tb = TMI._score_and_place(ts.params, ts.load.float(),
                              torch.from_numpy(vecs), torch.from_numpy(valid),
                              B=cfg.n_buckets, K=cfg.K)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # the logits' top-K is the probabilities' top-K here: no two of an
    # item's K best logits round to one probability
    probs = np.asarray(jax.nn.softmax(scorer_logits(js.params, vecs),
                                      axis=-1))
    top = np.sort(probs, axis=-1)[..., ::-1][..., :cfg.K + 1]
    assert not (top[..., 1:] == top[..., :-1]).any(), \
        "two probabilities tie that are distinct as logits"


# -------------------------------------------------------------- sequences --
SEQ_CASES = [("dense", "fp32"), ("compact", "fp32"), ("compact", "int8"),
             ("mega", "fp32"), ("mega", "int8"), ("compact", "bf16")]


@pytest.mark.parametrize("mode,store_dtype", SEQ_CASES)
def test_insert_delete_compact_search_matches_reference(fitted, data, mode,
                                                        store_dtype):
    """Insert, delete (base and inserted ids), search, insert more,
    compact, search, delete again, search: the same state and the same
    results as the JAX index after every step."""
    jm, tm = _pair(fitted, data, store_dtype=store_dtype)
    jp = JParams(m=M_PROBE, tau=2, k=10, mode=mode, store_dtype=store_dtype)
    tp = SearchParams(m=M_PROBE, tau=2, k=10, mode=mode,
                      store_dtype=store_dtype)
    q = data.queries
    new = data.base[N_INIT:]

    def both(fn):
        return fn(jm), fn(tm)

    ji, ti = both(lambda mi: mi.insert(new[:90]))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    _same_state(jm, tm)
    dels = np.r_[np.arange(0, 60, 3), N_INIT + np.arange(0, 90, 7)]
    assert both(lambda mi: mi.delete(dels)) == (len(dels), len(dels))
    _same_state(jm, tm)
    _same_search(jm.search(q, jp), tm.search(q, tp))
    both(lambda mi: mi.insert(new[90:]))
    _same_state(jm, tm)
    pre = tm.search(q, tp)
    _same_search(jm.search(q, jp), pre)
    both(lambda mi: mi.compact())
    _same_state(jm, tm)
    post = tm.search(q, tp)
    _same_search(jm.search(q, jp), post)
    assert torch.equal(pre.ids, post.ids) and torch.equal(pre.scores,
                                                          post.scores)
    assert not np.isin(post.ids.numpy(), dels).any()
    assert both(lambda mi: mi.delete(np.arange(N_INIT, N_INIT + 30))) \
        == (25, 25)                       # 5 of them were deleted already
    assert both(lambda mi: mi.delete(dels)) == (0, 0)
    _same_state(jm, tm)
    _same_search(jm.search(q, jp), tm.search(q, tp))


def test_compaction_is_exact_and_idempotent(fitted, data):
    _, tm = _pair(fitted, data)
    tm.insert(data.base[N_INIT:])
    tm.delete(np.arange(40))
    sp = SearchParams(m=M_PROBE, tau=2, k=10)
    ref = tm.search(data.queries, sp)
    e0 = tm.epoch
    tm.compact()
    assert tm.epoch == e0 + 1
    snap1 = tm.snapshot
    out1 = tm.search(data.queries, sp)
    assert torch.equal(ref.ids, out1.ids)
    assert torch.equal(ref.scores, out1.scores)
    tm.compact()
    snap2 = tm.snapshot
    assert torch.equal(snap1.members, snap2.members)
    assert torch.equal(snap1.load, snap2.load)
    assert int(snap2.load[0].sum()) == N_INIT + N_NEW - 40
    # the sentinel bucket overflowed (it holds every unused and dead slot)
    # and changed nothing: every live id sits in its bucket once per rep
    for r in range(2):
        got = snap2.members[r][snap2.members[r] >= 0]
        live = torch.arange(N_INIT + N_NEW)[~snap2.tombstone[:N_INIT + N_NEW]]
        assert torch.equal(torch.sort(got).values, live)
    assert torch.equal(tm.search(data.queries, sp).ids, ref.ids)


@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_exact_oracle_matches_reference(fitted, data, metric):
    jm, tm = _pair(fitted, data)
    for mi in (jm, tm):
        mi.insert(data.base[N_INIT:])
        mi.delete(np.arange(0, 200, 3))
    reset_launches()
    got = tm.exact_oracle(10, metric)(data.queries)
    assert sum(LAUNCHES.values()) == 0          # the plain version, on CPU
    ref = jm.exact_oracle(10, metric)(data.queries)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert not np.isin(got, np.arange(0, 200, 3)).any()


def test_query_members_matches_reference(fitted, data):
    jm, tm = _pair(fitted, data)
    for mi in (jm, tm):
        mi.insert(data.base[N_INIT:])
        mi.delete(np.arange(0, 100, 2))
    jmask, jfreq, jn = jm.query(data.queries, m=M_PROBE, tau=2)
    tmask, tfreq, tn = tm.query(data.queries, m=M_PROBE, tau=2)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tfreq.numpy(), np.asarray(jfreq))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_capacity_is_enforced(fitted, data):
    _, tm = _pair(fitted, data, capacity=N_INIT + 10)
    with pytest.raises(ValueError, match="capacity exceeded"):
        tm.insert(data.base[N_INIT:N_INIT + 11])
    assert tm.insert(data.base[:0]).numel() == 0


@pytest.mark.parametrize("delta_len", [4, 2])
def test_overflow_compacts_and_splits_like_reference(fitted, data,
                                                     delta_len):
    """Tiny segments: the insert compacts on overflow and, where the batch
    cannot fit even the empty segments, splits it; the epochs, state and
    results follow the reference's step for step."""
    jm, tm = _pair(fitted, data, delta_len=delta_len)
    e0 = tm.epoch
    ji, ti = jm.insert(data.base[N_INIT:]), tm.insert(data.base[N_INIT:])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tm.epoch > e0 + 1
    _same_state(jm, tm)
    sp = dict(m=M_PROBE, tau=1, k=10)
    _same_search(jm.search(data.base[N_INIT:], JParams(**sp)),
                 tm.search(data.base[N_INIT:], SearchParams(**sp)))


def test_single_insert_too_large_for_a_segment_raises(fitted, data):
    _, tm = _pair(fitted, data, delta_len=0)
    with pytest.raises(RuntimeError, match="increase delta_len"):
        tm.insert(data.base[N_INIT:N_INIT + 1])


def test_registry_and_cache_stats_match_reference(fitted, data):
    """The stream_* counters and gauges and PipelineCache.stats() after the
    same sequence: equal to the reference's (the cache counts a compile at
    the first run of each argument signature, where jax.jit traces)."""
    jreg, treg = JRegistry(), MetricRegistry()
    jm, tm = _pair(fitted, data, jreg=jreg, treg=treg, delta_len=6)
    jc, tc = JCache(registry=jreg), PipelineCache(registry=treg)
    sp = dict(m=M_PROBE, tau=1, k=10)
    seq = [("insert", data.base[N_INIT:N_INIT + 100]), ("search", sp),
           ("delete", np.arange(0, 50, 5)), ("search", sp),
           ("search", dict(sp, mode="compact")), ("compact", None),
           ("search", sp), ("insert", data.base[N_INIT + 100:]),
           ("delete", np.arange(N_INIT, N_INIT + 20)), ("search", sp)]
    for op, arg in seq:
        if op == "search":
            jm.search(data.queries, JParams(**arg), cache=jc)
            tm.search(data.queries, SearchParams(**arg), cache=tc)
        elif op == "compact":
            jm.compact()
            tm.compact()
        else:
            getattr(jm, op)(arg)
            getattr(tm, op)(arg)
    assert tc.stats() == jc.stats()
    assert tc.stats()["compiles"] >= 2
    js, ts = jreg.snapshot(), treg.snapshot()
    names = [n for n in js if n.startswith(("stream_", "cache_"))]
    assert sorted(n for n in ts if n.startswith(("stream_", "cache_"))) \
        == sorted(names)
    for n in names:
        if js[n]["type"] == "histogram":
            assert ts[n]["count"] == js[n]["count"], n
        else:
            assert ts[n]["value"] == pytest.approx(js[n]["value"],
                                                   rel=1e-6), n


def test_legacy_kwargs_shim_warns_and_returns_the_old_tuple(fitted, data):
    _, tm = _pair(fitted, data)
    with pytest.warns(DeprecationWarning, match="SearchParams"):
        ids, n_cand = tm.search(data.queries, m=M_PROBE, tau=1, k=5)
    res = tm.search(data.queries, SearchParams(m=M_PROBE, tau=1, k=5))
    assert torch.equal(ids, res.ids) and torch.equal(n_cand,
                                                     res.n_candidates)
    with pytest.raises(TypeError, match="either SearchParams"):
        tm.search(data.queries, SearchParams(), k=5)
    staged = tm.search(data.queries, SearchParams(), staged=True)
    plain = tm.search(data.queries, SearchParams())
    assert torch.equal(staged.ids, plain.ids)
    assert torch.equal(staged.scores, plain.scores)
    assert staged.epoch == plain.epoch


@pytest.mark.parametrize("dtype", ["int8", "bf16", "fp32"])
def test_store_append_matches_reference(dtype):
    """QuantizedStore.append: codes and scales equal to the reference's
    append, and to a full encode of the same rows."""
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(40, 64)).astype(np.float32)
    rows[7, :32] = 0.0                               # an all-zero block
    ids = np.array([3, 11, 12, 30, 39, 0], np.int32)
    buf = np.zeros_like(rows)
    t = encode(torch.from_numpy(buf), dtype, 32).append(
        torch.from_numpy(ids), torch.from_numpy(rows[ids]))
    j = jencode(buf, dtype, 32).append(ids, rows[ids])
    full = buf.copy()
    full[ids] = rows[ids]
    f = encode(torch.from_numpy(full), dtype, 32)
    assert torch.equal(t.codes, f.codes)
    np.testing.assert_array_equal(t.codes.float().numpy(),
                                  np.asarray(j.codes.astype(np.float32)))
    if dtype == "int8":
        assert torch.equal(t.scales, f.scales)
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    else:
        assert t.scales is None and j.scales is None


@pytest.mark.parametrize("store_dtype", ["fp32", "int8", "bf16"])
def test_checkpoint_round_trip_both_ways(tmp_path, fitted, data,
                                         store_dtype):
    """A checkpoint the port writes restores in the reference, and one the
    reference writes restores in the port; each then searches as the
    index that wrote it."""
    jm, tm = _pair(fitted, data, store_dtype=store_dtype)
    for mi in (jm, tm):
        mi.insert(data.base[N_INIT:])
        mi.delete(np.arange(25))
    sp = dict(m=M_PROBE, tau=1, k=10, store_dtype=store_dtype)
    ref = tm.search(data.queries, SearchParams(**sp))

    tm.save(CheckpointManager(str(tmp_path / "port"), keep=2), step=7)
    step, tree, manifest = JManager(str(tmp_path / "port")).restore_latest()
    jr, tr = _pair(fitted, data, store_dtype=store_dtype)
    jr.load_state(tree, manifest["extra"])
    assert step == 7 and jr.n_total == tm.n_total and jr.epoch == tm.epoch
    _same_search(jr.search(data.queries, JParams(**sp)), ref)

    jm.save(JManager(str(tmp_path / "jax"), keep=2), step=3)
    step, tree, manifest = CheckpointManager(
        str(tmp_path / "jax")).restore_latest()
    tr.load_state(tree, manifest["extra"])
    assert step == 3
    _same_state(jm, tr)
    _same_search(jm.search(data.queries, JParams(**sp)),
                 tr.search(data.queries, SearchParams(**sp)))


def test_checkpoint_refuses_corruption_and_config_mismatch(tmp_path, fitted,
                                                           data):
    _, tm = _pair(fitted, data)
    cm = CheckpointManager(str(tmp_path), keep=3)
    tm.save(cm, step=1)
    tm.insert(data.base[N_INIT:N_INIT + 5])
    tm.save(cm, step=2)
    path = tmp_path / "step_000000000002" / "arrays.npz"
    path.write_bytes(path.read_bytes()[:100])        # a torn write
    with pytest.raises(CheckpointCorruptError):
        cm.restore(2)
    with pytest.warns(UserWarning, match="corrupt"):
        step, tree, manifest = cm.restore_latest()
    assert step == 1
    _, other = _pair(fitted, data, capacity=N_INIT + 500)
    with pytest.raises(ValueError, match="capacity"):
        other.load_state(tree, manifest["extra"])
    _, q8 = _pair(fitted, data, store_dtype="int8")
    with pytest.raises(ValueError, match="no quantized store"):
        q8.load_state(tree, {k: v for k, v in manifest["extra"].items()
                             if k != "store_dtype"})


def test_stream_state_carries_across_in_both_directions(fitted, data):
    """convert.stream_state_from_reference / stream_state_to_reference:
    a JAX index's mid-sequence state becomes the port's snapshot, and the
    port's becomes the JAX index's, each searching alike."""
    jm, tm = _pair(fitted, data, store_dtype="int8")
    jm.insert(data.base[N_INIT:])
    jm.delete(np.arange(0, 300, 4))
    tree, meta = _state(jm)
    snap = convert.stream_state_from_reference(tree, meta, device="cpu")
    assert snap.n_total == jm.n_total and snap.store.dtype == "int8"
    tm.load_state(tree, meta)
    _same_state(jm, tm)
    sp = dict(m=M_PROBE, tau=2, k=10, store_dtype="int8")
    _same_search(jm.search(data.queries, JParams(**sp)),
                 tm.search(data.queries, SearchParams(**sp)))
    tm.insert(data.base[:20] + 0.01)
    jr, _ = _pair(fitted, data, store_dtype="int8")
    jr.load_state(*convert.stream_state_to_reference(tm))
    _same_state(jr, tm)
