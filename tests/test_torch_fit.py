"""The port's Alg. 1 fit against the JAX package, on the CPU: the loss and
its gradients, targets and loads, power-of-K re-assignment, the streamed
affinity, AdamW and clipping, the batch plan, one whole round from a
converted JAX state, the whole fit, and the state carried across both ways.
The same numpy inputs go through both; integers exact, floats to the stated
tolerance. JAX's random streams (batch order, insertion order) are injected
where a test compares trajectories."""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.irli_deep1b import fit_config  # noqa: E402
from repro.core import network as JN  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.core import repartition as JR  # noqa: E402
from repro.core.index import IRLIIndex as JIndex  # noqa: E402
from repro.core.search_api import SearchParams as JSP  # noqa: E402
from repro.data.synthetic import clustered_ann as j_clustered  # noqa: E402
from repro.fit import affinity as JA  # noqa: E402
from repro.fit.engine import FitData as JFitData  # noqa: E402
from repro.fit.engine import FitEngine as JEngine  # noqa: E402
from repro.fit.state import FitState as JFitState  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import network as TN  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core import repartition as TR  # noqa: E402
from repro_torch.core.index import IRLIConfig, IRLIIndex  # noqa: E402
from repro_torch.core.search_api import SearchParams as TSP  # noqa: E402
from repro_torch.data.synthetic import clustered_ann  # noqa: E402
from repro_torch.fit import affinity as TA  # noqa: E402
from repro_torch.fit.engine import FitData, FitEngine  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.irli_topk.ref import near  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

KEYS = ("b1", "b2", "w1", "w2")


def _cfg(**kw):
    base = dict(d=16, n_labels=300, n_buckets=24, n_reps=3, d_hidden=32,
                K=4, rounds=2, epochs_per_round=2, batch_size=64, lr=2e-3,
                affinity_chunk=64, seed=0)
    base.update(kw)
    return IRLIConfig(**base)


def _params(R, d, H, B, seed=0):
    """Reference-initialised params with non-zero biases, as numpy."""
    scfg = JN.ScorerConfig(d_in=d, d_hidden=H, n_buckets=B, n_reps=R)
    p = JN.scorer_init(jax.random.PRNGKey(seed), scfg)
    rng = np.random.default_rng(seed)
    p["b1"] = jnp.asarray(rng.normal(size=(R, H)) * 0.1, jnp.float32)
    p["b2"] = jnp.asarray(rng.normal(size=(R, B)) * 0.1, jnp.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def _t(params: dict, requires_grad=False) -> dict:
    return {k: torch.tensor(v, requires_grad=requires_grad)
            for k, v in params.items()}


# ------------------------------------------------------------- the loss ----
@pytest.mark.parametrize("loss", ["softmax_bce", "sigmoid_bce"])
def test_scorer_loss_parts_and_gradients_match_reference(loss):
    """Loss to 1e-5 relative; gradients of all four parameters (torch
    autograd, through the bce_logits plain version for sigmoid) against
    jax.grad to 1e-5. Zero-weight rows stand for a tail batch's padding."""
    R, d, H, B, N = 3, 16, 32, 40, 12
    params = _params(R, d, H, B)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, d)).astype(np.float32)
    y = (rng.random((R, N, B)) > 0.9).astype(np.float32)
    w = np.ones(N, np.float32)
    w[-4:] = 0.0
    jcfg = JN.ScorerConfig(d_in=d, d_hidden=H, n_buckets=B, n_reps=R,
                           loss=loss)
    tcfg = TN.ScorerConfig(d_in=d, d_hidden=H, n_buckets=B, n_reps=R,
                           loss=loss)
    js, jw = JN.scorer_loss_parts(params, jcfg, jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(w))
    jg = jax.grad(lambda p: JN.scorer_loss(p, jcfg, jnp.asarray(x),
                                           jnp.asarray(y),
                                           jnp.asarray(w)))(params)
    tp = _t(params, True)
    ts, tw = TN.scorer_loss_parts(tp, tcfg, torch.from_numpy(x),
                                  torch.from_numpy(y), torch.from_numpy(w))
    np.testing.assert_allclose(float(ts.detach()), float(js), rtol=1e-5)
    assert float(tw) == float(jw) == N - 4
    tl = TN.scorer_loss(tp, tcfg, torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(w))
    np.testing.assert_allclose(
        float(tl), float(JN.scorer_loss(params, jcfg, jnp.asarray(x),
                                        jnp.asarray(y), jnp.asarray(w))),
        rtol=1e-5)
    tg = torch.autograd.grad(tl, [tp[k] for k in KEYS])
    for k, g in zip(KEYS, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # the fit's form: the normaliser folded into the one pass as ``scale``
    s2, _ = TN.scorer_loss_parts(_t(params), tcfg, torch.from_numpy(x),
                                 torch.from_numpy(y), torch.from_numpy(w),
                                 scale=1.0 / (R * (N - 4)))
    np.testing.assert_allclose(float(s2), float(tl), rtol=1e-6)


# -------------------------------------------------- targets and the loads --
def test_bucket_targets_match_reference_exactly():
    """Duplicate buckets within a row and masked labels: a masked label
    sharing a bucket with a real one still gives 1 (scatter-max), a bucket
    holding only masked labels 0."""
    rng = np.random.default_rng(2)
    R, L, B, N, k = 3, 50, 6, 20, 7
    assign = rng.integers(0, B, (R, L)).astype(np.int32)
    ids = rng.integers(0, L, (N, k)).astype(np.int32)
    ids[0, :] = ids[0, 0]                        # one label repeated
    mask = (rng.random((N, k)) > 0.3).astype(np.float32)
    mask[0, 1:] = 0.0
    mask[1, :] = 0.0                             # a row with no real label
    ref = np.asarray(JP.bucket_targets(jnp.asarray(assign), jnp.asarray(ids),
                                       jnp.asarray(mask), B))
    got = TP.bucket_targets(torch.from_numpy(assign), torch.from_numpy(ids),
                            torch.from_numpy(mask), B)
    assert got.dtype == torch.float32 and got.shape == (R, N, B)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[:, 1].any()


@pytest.mark.parametrize("L,B,R", [(300, 24, 3), (1000, 7, 2)])
def test_load_std_matches_reference(L, B, R):
    assign = np.random.default_rng(L).integers(0, B, (R, L)).astype(np.int32)
    np.testing.assert_allclose(
        float(TP.load_std(torch.from_numpy(assign), B)),
        float(JP.load_std(jnp.asarray(assign), B)), rtol=1e-6)


# ------------------------------------------------------ power-of-K choice --
def _jax_order(seed, L):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), L))


@pytest.mark.parametrize("weighted", [False, True])
def test_kchoice_exact_is_bit_identical_given_the_order(weighted):
    """JAX's own permutation handed to the port; load0 seeds the loads;
    fractional weights make the float32 sums order-sensitive."""
    rng = np.random.default_rng(3)
    L, B, K = 400, 16, 4
    topk = np.stack([rng.permutation(B)[:K] for _ in range(L)]).astype(
        np.int32)
    load0 = rng.integers(0, 5, B).astype(np.float32)
    w = rng.random(L).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(11)
    ref = JR.kchoice_exact(jnp.asarray(topk), B, key, jnp.asarray(load0),
                           None if w is None else jnp.asarray(w))
    reset_launches()
    got = TR.kchoice_exact(torch.from_numpy(topk), B,
                           order=torch.from_numpy(_jax_order(11, L)),
                           load0=torch.from_numpy(load0),
                           weights=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert all(v == 0 for v in LAUNCHES.values())    # the CPU launches none
    # no order and no generator: id order, as the reference without a key
    np.testing.assert_array_equal(
        TR.kchoice_exact(torch.from_numpy(topk), B).numpy(),
        np.asarray(JR.kchoice_exact(jnp.asarray(topk), B)))


def test_kchoice_tiebreak_survives_large_loads():
    """The reference's test_kchoice_tiebreak_survives_large_loads on the
    port: loads near 2^23 leave every placement as at small loads, and
    both equal the reference's."""
    rng = np.random.default_rng(4)
    L, B, K = 64, 8, 4
    topk = np.stack([rng.permutation(B)[:K] for _ in range(L)]).astype(
        np.int32)
    small = rng.integers(0, 5, B).astype(np.float32)
    big = small + np.float32(2 ** 23)
    a_small = TR.kchoice_exact(torch.from_numpy(topk), B,
                               load0=torch.from_numpy(small)).numpy()
    a_big = TR.kchoice_exact(torch.from_numpy(topk), B,
                             load0=torch.from_numpy(big)).numpy()
    np.testing.assert_array_equal(a_small, a_big)
    np.testing.assert_array_equal(a_big, np.asarray(JR.kchoice_exact(
        jnp.asarray(topk), B, load0=jnp.asarray(big))))
    # a strictly smaller load below the old epsilon still wins
    load0 = np.asarray([0.25, np.float32(0.25) - np.float32(6e-8)],
                       np.float32)
    assert int(TR.kchoice_exact(torch.tensor([[0, 1]], dtype=torch.int32), 2,
                                load0=torch.from_numpy(load0))[0]) == 1


@pytest.mark.parametrize("slack", [1.05, 1.3, 2.0])
def test_kchoice_parallel_is_bit_identical(slack):
    rng = np.random.default_rng(5)
    L, B, K = 500, 20, 5
    aff = rng.random((L, B)).astype(np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(aff), K)
    ref = JR.kchoice_parallel(vals, idx, B, slack)
    got = TR.kchoice_parallel(torch.from_numpy(np.asarray(vals)),
                              torch.from_numpy(np.asarray(idx)), B, slack)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["exact", "parallel"])
def test_repartition_topk_and_dense_repartition_match_reference(mode):
    """Given the same top-K (and JAX's per-rep orders), every rep's
    assignment is bit-identical; the dense control agrees too."""
    rng = np.random.default_rng(6)
    R, L, B, K = 3, 120, 16, 4
    aff = rng.random((R, L, B)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JR.repartition(jnp.asarray(aff), K, B, mode, key,
                                    slack=1.3))
    orders = np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(key, r), L)) for r in range(R)])
    vals, idx = jax.lax.top_k(jnp.asarray(aff), K)
    got = TR.repartition_topk(torch.from_numpy(np.asarray(vals)),
                              torch.from_numpy(np.asarray(idx)), B, mode,
                              torch.from_numpy(orders), slack=1.3)
    np.testing.assert_array_equal(got.numpy(), ref)
    dense = TR.repartition(torch.from_numpy(aff), K, B, mode,
                           torch.from_numpy(orders), slack=1.3)
    np.testing.assert_array_equal(dense.numpy(), ref)


def test_insertion_orders_come_from_the_generator():
    a = TR.insertion_orders(3, 50, "cpu", torch.Generator().manual_seed(1))
    b = TR.insertion_orders(3, 50, "cpu", torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (3, 50)
    assert all(torch.equal(torch.sort(r).values, torch.arange(50))
               for r in a)
    assert torch.equal(TR.insertion_orders(2, 5, "cpu")[1],
                       torch.arange(5))


# ----------------------------------------------------- streamed affinity ---
def _agree(vals, idx, rv, ri, wide_v, tol=1e-5):
    """Values to tol; ids equal outside rows with a near tie among the
    top-(K+1) reference values (the port ranks logits, the reference
    probabilities)."""
    np.testing.assert_allclose(vals, rv, rtol=tol, atol=1e-6)
    K = vals.shape[-1]
    w = torch.from_numpy(np.asarray(wide_v))
    tie = near(w[..., 1:], w[..., :-1], tol).any(dim=-1).numpy()
    same = (idx == ri).all(axis=-1)
    assert (same | tie).all(), int((~same & ~tie).sum())
    assert same.mean() > 0.9
    assert K == ri.shape[-1]


@pytest.mark.parametrize("loss", ["softmax_bce", "sigmoid_bce"])
def test_affinity_topk_ann_matches_reference(loss):
    R, d, H, B, L, K = 3, 16, 32, 24, 301, 4
    params = _params(R, d, H, B)
    lv = np.random.default_rng(7).normal(size=(L, d)).astype(np.float32)
    rv, ri = JA.affinity_topk_ann(params, jnp.asarray(lv), K, loss, chunk=64)
    wv, _ = JA.affinity_topk_ann(params, jnp.asarray(lv), K + 1, loss,
                                 chunk=64)
    reset_launches()
    tv, ti = TA.affinity_topk_ann(_t(params), torch.from_numpy(lv), K, loss,
                                  chunk=64)
    assert tv.shape == (R, L, K) and ti.dtype == torch.int32
    assert all(v == 0 for v in LAUNCHES.values())
    _agree(tv.numpy(), ti.numpy(), np.asarray(rv), np.asarray(ri),
           np.asarray(wv))
    # the dense control
    dense = TR.affinity_ann(_t(params), torch.from_numpy(lv), loss)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(JR.affinity_ann(params, jnp.asarray(lv),
                                                  loss)),
        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("loss", ["softmax_bce", "sigmoid_bce"])
def test_affinity_topk_xml_matches_reference(loss):
    R, d, H, B, L, K, N = 3, 16, 32, 24, 100, 4, 120
    params = _params(R, d, H, B)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(N, d)).astype(np.float32)
    pts = np.repeat(np.arange(N), 3)
    labs = rng.integers(0, L, 3 * N)
    jpairs, jchunk = JA.chunk_xml_pairs(pts, labs, L, 32)
    tpairs, tchunk = TA.chunk_xml_pairs(pts, labs, L, 32)
    assert tchunk == jchunk
    for a, b in zip(tpairs, jpairs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rv, ri = JA.affinity_topk_xml(params, jnp.asarray(x), jpairs, L, K, loss,
                                  jchunk)
    wv, _ = JA.affinity_topk_xml(params, jnp.asarray(x), jpairs, L, K + 1,
                                 loss, jchunk)
    tv, ti = TA.affinity_topk_xml(_t(params), torch.from_numpy(x), tpairs, L,
                                  K, loss, tchunk)
    _agree(tv.numpy(), ti.numpy(), np.asarray(rv), np.asarray(ri),
           np.asarray(wv))
    dense = TR.affinity_xml(_t(params), torch.from_numpy(x),
                            torch.from_numpy(pts), torch.from_numpy(labs), L,
                            loss)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(JR.affinity_xml(
            params, jnp.asarray(x), jnp.asarray(pts, jnp.int32),
            jnp.asarray(labs, jnp.int32), L, loss)), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- AdamW, the clip ---
def test_global_norm_and_clip_match_reference():
    params = _params(2, 8, 16, 12)
    g = {k: v * 3.0 for k, v in params.items()}
    ref_sq = float(JO.global_norm_sq(g))
    np.testing.assert_allclose(float(TO.global_norm_sq(_t(g))), ref_sq,
                               rtol=1e-6)
    norm = np.sqrt(ref_sq)
    ref = JO.apply_clip(g, jnp.float32(norm), 1.0)
    got = TO.apply_clip(_t(g), torch.tensor(norm, dtype=torch.float32), 1.0)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)
    same = TO.apply_clip(_t(g), torch.tensor(0.5), 1.0)      # below: kept
    for k in KEYS:
        np.testing.assert_allclose(same[k].numpy(), g[k], rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, weight_decay=0.0, master_fp32=False,
         clip_norm=float("inf")),                  # the fit's optimizer
    dict(lr=3e-3, weight_decay=0.01, master_fp32=True, clip_norm=1.0),
])
def test_adamw_update_matches_reference_given_the_same_gradients(kw):
    """Three steps, each fed the same gradients on both sides: params, m
    and v to 1e-6, the step count equal."""
    params = _params(2, 8, 16, 12)
    rng = np.random.default_rng(9)
    jopt = JO.make_optimizer("adamw", **kw)
    topt = TO.make_optimizer("adamw", **kw)
    jp, js = params, jopt.init(params)
    tp = _t(params)
    ts = topt.init(tp)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 0.5
             for k, v in params.items()}
        jp, js, jinfo = jopt.update(jp, g, js)
        tp, ts, tinfo = topt.update(tp, _t(g), ts)
        for k in KEYS:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(ts["m"][k].numpy(),
                                       np.asarray(js["m"][k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(ts["v"][k].numpy(),
                                       np.asarray(js["v"][k]), rtol=1e-6,
                                       atol=1e-12)
        assert int(ts["step"]) == int(js["step"])
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)


# ------------------------------------------------------------- batching ----
@pytest.mark.parametrize("n,bs,E", [(150, 64, 3), (64, 64, 2), (10, 64, 1)])
def test_round_batches_shapes_padding_and_permutations(n, bs, E):
    cfg = _cfg(batch_size=bs, epochs_per_round=E)
    eng = FitEngine(cfg, None)
    S, b, nb = eng.batch_plan(n)
    jS, jb, jnb = JEngine(cfg, None).batch_plan(n)
    assert (S, b, nb) == (jS, jb, jnb)
    idx, w = eng.round_batches(n, 0, 3)
    assert idx.shape == w.shape == (S, b)
    pad = nb * b - n
    for e in range(E):
        rows = idx[e * nb:(e + 1) * nb].reshape(-1)
        wts = w[e * nb:(e + 1) * nb].reshape(-1)
        assert torch.equal(torch.sort(rows[:n]).values, torch.arange(n))
        assert (rows[n:] == 0).all() and (wts[n:] == 0).all()
        assert (wts[:n] == 1).all() and rows[n:].numel() == pad
    again = eng.round_batches(n, 0, 3)                # a pure function
    assert torch.equal(again[0], idx) and torch.equal(again[1], w)
    if n > 1:
        assert not torch.equal(eng.round_batches(n, 0, 4)[0], idx)


# ------------------------------------------------ one round, JAX vs port ---
def _jax_round_setup(loss):
    cfg = _cfg(loss=loss, rounds=1)
    jcfg = dataclasses.replace(fit_config(reduced=True), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    rng = np.random.default_rng(10)
    n = 150
    x = rng.normal(size=(n, cfg.d)).astype(np.float32)
    ids = rng.integers(0, cfg.n_labels, (n, 5)).astype(np.int32)
    mask = (rng.random((n, 5)) > 0.2).astype(np.float32)
    lv = rng.normal(size=(cfg.n_labels, cfg.d)).astype(np.float32)
    return cfg, jcfg, (x, ids, mask, lv)


@pytest.mark.parametrize("loss", ["softmax_bce", "sigmoid_bce"])
def test_one_round_from_a_converted_jax_state(loss):
    """The JAX round and the port's, from the same state, with JAX's
    batches and insertion orders injected: per-step losses to 1e-4
    relative, the port's diagnostics consistent with its own assignment,
    and the assignment equal to JAX's in every rep whose top-K ids agree."""
    cfg, jcfg, (x, ids, mask, lv) = _jax_round_setup(loss)
    R, L, B = cfg.n_reps, cfg.n_labels, cfg.n_buckets
    scfg = JN.ScorerConfig(d_in=cfg.d, d_hidden=cfg.d_hidden, n_buckets=B,
                           n_reps=R, loss=loss)
    params = _params(R, cfg.d, cfg.d_hidden, B)
    jeng = JEngine(jcfg, scfg)
    jopt_state = jeng.opt.init(params)
    assign = np.asarray(JP.hash_init(L, B, R, 0))
    rng_key = jax.random.PRNGKey(5)
    jstate = JFitState.create(params, jopt_state, assign, rng_key)
    state_np = jax.tree.map(np.asarray, jstate.as_dict())
    jdata = JFitData.build(x, ids, mask, lv, n_labels=L,
                           chunk=cfg.affinity_chunk)
    idx, w = jeng.round_batches(x.shape[0], 0, 0)
    idx, w = np.asarray(idx), np.asarray(w)
    # JAX's per-step losses: its train step, replayed step by step
    p, o, steps = params, jopt_state, []
    for s in range(idx.shape[0]):
        sel, wt = idx[s], w[s]
        tg = JP.bucket_targets(jnp.asarray(assign), jnp.asarray(ids[sel]),
                               jnp.asarray(mask[sel]), B)
        denom = R * max(float(wt.sum()), 1.0)
        part, g = jax.value_and_grad(lambda q: JN.scorer_loss_parts(
            q, scfg, jnp.asarray(x[sel]), tg, jnp.asarray(wt))[0] / denom)(p)
        g = JO.apply_clip(g, jnp.sqrt(JO.global_norm_sq(g)), 1.0)
        p, o, _ = jeng.opt.update(p, g, o)
        steps.append(float(part))
    _, kr = jax.random.split(rng_key)
    orders = np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(kr, r), L)) for r in range(R)])
    jnew, jmet = jeng.make_fit_round(jdata)(jstate, jnp.asarray(idx),
                                            jnp.asarray(w))
    jmet = jax.tree.map(np.asarray, jmet)

    tstate = convert.fit_state_from_reference(state_np, device="cpu")
    tdata = FitData.build(x, ids, mask, lv, n_labels=L,
                          chunk=cfg.affinity_chunk)
    teng = FitEngine(cfg, TN.ScorerConfig(d_in=cfg.d, d_hidden=cfg.d_hidden,
                                          n_buckets=B, n_reps=R, loss=loss))
    old = tstate.assign.clone()
    tstate, tmet = teng.make_fit_round(tdata)(
        tstate, torch.from_numpy(idx).long(), torch.from_numpy(w),
        torch.from_numpy(orders))
    np.testing.assert_allclose(tmet["step_loss"].numpy(), steps, rtol=1e-4)
    np.testing.assert_allclose(tmet["epoch_loss"].numpy(),
                               jmet["epoch_loss"], rtol=1e-4)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert int(tstate.opt_state["step"]) == int(np.asarray(
        jnew.opt_state["step"])) == idx.shape[0]
    for k in KEYS:
        np.testing.assert_allclose(tstate.params[k].numpy(),
                                   np.asarray(jnew.params[k]), rtol=1e-3,
                                   atol=2e-5, err_msg=k)
    new = tstate.assign
    ld = TP.loads(new, B).float()
    assert int(tmet["n_reassigned"]) == int((new != old).sum())
    np.testing.assert_allclose(float(tmet["load_std"]),
                               float(TP.load_std(new, B)), rtol=1e-6)
    assert float(tmet["load_min"]) == float(ld.min())
    assert float(tmet["load_max"]) == float(ld.max())
    assert tstate.round_idx == 1 and tstate.epoch_idx == cfg.epochs_per_round
    back = type(tstate).from_dict(tstate.as_dict())
    assert set(tstate.as_dict()) == set(state_np)
    assert (back.params is tstate.params and back.assign is tstate.assign
            and back.opt_state is tstate.opt_state and back.rng is tstate.rng
            and (back.round_idx, back.epoch_idx) == (1, cfg.epochs_per_round))
    # the same top-K ids give the same placements
    _, jtop = JA.affinity_topk_ann(jnew.params, jnp.asarray(lv), cfg.K,
                                   loss, chunk=cfg.affinity_chunk)
    _, ttop = teng.affinity_topk(tstate.params, tdata)
    same = (ttop.numpy() == np.asarray(jtop)).all(axis=(1, 2))
    assert same.sum() >= R - 1, same
    jassign = np.asarray(jnew.assign)
    for r in np.flatnonzero(same):
        np.testing.assert_array_equal(new[r].numpy(), jassign[r])


def test_xml_round_runs_and_reports():
    """XML mode (Def. 1): a round trains, re-partitions every label and
    reports loads over all of them."""
    cfg = _cfg(loss="sigmoid_bce", n_labels=100, affinity_chunk=32)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(120, cfg.d)).astype(np.float32)
    ids = rng.integers(0, 100, (120, 3)).astype(np.int32)
    idx = IRLIIndex(cfg, device="cpu")
    stats = idx.fit(x, ids)
    assert len(stats.round_idx) >= 1 and idx.assign.shape == (3, 100)
    assert int(TP.loads(idx.assign, cfg.n_buckets).sum()) == 3 * 100
    assert idx.index is not None


# ----------------------------------------------------------- the whole fit --
@pytest.mark.parametrize("loss", ["softmax_bce", "sigmoid_bce"])
def test_whole_fit_matches_reference(loss):
    """fit_config(reduced=True) on clustered_ann, from the same initial
    weights (the random streams differ): recall@10 of the two searches
    within 0.03, the final partitions' load_std within 10%, FitStats of
    equal lengths. The synthetic data are the same arrays in both."""
    cfg = dataclasses.replace(fit_config(reduced=True), loss=loss)
    data = j_clustered(n_base=cfg.n_labels, n_queries=500, d=cfg.d,
                       k_train=10, seed=0)
    mine = clustered_ann(n_base=cfg.n_labels, n_queries=500, d=cfg.d,
                         k_train=10, seed=0)
    np.testing.assert_array_equal(mine.base, data.base)
    np.testing.assert_array_equal(mine.train_gt, data.train_gt)
    np.testing.assert_array_equal(mine.gt, data.gt)
    ji = JIndex(cfg)
    ti, _ = convert.from_reference(
        cfg, params={k: np.asarray(v) for k, v in ji.params.items()},
        assign=np.asarray(ji.assign), device="cpu")
    sj = ji.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    rows = []
    st = ti.fit(mine.train_queries, mine.train_gt, label_vecs=mine.base,
                log=type("Log", (), {"log": lambda self, row, step: rows.append(
                    (step, row))})())
    assert [len(getattr(st, f.name)) for f in dataclasses.fields(st)] == [
        len(getattr(sj, f.name)) for f in dataclasses.fields(sj)]
    assert [s for s, _ in rows] == st.round_idx
    assert {"loss", "n_reassigned", "churn", "load_std", "grad_norm",
            "load_min", "load_max", "load_kl"} <= set(rows[0][1])

    def recall(ids):
        return np.mean([len(set(a[a >= 0]) & set(b)) / 10
                        for a, b in zip(ids, data.gt)])

    rj = recall(np.asarray(ji.search(data.queries, data.base,
                                     JSP(m=4, tau=1, k=10)).ids))
    rt = recall(ti.search(torch.from_numpy(mine.queries),
                          torch.from_numpy(mine.base),
                          TSP(m=4, tau=1, k=10)).ids.numpy())
    assert abs(rj - rt) <= 0.03, (rj, rt)
    assert rt > 0.3
    assert abs(st.load_std[-1] - sj.load_std[-1]) <= 0.1 * sj.load_std[-1]


def test_whole_fit_at_the_fit_cells_ratios_matches_reference():
    """The card's fit cell scaled down on the CPU, its ratios kept: L/B =
    6.55 labels a bucket, K = 10, 100 neighbour labels a point, 1 epoch of
    32 batches a round, sigmoid_bce, lr 1e-3, clustered_ann. Both packages
    pile the labels into few buckets alike (power-of-K cannot spread labels
    whose top-K buckets coincide): the final max load to 10% and load_std to
    10%, the round losses to 1%."""
    L, B = 13107, 2000
    cfg = dataclasses.replace(
        fit_config(reduced=True), d=96, n_labels=L, n_buckets=B, n_reps=4,
        d_hidden=64, K=10, rounds=2, epochs_per_round=1, batch_size=L // 32,
        lr=1e-3, loss="sigmoid_bce", affinity_chunk=4096)
    data = j_clustered(n_base=L, n_queries=10, d=96, k_train=100, seed=0)
    ji = JIndex(cfg)
    ti, _ = convert.from_reference(
        cfg, params={k: np.asarray(v) for k, v in ji.params.items()},
        assign=np.asarray(ji.assign), device="cpu")
    sj = ji.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    st = ti.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    jmax = int(np.asarray(JP.loads(ji.assign, B)).max())
    tmax = int(TP.loads(ti.assign, B).max())
    assert abs(tmax - jmax) <= 0.1 * jmax, (tmax, jmax)
    assert abs(st.load_std[-1] - sj.load_std[-1]) <= 0.1 * sj.load_std[-1]
    np.testing.assert_allclose(st.train_loss, sj.train_loss, rtol=1e-2)


@pytest.mark.parametrize("loss", ["softmax_bce", "sigmoid_bce"])
def test_whole_fit_xml_mode_matches_reference(loss):
    """XML mode (Def. 1) on the reference's zipf_xml label sets, from the
    same initial weights: the final partitions' load_std within 10%, the
    last round's loss within 10%, FitStats of equal lengths."""
    from repro.data.synthetic import zipf_xml
    cfg = dataclasses.replace(fit_config(reduced=True), loss=loss,
                              n_labels=400, affinity_chunk=128)
    d = zipf_xml(n_train=600, n_test=10, d=cfg.d, n_labels=400,
                 labels_per_point=3, seed=0)
    k = max(len(y) for y in d.y_train)
    ids = np.zeros((len(d.y_train), k), np.int32)
    mask = np.zeros((len(d.y_train), k), np.float32)
    for i, y in enumerate(d.y_train):
        ids[i, :len(y)], mask[i, :len(y)] = y, 1.0
    ji = JIndex(cfg)
    ti, _ = convert.from_reference(
        cfg, params={k: np.asarray(v) for k, v in ji.params.items()},
        assign=np.asarray(ji.assign), device="cpu")
    sj = ji.fit(d.x_train, ids, mask)
    st = ti.fit(d.x_train, ids, mask)
    assert len(st.round_idx) == len(sj.round_idx)
    assert len(st.epoch_loss) == len(sj.epoch_loss)
    assert abs(st.load_std[-1] - sj.load_std[-1]) <= 0.1 * sj.load_std[-1]
    assert abs(st.train_loss[-1] - sj.train_loss[-1]) <= (
        0.1 * sj.train_loss[-1])


# ------------------------------------------------ the state, both ways -----
def test_jax_fitted_index_continues_in_the_port_and_back():
    """A JAX-fitted index carries its params, AdamW state and assignment
    into the port; the port's first step from there has JAX's loss on the
    same batch; the port fits on (the step count continues) and hands its
    state back; the JAX index fits on from that."""
    cfg = dataclasses.replace(fit_config(reduced=True), rounds=1,
                              loss="sigmoid_bce")
    data = j_clustered(n_base=cfg.n_labels, n_queries=50, d=cfg.d,
                       k_train=10, seed=1)
    ji = JIndex(cfg)
    ji.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    step0 = int(np.asarray(ji.opt_state["step"]))
    assert step0 > 0
    ti, _ = convert.from_reference(
        cfg, params=jax.tree.map(np.asarray, ji.params),
        assign=np.asarray(ji.assign),
        opt_state=jax.tree.map(np.asarray, ji.opt_state), device="cpu")
    assert int(ti.opt_state["step"]) == step0
    for k in KEYS:
        np.testing.assert_array_equal(ti.opt_state["v"][k].numpy(),
                                      np.asarray(ji.opt_state["v"][k]))
    # one batch's loss from the carried state, both packages
    scfg = ti.scorer_cfg
    sel = np.arange(64)
    tg = JP.bucket_targets(ji.assign, jnp.asarray(data.train_gt[sel]),
                           jnp.ones((64, 10), jnp.float32), cfg.n_buckets)
    jl = JN.scorer_loss(ji.params, ji.scorer_cfg,
                        jnp.asarray(data.train_queries[sel]), tg)
    tl = TN.scorer_loss(ti.params, scfg,
                        torch.from_numpy(data.train_queries[sel]),
                        torch.from_numpy(np.asarray(tg)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    ti.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    S = FitEngine(ti.cfg, None).batch_plan(cfg.n_labels)[0]
    assert int(ti.opt_state["step"]) == step0 + S
    back = convert.to_reference(ti)
    assert back["assign"].dtype == np.int32
    ji.params = jax.tree.map(jnp.asarray, back["params"])
    ji.opt_state = jax.tree.map(jnp.asarray, back["opt"])
    ji.assign = jnp.asarray(back["assign"])
    ji.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    assert int(np.asarray(ji.opt_state["step"])) == step0 + 2 * S
    assert np.isfinite(np.asarray(ji.params["w2"])).all()


# ------------------------------------------------- the port stands alone ---
def test_port_sources_import_neither_jax_nor_the_reference():
    """A grep of every module of the port and of chip_smoke.py: no line
    imports jax, jaxlib or the JAX package (``repro``)."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|,|$)",
                     re.MULTILINE)
    hits = [(f.name, m.group(0).strip()) for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits
    assert len(files) > 30
    assert pat.search("import jax.numpy as jnp")
    assert pat.search("from repro.core import x")
    assert not pat.search("from repro_torch.core import x")
