"""The port's recsys slice (DIEN's serve path) against the JAX package on
the CPU.

The same numpy inputs (from a seed) go through ``repro`` and its
counterpart in ``repro_torch``: the embedding_bag plain version against the
JAX ``embedding_bag_ref`` (the reference's Pallas kernel cannot run in
interpret mode under this jax), ``models/embedding``, the GRU cells and
``gru_scan``, ``dien_apply`` at the smoke test's tiny config and at the
full ``configs/dien.CONFIG``, and ``build_ctr_serve``, with the JAX
weights carried across by ``convert.dien_params_from_reference``.
Tolerances: fp32 |a - b| <= 1e-5 + 1e-5·|b|; bf16 tables 2e-2 (the JAX
kernel test's). The kernel itself is held against the plain version on
the card in ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dien import CONFIG as J_DIEN  # noqa: E402
from repro.data.synthetic import behavior_stream as j_behavior  # noqa: E402
from repro.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_ref as j_bag_ref)
from repro.launch import steps as JS  # noqa: E402
from repro.models import embedding as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import dien as PD  # noqa: E402
from repro_torch.data.synthetic import behavior_stream  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import (  # noqa: E402
    bag_lookup_reduce)
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_ref)
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.models import embedding as PE  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import recsys as PR  # noqa: E402

jax.config.update("jax_platforms", "cpu")

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# the smoke test's tiny DIEN (tests/test_smoke_archs.py)
TINY = dict(embed_dim=8, seq_len=12, gru_dim=16, mlp=(16, 8), item_vocab=200,
            cate_vocab=50)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return {k: _tree_t(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else _t(np.asarray(tree, np.float32))


# ---------------------------------------------------------- embedding_bag --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,V,D", [
    (128, 4, 300, 32), (256, 8, 1000, 64),     # the JAX kernel sweep's
    (7, 100, 1000, 18),                        # DIEN's P and D, ragged N
    (0, 4, 10, 8), (5, 0, 10, 8)])             # no bags, empty bags
def test_embedding_bag_ref_matches_reference(N, P, V, D, dtype):
    """-1 pads, an all-pad bag and zero weights included; through
    bag_lookup_reduce on CPU tensors, which launches nothing."""
    rng = np.random.default_rng(N + P)
    ids = rng.integers(-1, V, (N, P)).astype(np.int32)
    w = rng.random((N, P)).astype(np.float32)
    if N >= 3 and P >= 2:
        ids[0] = -1                 # all pads
        w[1, :2] = 0.0              # zero weights on real rows
        w[2] = 0.0
    tbl = rng.normal(size=(V, D)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = j_bag_ref(jnp.asarray(ids), jnp.asarray(w),
                     jnp.asarray(tbl).astype(jdt))
    ttbl = _t(tbl).to(getattr(torch, dtype))
    reset_launches()
    got = bag_lookup_reduce(_t(ids), _t(w), ttbl)
    assert LAUNCHES["embedding_bag"] == 0
    assert got.dtype == ttbl.dtype and got.shape == (N, D)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(F32 if dtype == "float32" else BF16))
    if N >= 3 and P >= 2:
        assert (got[0] == 0).all()
    np.testing.assert_array_equal(
        embedding_bag_ref(_t(ids), _t(w), ttbl).float().numpy(),
        got.float().numpy())


def test_embedding_bag_ref_refuses_ids_past_the_table():
    ids = torch.tensor([[0, 5]], dtype=torch.int32)
    with pytest.raises(IndexError):
        embedding_bag_ref(ids, torch.ones(1, 2), torch.zeros(5, 3))


@pytest.mark.parametrize("D,dtype,plan", [
    # D: (vec_bytes, vec_elems, cols, group, slots, col_chunks)
    (18, "float32", (8, 2, 9, 9, 3, 1)),        # DIEN: 9 float2, 3 slots
    (18, "bfloat16", (4, 2, 9, 9, 3, 1)),       # 9 __nv_bfloat162
    (1, "float32", (4, 1, 1, 1, 32, 1)),
    (17, "float32", (4, 1, 17, 17, 1, 1)),
    (36, "float32", (16, 4, 9, 9, 3, 1)),
    (64, "bfloat16", (16, 8, 8, 8, 4, 1)),
    (65, "float32", (4, 1, 65, 32, 1, 3)),      # lanes over columns
    (128, "float32", (16, 4, 32, 32, 1, 1)),
    (200, "float32", (16, 4, 50, 32, 1, 2)),
    (19, "bfloat16", (2, 1, 19, 19, 1, 1))])
def test_embedding_bag_plan(D, dtype, plan):
    """The kernel's lanes: the widest vector dividing a row, a group of
    lanes a slot, 32 // group slots a warp step, chunks of 32 vectors past
    that (the C side's embedding_bag_plan, checked on the card)."""
    from repro_torch.kernels.embedding_bag.ops import bag_plan
    got = bag_plan(D, getattr(torch, dtype))
    assert tuple(got.values()) == plan
    assert got["cols"] * got["vec_elems"] == D
    assert got["slots"] * got["group"] <= 32


# --------------------------------------------------------- models/embedding --
def _table(V=40, D=6, seed=0):
    p = JE.bag_init(jax.random.PRNGKey(seed), V, D)
    return p, {"table": _t(np.asarray(p["table"]))}


def test_bag_lookup_matches_reference():
    jp, tp = _table()
    ids = np.random.default_rng(1).integers(0, 40, (3, 5)).astype(np.int32)
    want = JE.bag_lookup(jp, jnp.asarray(ids))
    got = PE.bag_lookup(tp, _t(ids))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_bag_reduce_matches_reference(mode, weighted):
    """Unsorted segments, and bag 4 of 6 empty (0 for sum and mean, -inf
    for max)."""
    jp, tp = _table()
    rng = np.random.default_rng(2)
    values = rng.integers(0, 40, 17).astype(np.int32)
    seg = rng.choice([0, 1, 2, 3, 5], 17).astype(np.int32)
    w = rng.normal(size=17).astype(np.float32) if weighted else None
    want = JE.bag_reduce(jp, jnp.asarray(values), jnp.asarray(seg), 6,
                         mode=mode,
                         weights=None if w is None else jnp.asarray(w))
    got = PE.bag_reduce(tp, _t(values), _t(seg), 6, mode=mode,
                        weights=None if w is None else _t(w))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    assert (got[4] == (float("-inf") if mode == "max" else 0.0)).all()
    with pytest.raises(ValueError):
        PE.bag_reduce(tp, _t(values), _t(seg), 6, mode="median")


def test_tables_init_and_lookup_match_reference():
    sizes = [30, 7, 12, 1]
    jp, joff = JE.tables_init(jax.random.PRNGKey(3), sizes, 5)
    tp, toff = PE.tables_init(torch.Generator().manual_seed(3), sizes, 5)
    assert toff.dtype == torch.int32
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    assert tuple(tp["mega"]["table"].shape) == jp["mega"]["table"].shape
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, s, 9) for s in sizes], 1).astype(
        np.int32)
    want = JE.tables_lookup(jp, joff, jnp.asarray(ids))
    got = PE.tables_lookup(_tree_t(jp), toff, _t(ids))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_bag_init_draws_the_reference_distribution():
    gen = torch.Generator().manual_seed(0)
    tbl = PE.bag_init(gen, 20_000, 18)["table"]
    assert tbl.shape == (20_000, 18) and tbl.dtype == torch.float32
    assert abs(float(tbl.std()) - 0.01) < 2e-4
    assert PE.bag_init(gen, 4, 3, torch.bfloat16)["table"].dtype \
        == torch.bfloat16


# --------------------------------------------------------------- GRU cells --
def _gru(d_in=7, d_h=5, seed=4):
    jp = JL.gru_init(jax.random.PRNGKey(seed), d_in, d_h)
    return jp, _tree_t(jp)


def test_gru_cell_matches_reference():
    jp, tp = _gru()
    rng = np.random.default_rng(4)
    h = rng.normal(size=(6, 5)).astype(np.float32)
    x = rng.normal(size=(6, 7)).astype(np.float32)
    want = JL.gru_cell(jp, jnp.asarray(h), jnp.asarray(x))
    got = PL.gru_cell(tp, _t(h), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_augru_cell_matches_reference():
    """The AUGRU moves h toward n by z·att (the GRU by 1 - z): att = 0
    keeps h exactly."""
    jp, tp = _gru()
    rng = np.random.default_rng(5)
    h = rng.normal(size=(6, 5)).astype(np.float32)
    x = rng.normal(size=(6, 7)).astype(np.float32)
    att = rng.random(6).astype(np.float32)
    att[0] = 0.0
    want = JL.augru_cell(jp, jnp.asarray(h), jnp.asarray(x),
                         jnp.asarray(att))
    got = PL.augru_cell(tp, _t(h), _t(x), _t(att))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    np.testing.assert_array_equal(got[0].numpy(), h[0])


@pytest.mark.parametrize("attentional", [False, True])
def test_gru_scan_matches_reference(attentional):
    jp, tp = _gru(seed=6)
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(3, 9, 7)).astype(np.float32)
    h0 = rng.normal(size=(3, 5)).astype(np.float32)
    if attentional:
        att = rng.random((3, 9)).astype(np.float32)
        want = JL.gru_scan(jp, jnp.asarray(xs), jnp.asarray(h0),
                           cell=JL.augru_cell, att=jnp.asarray(att))
        got = PL.gru_scan(tp, _t(xs), _t(h0), cell=PL.augru_cell,
                          att=_t(att))
    else:
        want = JL.gru_scan(jp, jnp.asarray(xs), jnp.asarray(h0))
        got = PL.gru_scan(tp, _t(xs), _t(h0))
    assert got[0].shape == (3, 9, 5)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), **F32)
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), **F32)
    np.testing.assert_array_equal(got[0][:, -1].numpy(), got[1].numpy())


# -------------------------------------------------------------------- DIEN --
def _dien(cfg_kw, seed=0):
    jcfg, pcfg = JR.DIENConfig(**cfg_kw), PR.DIENConfig(**cfg_kw)
    jp = JR.dien_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.dien_params_from_reference(jax.device_get(jp),
                                            device="cpu")
    return jcfg, pcfg, jp, tp


def _batch(cfg, B, seed):
    b = next(behavior_stream(B, cfg.seq_len, cfg.item_vocab, cfg.cate_vocab,
                             seed=seed))
    b["hist_mask"][1] = 0.0            # a row with no history: uniform att
    return b


def _apply_both(jcfg, pcfg, jp, tp, b):
    args = ("hist_items", "hist_cates", "target_item", "target_cate",
            "hist_mask")
    want = JR.dien_apply(jp, jcfg, *(jnp.asarray(b[k]) for k in args))
    reset_launches()
    got = PR.dien_apply(tp, pcfg, *(_t(b[k]) for k in args))
    assert not any(LAUNCHES.values())            # the CPU: plain versions
    return got, want


def test_dien_apply_matches_reference_tiny():
    jcfg, pcfg, jp, tp = _dien(TINY)
    got, want = _apply_both(jcfg, pcfg, jp, tp, _batch(pcfg, 16, seed=0))
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_dien_apply_matches_reference_at_full_config():
    """configs/dien.CONFIG at full width (1,048,576 x 18 item table), a
    batch of 8 from behavior_stream."""
    assert dataclasses.asdict(PD.CONFIG) == dataclasses.asdict(J_DIEN)
    jcfg, pcfg = J_DIEN, PD.CONFIG
    jp = JR.dien_init(jax.random.PRNGKey(1), jcfg)
    tp = convert.dien_params_from_reference(jax.device_get(jp),
                                            device="cpu")
    got, want = _apply_both(jcfg, pcfg, jp, tp, _batch(pcfg, 8, seed=1))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_ctr_serve_matches_reference():
    jcfg, pcfg, jp, tp = _dien(TINY, seed=2)
    b = _batch(pcfg, 16, seed=2)
    args = ("hist_items", "hist_cates", "target_item", "target_cate",
            "hist_mask")
    want = JS.build_ctr_serve(
        lambda p, bb: JR.dien_apply(p, jcfg, *(bb[k] for k in args)))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = PS.build_ctr_serve(
        lambda p, bb: PR.dien_apply(p, pcfg, *(bb[k] for k in args)))(tp, b)
    assert set(got) == {"prob"} and got["prob"].shape == (16,)
    np.testing.assert_allclose(got["prob"].numpy(), _np(want["prob"]),
                               **F32)


def test_dien_config_apply_unpacks_the_batch():
    """configs/dien.apply over the reference's batch dict, at CONFIG's
    widths over small tables, equals dien_apply."""
    cfg = dataclasses.replace(PD.CONFIG, item_vocab=500, cate_vocab=40)
    tp = PR.dien_init(cfg, seed=3, device="cpu")
    b = {k: _t(v) for k, v in _batch(cfg, 4, seed=3).items()}
    got = PS.build_ctr_serve(PD.apply)(tp, b)["prob"]
    want = torch.sigmoid(PR.dien_apply(
        tp, PD.CONFIG, b["hist_items"], b["hist_cates"], b["target_item"],
        b["target_cate"], b["hist_mask"]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert PD.BATCHES == {"serve_p99": 512, "serve_bulk": 262_144}


def test_dien_convert_round_trip():
    jcfg, pcfg, jp, tp = _dien(TINY, seed=4)
    back = convert.dien_params_to_reference(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b) == 20
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))
        assert flat_b[path].dtype == np.asarray(leaf).dtype


def test_dien_init_matches_reference_shapes():
    jcfg, pcfg = JR.DIENConfig(**TINY), PR.DIENConfig(**TINY)
    shapes = jax.eval_shape(lambda: JR.dien_init(jax.random.PRNGKey(0),
                                                 jcfg))
    want = {jax.tree_util.keystr(p): s.shape
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    tp = convert.dien_params_to_reference(
        PR.dien_init(pcfg, seed=0, device="cpu"))
    got = {jax.tree_util.keystr(p): a.shape
           for p, a in jax.tree_util.tree_leaves_with_path(tp)}
    assert got == want


def test_dien_init_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.dien_init(PD.CONFIG)


def test_behavior_stream_matches_reference():
    got = next(behavior_stream(6, 10, 1000, 30, seed=5))
    want = next(j_behavior(6, 10, 1000, 30, seed=5))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
