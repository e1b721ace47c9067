"""The port's scorer, partition and quantized store against the JAX package:
the same numpy inputs through both, integers bit-exact, floats to 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import network as JN  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.store import quantized as JS  # noqa: E402
from repro_torch.core import network as TN  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core.topk import topk_stable  # noqa: E402
from repro_torch.store import quantized as TS  # noqa: E402


def _jax_params(R, d, H, B, seed=0):
    cfg = JN.ScorerConfig(d_in=d, d_hidden=H, n_buckets=B, n_reps=R)
    params = JN.scorer_init(jax.random.PRNGKey(seed), cfg)
    # non-zero biases, so both bias adds are exercised
    rng = np.random.default_rng(seed)
    params["b1"] = jnp.asarray(rng.normal(size=(R, H)), jnp.float32)
    params["b2"] = jnp.asarray(rng.normal(size=(R, B)), jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("R,d,H,B,N", [(2, 16, 32, 16, 8), (4, 24, 64, 48, 5)])
def test_scorer_logits_match_reference(R, d, H, B, N):
    params = _jax_params(R, d, H, B)
    x = np.random.default_rng(1).normal(size=(N, d)).astype(np.float32)
    ref = np.asarray(JN.scorer_logits(params, jnp.asarray(x)))
    got = TN.scorer_logits({k: torch.tensor(v) for k, v in params.items()},
                           torch.from_numpy(x)).numpy()
    assert got.shape == (R, N, B) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss_kind", ["softmax_bce", "sigmoid_bce"])
def test_scorer_probs_match_reference(loss_kind):
    params = _jax_params(2, 16, 32, 16)
    x = np.random.default_rng(2).normal(size=(6, 16)).astype(np.float32)
    ref = np.asarray(JN.scorer_probs(params, jnp.asarray(x), loss_kind))
    got = TN.scorer_probs({k: torch.tensor(v) for k, v in params.items()},
                          torch.from_numpy(x), loss_kind).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_scorer_init_shapes_and_scale():
    cfg = TN.ScorerConfig(d_in=16, d_hidden=64, n_buckets=32, n_reps=3)
    p = TN.scorer_init(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (3, 16, 64), "b1": (3, 64), "w2": (3, 64, 32), "b2": (3, 32)}
    assert not p["b1"].any() and not p["b2"].any()
    assert abs(float(p["w1"].std()) - 16 ** -0.5) < 0.05
    q = TN.scorer_init(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(p["w2"], q["w2"])               # seeded


@pytest.mark.parametrize("L,B,R,seed", [(500, 16, 4, 0), (1000, 37, 3, 5)])
def test_hash_init_and_loads_match_reference(L, B, R, seed):
    ref = np.asarray(JP.hash_init(L, B, R, seed))
    got = TP.hash_init(L, B, R, seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(TP.loads(got, B).numpy(),
                                  np.asarray(JP.loads(jnp.asarray(ref), B)))


@pytest.mark.parametrize("max_load", [None, 64])
def test_build_inverted_index_matches_reference(max_load):
    assign = JP.hash_init(400, 16, 3, seed=2)
    ref = JP.build_inverted_index(assign, 16, max_load)
    got = TP.build_inverted_index(torch.tensor(np.asarray(assign)), 16,
                                  max_load)
    assert got.max_load == ref.max_load
    assert got.members.dtype == torch.int32
    np.testing.assert_array_equal(got.members.numpy(),
                                  np.asarray(ref.members))
    np.testing.assert_array_equal(got.load.numpy(), np.asarray(ref.load))


def _rows(L, D, seed):
    x = np.random.default_rng(seed).normal(size=(L, D)).astype(np.float32)
    x[0, :8] = 0.0                          # an all-zero block: scale 1/127
    x[1] *= 1e3
    x[2, 3] = np.abs(x[2, :8]).max() / 2     # near a half-way code (63.5)
    return x


@pytest.mark.parametrize("L,D,block", [(50, 32, 8), (40, 96, 32)])
def test_int8_encode_is_bit_identical(L, D, block):
    x = _rows(L, D, 3)
    ref = JS.encode(jnp.asarray(x), "int8", block, keep_exact=True)
    got = TS.encode(torch.from_numpy(x), "int8", block, keep_exact=True)
    assert got.codes.dtype == torch.int8 and got.block == ref.block
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scales.numpy().view(np.uint32),
                                  np.asarray(ref.scales).view(np.uint32))
    np.testing.assert_array_equal(got.exact.numpy(), x)
    np.testing.assert_array_equal(TS.decode(got).numpy(),
                                  np.asarray(JS.decode(ref)))
    ids = np.array([[3, 0], [1, 1]])
    np.testing.assert_array_equal(
        TS.refine_rows(got, torch.from_numpy(ids)).numpy(), x[ids])


def test_bf16_and_fp32_encode_are_bit_identical():
    x = _rows(30, 16, 4)
    ref = JS.encode(jnp.asarray(x), "bf16")
    got = TS.encode(torch.from_numpy(x), "bf16")
    assert got.scales is None and got.codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.codes.view(torch.int16).numpy(),
        np.asarray(ref.codes).view(np.int16))
    np.testing.assert_array_equal(TS.decode(got).numpy(),
                                  np.asarray(JS.decode(ref)))
    f = TS.encode(torch.from_numpy(x), "fp32")
    np.testing.assert_array_equal(f.codes.numpy(), x)


def test_check_scales_rejects_mismatched_stores():
    x = torch.from_numpy(_rows(8, 16, 5))
    s = TS.encode(x, "int8", 8)
    with pytest.raises(ValueError, match="requires scales"):
        TS.check_scales(TS.QuantizedStore("int8", 8, s.codes))
    with pytest.raises(ValueError, match="only valid for int8"):
        TS.check_scales(TS.QuantizedStore("bf16", 8, s.codes, s.scales))
    with pytest.raises(ValueError, match="must divide"):
        TS.encode(x, "int8", 6)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_stable_breaks_ties_like_lax_top_k(k):
    x = np.array([[3, 1, 3, 2, 3, -np.inf, 0.0, -0.0],
                  [-1, -1, -np.inf, -np.inf, 2, -0.0, 0.0, 2]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = topk_stable(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
