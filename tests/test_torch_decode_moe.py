"""The port's decode path, MoE block and k-choice router against the JAX
package on the CPU.

The same numpy inputs (from a seed) go through ``repro.models`` /
``repro.launch.steps`` and their counterparts in ``repro_torch``, the
weights carried across by ``convert.lm_params_from_reference`` and the
caches by ``convert.caches_from_reference``. Tolerances (fp32): decode
logits, attention outputs and the caches after each step to 1e-5 (a
layer's K and V are products of the layer's input, which carries the
fp32 rounding of the layers before), next tokens equal;
MoE outputs to 1e-5, ``aux`` to 1e-6, routing ids equal; the router's
plain version (``kchoice_ref(slots=k)``) equal to the reference's
sequential scan. The kchoice kernel with ``slots`` is held against the
plain version on the card in ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.llama4_maverick import CONFIG as J_LLAMA4  # noqa: E402
from repro.configs.mixtral_8x7b import CONFIG as J_MIXTRAL  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.llama4_maverick import CONFIG as P_LLAMA4  # noqa: E402
from repro_torch.configs.mixtral_8x7b import CONFIG as P_MIXTRAL  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.kchoice import ref as kref  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

jax.config.update("jax_platforms", "cpu")

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree)


# ---------------------------------------------------------- attend_decode --
DECODE_ATTN = {
    "full": dict(),
    "full-gqa-nope": dict(n_kv_heads=2, use_rope=False),
    "swa": dict(kind="swa", window=5),
    "swa-gqa": dict(kind="swa", window=7, n_kv_heads=1),
    "chunked": dict(kind="chunked", chunk=6, n_kv_heads=2),
}


@pytest.mark.parametrize("name", list(DECODE_ATTN))
def test_attend_decode_matches_reference(name):
    """16 steps of one new token a row, the rows at different positions
    (one starting past the SWA window, so its ring has wrapped before the
    first step), the caches written in place: every output and both
    caches to 1e-5 of the reference's functional ones after each step."""
    kw = {**dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8),
          **DECODE_ATTN[name]}
    jcfg, pcfg = JA.AttnConfig(**kw), PA.AttnConfig(**kw)
    p = JA.attn_init(jax.random.PRNGKey(3), jcfg)
    pp = _tree_t(p)
    B, ctx, steps = 3, 24, 16
    Sc = JA.decode_cache_len(jcfg, ctx)
    assert PA.decode_cache_len(pcfg, ctx) == Sc
    assert Sc == (min(kw.get("window", 0), ctx) if "swa" in name else ctx)
    rng = np.random.default_rng(4)
    jk = jnp.zeros((B, Sc, jcfg.n_kv_heads, 8))
    jv = jnp.zeros((B, Sc, jcfg.n_kv_heads, 8))
    pk, pv = torch.zeros(jk.shape), torch.zeros(jv.shape)
    start = np.array([0, 3, 8])
    for s in range(steps):
        x = rng.normal(size=(B, 1, 32)).astype(np.float32)
        pos = (start + s).astype(np.int32)
        want, jk, jv = JA.attend_decode(p, jcfg, jnp.asarray(x), jk, jv,
                                        jnp.asarray(pos))
        got, gk, gv = PA.attend_decode(pp, pcfg, _t(x), pk, pv,
                                       torch.from_numpy(pos))
        assert gk is pk and gv is pv             # written in place
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)
        np.testing.assert_allclose(pk.numpy(), _np(jk), **F32)
        np.testing.assert_allclose(pv.numpy(), _np(jv), **F32)


# ------------------------------------------------------------ LM decode ----
def _tiny(name, **kw):
    """The reference's reduced smoke configs (tests/test_smoke_archs.py),
    as keyword arguments of either package's LMConfig."""
    base = dict(name=name, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, vocab=512, param_dtype="float32",
                q_chunk=32)
    base.update(kw)
    return base


def _moe_kw(**kw):
    return dict(d_model=64, d_ff=128, ffn_chunk=1 << 16, **kw)


DECODE_LMS = {
    "gemma-7b": _tiny("gemma-7b", act="gelu", embed_scale=True,
                      tie_embeddings=True),
    "mixtral-8x7b": _tiny("mixtral-8x7b", attn_pattern=("swa",), window=32,
                          n_kv_heads=2, tie_embeddings=False,
                          moe=_moe_kw(n_experts=4, top_k=2)),
    "mixtral-8x7b-kchoice": _tiny(
        "mixtral-8x7b", attn_pattern=("swa",), window=32,
        tie_embeddings=False,
        moe=_moe_kw(n_experts=4, top_k=2, router="irli_kchoice")),
    "llama4-maverick": _tiny(
        "llama4", n_layers=4,
        attn_pattern=("chunked", "chunked", "chunked", "full"), chunk=32,
        nope_on_full=True, tie_embeddings=False,
        moe=_moe_kw(n_experts=8, top_k=1, n_shared_experts=1)),
}


def _configs(name):
    kw = dict(DECODE_LMS[name])
    moe = kw.pop("moe", None)
    jcfg = JT.LMConfig(**kw, moe=None if moe is None else JMOE.MoEConfig(
        **moe))
    pcfg = PT.LMConfig(**kw, moe=None if moe is None else PMOE.MoEConfig(
        **moe))
    return jcfg, pcfg


@pytest.mark.parametrize("name", list(DECODE_LMS))
def test_lm_decode_matches_reference(name):
    """build_lm_decode against the reference's lm_decode_step, step by step
    over 34 steps of 2 rows (past the SWA window and llama4's chunk of 32:
    the ring wraps, a chunk boundary passes, llama4's global layer takes no
    rope): logits to 1e-5, the caches to 1e-5 of the reference's after each
    step, next tokens equal (and equal to the reference's build_lm_decode
    at the last step). The port writes the caches it was given in place
    and returns those tensors."""
    jcfg, pcfg = _configs(name)
    params = jax.device_get(JT.lm_init(jax.random.PRNGKey(0), jcfg))
    model = convert.lm_params_from_reference(params, pcfg, device="cpu")
    B, ctx, steps = 2, 48, 34
    jc = JT.init_cache(jcfg, B, ctx)
    pc = convert.caches_from_reference(jax.device_get(jc), device="cpu")
    assert [tuple(c["k"].shape) for c in pc] == [
        s["k"][0] for s in PT.cache_specs(pcfg, B, ctx)]
    assert [tuple(c["k"].shape) for c in pc] == [
        s["k"].shape for s in JT.cache_specs(jcfg, B, ctx)]
    jdecode = jax.jit(lambda p, t, c, q: JT.lm_decode_step(p, jcfg, t, c, q))
    pstep = PS.build_lm_decode(pcfg, ctx)
    toks = np.random.default_rng(1).integers(0, 512, (steps, B))
    reset_launches()
    for s in range(steps):
        tok = toks[s].astype(np.int32)
        pos = np.array([s, s + 3], np.int32)
        if s == steps - 1:
            want = JS.build_lm_decode(jcfg, ctx)(params, {
                "token": jnp.asarray(tok), "caches": jc,
                "pos": jnp.asarray(pos)})
        want_logits, jc = jdecode(params, jnp.asarray(tok), jc,
                                  jnp.asarray(pos))
        got = pstep(model, {"token": torch.from_numpy(tok), "caches": pc,
                            "pos": torch.from_numpy(pos)})
        assert got["caches"] is pc
        assert got["next_token"].dtype == torch.int32
        np.testing.assert_allclose(got["logits"].numpy(), _np(want_logits),
                                   **F32)
        np.testing.assert_array_equal(got["next_token"].numpy(),
                                      np.asarray(jnp.argmax(want_logits, -1)))
        back = convert.caches_to_reference(pc)
        for a, b in zip(back, jax.device_get(jc)):
            for n in ("k", "v"):
                np.testing.assert_allclose(a[n], _np(b[n]), **F32)
    np.testing.assert_array_equal(got["next_token"].numpy(),
                                  np.asarray(want["next_token"]))
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("name", ["gemma-7b", "mixtral-8x7b",
                                  "llama4-maverick"])
def test_lm_decode_equals_the_teacher_forced_forward(name):
    """Decode over the tokens one by one gives the forward's logits at
    every position (the reference's test_lm_decode_matches_train_forward,
    here on the port alone and across the SWA ring and llama4's chunks).
    The capacity is raised to E / top_k, where no token can be dropped: a
    decode step of B tokens drops none (its capacity is at least 8), while
    the forward's queues over all B·T tokens can overflow at the config's
    1.25. Under the top-k router only: the k-choice router's loads run over
    the whole block in the forward and over one step's tokens in decode, so
    their routings differ by design."""
    _, pcfg = _configs(name)
    if pcfg.moe is not None:
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=pcfg.moe.n_experts / pcfg.moe.top_k))
    model = PT.lm_init(pcfg, seed=0, device="cpu")
    B, T = 2, 40
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512,
                                                              (B, T)))
    h, _ = PT.lm_backbone(model, pcfg, toks)
    full = PT._logits(model, pcfg, h)
    caches = PT.init_cache(pcfg, B, T, device="cpu")
    for t in range(T):
        logits, caches = PT.lm_decode_step(model, pcfg, toks[:, t], caches,
                                           torch.full((B,), t))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama4-maverick"])
def test_moe_lm_prefill_and_params_match_reference(name):
    """The MoE models' forward (lm_backbone: hidden to 1e-5, aux to 1e-6)
    with the moe subtree carried across, and the params' round trip
    through the reference's layout; the parameter count is n_params."""
    jcfg, pcfg = _configs(name)
    params = jax.device_get(JT.lm_init(jax.random.PRNGKey(5), jcfg))
    model = convert.lm_params_from_reference(params, pcfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, 512, (2, 64))
    jh, jaux = JT.lm_backbone(params, jcfg, jnp.asarray(toks, jnp.int32))
    ph, paux = PT.lm_backbone(model, pcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(ph.numpy(), _np(jh), **F32)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6,
                               atol=1e-6)
    assert float(paux) > 0
    back = convert.lm_params_to_reference(model)
    flat = jax.tree_util.tree_flatten_with_path
    got, want = flat(back)[0], flat(params)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b), str(path))
    n_layer_leaves = sum(v.numel() for v in model.parameters())
    assert n_layer_leaves == pcfg.n_params == jcfg.n_params
    assert PT.lm_init(pcfg, seed=1, device="cpu")["layers"][0]["moe"][
        "experts"]["gate"].shape == (pcfg.moe.n_experts, 64, 128)


# -------------------------------------------------------------------- MoE --
def _moe_case(router, top_k, n_experts, n_shared=0, seed=0, **kw):
    mkw = dict(d_model=32, d_ff=48, n_experts=n_experts, top_k=top_k,
               router=router, n_shared_experts=n_shared, **kw)
    jcfg, pcfg = JMOE.MoEConfig(**mkw), PMOE.MoEConfig(**mkw)
    p = jax.device_get(JMOE.moe_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, pcfg, p, _tree_t(p)


MOE_CASES = [("topk", 2, 8, 0), ("topk", 1, 16, 1),
             ("irli_kchoice", 2, 8, 0), ("irli_kchoice", 1, 16, 1),
             ("irli_kchoice", 3, 6, 0)]


@pytest.mark.parametrize("router,top_k,E,shared", MOE_CASES)
@pytest.mark.parametrize("path", ["tokens", "rows"])
def test_moe_apply_matches_reference(router, top_k, E, shared, path):
    """moe_apply through _moe_tokens (T <= ffn_chunk) and through the
    per-row chunks of _moe_rows (ffn_chunk 32 at [2, 64]: 2 chunks of
    [2, 16]... of 16 rows a chunk): y to 1e-5, aux to 1e-6. The capacity
    is tight (factor 1.0), so tokens are dropped at the queue's end."""
    kw = dict(capacity_factor=1.0, ffn_chunk=32 if path == "rows" else 4096)
    jcfg, pcfg, p, pp = _moe_case(router, top_k, E, shared, **kw)
    x = np.random.default_rng(6).normal(size=(2, 64, 32)).astype(np.float32)
    want, jaux = JMOE.moe_apply(p, jcfg, jnp.asarray(x))
    got, aux = PMOE.moe_apply(pp, pcfg, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("router,top_k,E,shared", MOE_CASES)
def test_moe_routing_ids_match_reference(router, top_k, E, shared):
    """The router's ids and weights on one block (_moe_tokens) and per row
    (the reference's vmap over rows: each row its own loads), the queue
    positions and the capacity."""
    jcfg, pcfg, p, pp = _moe_case(router, top_k, E, shared)
    logits = np.random.default_rng(7).normal(size=(3, 40, E)).astype(
        np.float32)
    jroute = JMOE._route_irli_kchoice if router == "irli_kchoice" \
        else JMOE._route_topk
    proute = PMOE._route_irli_kchoice if router == "irli_kchoice" \
        else PMOE._route_topk
    for lg in (logits[0], logits):
        if lg.ndim == 3:
            jw, ji, ja = jax.vmap(lambda v: jroute(v, jcfg))(jnp.asarray(lg))
        else:
            jw, ji, ja = jroute(jnp.asarray(lg), jcfg)
        pw, pi, pa = proute(_t(lg), pcfg)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(pw.numpy(), _np(jw), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(pa.numpy() * np.ones_like(_np(ja)),
                                   _np(ja), rtol=1e-6, atol=1e-6)
    for T in (1, 7, 40, 1000):
        assert PMOE._capacity(pcfg, T) == JMOE._capacity(jcfg, T)


@pytest.mark.parametrize("top_k,E,K", [(1, 8, 4), (2, 8, 4), (2, 4, 4),
                                       (3, 16, 5)])
@pytest.mark.parametrize("logits", ["random", "equal", "two_levels"])
def test_kchoice_ref_slots_is_the_reference_router(top_k, E, K, logits):
    """kchoice_ref(slots=k) on the router's top-K candidates, tokens in
    order (G = 1, and G = 3 rows with their own loads), equals the ids of
    the reference's lax.scan router. "equal": every token's top-K is
    experts 0..K-1 and every pick a tie of loads; "two_levels": repeated
    logits, ties in the top-K and in the loads."""
    rng = np.random.default_rng(E + K + top_k)
    if logits == "random":
        lg = rng.normal(size=(3, 50, E))
    elif logits == "equal":
        lg = np.zeros((3, 50, E))
    else:
        lg = rng.integers(0, 2, (3, 50, E)).astype(np.float64)
    lg = lg.astype(np.float32)
    jcfg = JMOE.MoEConfig(d_model=8, d_ff=8, n_experts=E, top_k=top_k,
                          router="irli_kchoice", router_k_choices=K)
    _, want, _ = jax.vmap(lambda v: JMOE._route_irli_kchoice(v, jcfg))(
        jnp.asarray(lg))
    probs = torch.softmax(_t(lg), -1)
    from repro_torch.core.topk import topk_stable
    topi = topk_stable(probs, K)[1].to(torch.int32)
    order = torch.arange(50, dtype=torch.int32).expand(3, 50)
    got = kref.kchoice_ref(topi, order, B=E, slots=top_k)
    got = got if top_k > 1 else got[..., None]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = kref.kchoice_ref(topi[:1], order[:1], B=E, slots=top_k)
    np.testing.assert_array_equal(one.reshape(50, top_k).numpy(),
                                  np.asarray(want)[0])
    # a label's picks are distinct, and the schedule's helpers agree
    assert (np.sort(got.numpy(), -1)[..., 1:]
            != np.sort(got.numpy(), -1)[..., :-1]).all()
    plain, rounds = kref.kchoice_windows(topi, order, B=E, slots=top_k)
    assert torch.equal(plain.reshape(got.shape), got)
    if top_k > 1:
        win = 32 // top_k * top_k
        n = 50 * top_k
        assert rounds.tolist() == [-(-n // win) + n] * 3
    depth = kref.dependence_depth(topi, order, plain, B=E)
    assert (depth >= top_k).all() and (depth <= 50 * top_k).all()


def test_kchoice_ref_slots_one_is_unchanged():
    """slots = 1 keeps [G, L] and the plain walk's placements; slots
    outside [1, K] are refused."""
    rng = np.random.default_rng(0)
    topk = torch.from_numpy(np.stack([[rng.choice(30, 4, replace=False)
                                       for _ in range(200)]
                                      for _ in range(2)]).astype(np.int32))
    order = torch.from_numpy(np.stack([rng.permutation(200)
                                       for _ in range(2)]).astype(np.int32))
    a = kref.kchoice_ref(topk, order, B=30)
    b = kref.kchoice_ref(topk, order, B=30, slots=1)
    assert a.shape == (2, 200) and torch.equal(a, b)
    w, _ = kref.kchoice_windows(topk, order, B=30)
    assert torch.equal(w, a)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="slots"):
            kref.kchoice_ref(topk, order, B=30, slots=bad)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("jcfg,pcfg", [(J_MIXTRAL, P_MIXTRAL),
                                       (J_LLAMA4, P_LLAMA4)])
def test_moe_configs_copy_the_reference_value_for_value(jcfg, pcfg):
    got, want = dataclasses.asdict(pcfg), dataclasses.asdict(jcfg)
    assert got == {k: want[k] for k in got}
    assert set(want) == set(got)
    assert dataclasses.asdict(pcfg.moe) == dataclasses.asdict(jcfg.moe)
    assert pcfg.n_params == jcfg.n_params
    assert pcfg.n_active_params == jcfg.n_active_params
    for i in range(pcfg.period):
        a, b = dataclasses.asdict(pcfg.attn_cfg(i)), dataclasses.asdict(
            jcfg.attn_cfg(i))
        assert a == {k: b[k] for k in a}
    assert [s["k"] for s in PT.cache_specs(pcfg, 2, 8192)] == [
        (s["k"].shape, torch.bfloat16)
        for s in JT.cache_specs(jcfg, 2, 8192)]
