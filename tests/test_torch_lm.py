"""The port's LM prefill path against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``repro.models`` /
``repro.launch.steps`` and their counterparts in ``repro_torch``: the
layers, ``attend_train`` for every kind, the flash-attention plain version
(against the Pallas kernel in interpret mode and the JAX oracle) and
``build_lm_prefill`` whole, for the tiny gemma, yi and qwen3 variants of
``tests/test_smoke_archs.py``, with the weights carried across by
``convert.lm_params_from_reference``. Tolerances: fp32 to 1e-5 (the
logits, a d-long fp32 sum of bf16-free values, to a stated 1e-4), bf16 to
3e-2 (the reference kernel test's), next tokens equal. The kernel itself
is held against the plain version on the card in ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.gemma_7b import CONFIG as J_GEMMA  # noqa: E402
from repro.configs.qwen3_4b import CONFIG as J_QWEN  # noqa: E402
from repro.configs.yi_6b import CONFIG as J_YI  # noqa: E402
from repro.kernels.flash_attn.flash_attn import (  # noqa: E402
    flash_attention as j_flash)
from repro.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_ref as j_flash_ref)
from repro.launch import steps as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models.transformer import LMConfig as JLMConfig  # noqa: E402
from repro.models.transformer import lm_init as j_lm_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.gemma_7b import CONFIG as P_GEMMA  # noqa: E402
from repro_torch.configs.qwen3_4b import CONFIG as P_QWEN  # noqa: E402
from repro_torch.configs.yi_6b import CONFIG as P_YI  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as faops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import module as PM  # noqa: E402
from repro_torch.models.transformer import LMConfig, lm_init  # noqa: E402

jax.config.update("jax_platforms", "cpu")

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _tree_t(tree):
    """A JAX params tree -> the same nesting of fp32 / bf16 tensors."""
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return _t(a.astype(np.float32), dt)


# ----------------------------------------------------------------- layers --
def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        got = PL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_layernorm_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32) * 3
    scale = rng.normal(size=(24,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(24,)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    got = PL.rmsnorm_apply({"scale": _t(scale, tdt)}, _t(x, tdt))
    want = JL.rmsnorm_apply({"scale": jnp.asarray(scale, jdt)},
                            jnp.asarray(x, jdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)
    p = {"scale": scale, "bias": bias}
    got = PL.layernorm_apply({k: _t(v, tdt) for k, v in p.items()},
                             _t(x, tdt))
    want = JL.layernorm_apply({k: jnp.asarray(v, jdt) for k, v in p.items()},
                              jnp.asarray(x, jdt))
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_mlp_matches_reference(act, dtype):
    p = JL.glu_mlp_init(jax.random.PRNGKey(2), 32, 64, jnp.dtype(dtype))
    x = np.random.default_rng(2).normal(size=(2, 7, 32)).astype(np.float32)
    want = JL.glu_mlp_apply(p, jnp.asarray(x, jnp.dtype(dtype)), act)
    got = PL.glu_mlp_apply(_tree_t(p), _t(x, getattr(torch, dtype)), act)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(F32 if dtype == "float32" else BF16))


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(PL.ACTS["gelu"](torch.from_numpy(x)).numpy(),
                               _np(jax.nn.gelu(jnp.asarray(x))), **F32)
    for name in ("silu", "relu", "tanh"):
        np.testing.assert_allclose(
            PL.ACTS[name](torch.from_numpy(x)).numpy(),
            _np(JL.ACTS[name](jnp.asarray(x))), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_attend_and_dense_match_reference(dtype):
    """embedding_attend gives fp32 logits from bf16 inputs (no bf16
    rounding of the output); dense_apply keeps the input's dtype."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    emb = JL.embedding_init(jax.random.PRNGKey(3), 300, 32, jdt)
    dense = JL.dense_init(jax.random.PRNGKey(4), 32, 48, jdt)
    dense["bias"] = jnp.asarray(
        np.random.default_rng(4).normal(size=48), jdt)
    x = np.random.default_rng(3).normal(size=(4, 32)).astype(np.float32)
    ids = np.random.default_rng(5).integers(0, 300, (3, 6))
    got = PL.embedding_attend(_tree_t(emb), _t(x, tdt))
    want = JL.embedding_attend(emb, jnp.asarray(x, jdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    got = PL.embedding_apply(_tree_t(emb), torch.from_numpy(ids))
    np.testing.assert_array_equal(
        got.float().numpy(), _np(JL.embedding_apply(emb, jnp.asarray(ids))))
    got = PL.dense_apply(_tree_t(dense), _t(x, tdt))
    want = JL.dense_apply(dense, jnp.asarray(x, jdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(F32 if dtype == "float32" else BF16))


def test_mlp_matches_reference():
    p = JL.mlp_init(jax.random.PRNGKey(6), [16, 32, 8])
    x = np.random.default_rng(6).normal(size=(5, 16)).astype(np.float32)
    for final in (False, True):
        got = PL.mlp_apply(_tree_t(p), _t(x), "relu", final)
        want = JL.mlp_apply(p, jnp.asarray(x), "relu", final)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_module_helpers_match_reference():
    p = JL.glu_mlp_init(jax.random.PRNGKey(7), 8, 12, jnp.bfloat16)
    p["step"] = jnp.asarray(3, jnp.int32)
    tp = _tree_t({k: v for k, v in p.items() if k != "step"})
    tp["step"] = torch.tensor(3, dtype=torch.int32)
    assert PM.param_count(tp) == JM.param_count(p)
    assert PM.param_bytes(tp) == JM.param_bytes(p)
    cast = PM.cast_floating(tp, torch.float32)
    assert cast["gate"]["kernel"].dtype == torch.float32
    assert cast["step"].dtype == torch.int32
    assert [k for k, _ in PM.flatten_with_paths(tp)] == \
        [k for k, _ in JM.flatten_with_paths(p)]
    mod = PM.as_module({k: v for k, v in tp.items() if k != "step"})
    assert PM.param_count(mod) == JM.param_count(p) - 1
    assert not any(t.requires_grad for t in mod.parameters())
    assert PM.cast_floating(mod, torch.float32) is mod
    assert mod["up"]["kernel"].dtype == torch.float32


# ---------------------------------------------------------- attend_train --
ATTN_CASES = {
    "full": dict(),
    "full-gqa": dict(n_kv_heads=2),
    "full-mqa-qknorm": dict(n_kv_heads=1, qk_norm=True),
    "full-logit-cap": dict(logit_cap=5.0),
    "full-nope": dict(use_rope=False),
    "swa": dict(kind="swa", window=7),
    "swa-qchunked": dict(kind="swa", window=20, q_chunk=16),
    "chunked": dict(kind="chunked", chunk=16, n_kv_heads=2),
    "chunked-qchunked": dict(kind="chunked", chunk=24, q_chunk=16),
}


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attend_train_matches_reference(name):
    kw = {**dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
                 rope_theta=10_000.0, q_chunk=1024), **ATTN_CASES[name]}
    jcfg, pcfg = JA.AttnConfig(**kw), PA.AttnConfig(**kw)
    p = JA.attn_init(jax.random.PRNGKey(8), jcfg)
    x = np.random.default_rng(8).normal(size=(2, 64, 32)).astype(np.float32)
    want = JA.attend_train(p, jcfg, jnp.asarray(x))
    reset_launches()
    got = PA.attend_train(_tree_t(p), pcfg, _t(x))
    assert LAUNCHES["flash_attention"] == 0        # the CPU: plain version
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    # head_dim 8 is not a width the kernel takes; at 16 the full kinds go
    # to it
    assert not PA.uses_kernel(pcfg, torch.float32)
    assert PA.uses_kernel(dataclasses.replace(pcfg, head_dim=16),
                          torch.float32) == (
        name in ("full", "full-gqa", "full-mqa-qknorm", "full-nope"))


def test_attend_train_explicit_positions_take_sdpa():
    """Positions given by the caller (shifted here) run _sdpa, as the
    reference does; the kernel's case is the default 0..S-1 only."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, q_chunk=16)
    jcfg, pcfg = JA.AttnConfig(**kw), PA.AttnConfig(**kw)
    p = JA.attn_init(jax.random.PRNGKey(9), jcfg)
    x = np.random.default_rng(9).normal(size=(2, 48, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48) + 5, (2, 48)).astype(np.int32)
    assert not PA.uses_kernel(dataclasses.replace(pcfg, head_dim=16),
                              torch.float32, torch.from_numpy(pos))
    want = JA.attend_train(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = PA.attend_train(_tree_t(p), pcfg, _t(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    # the default positions through the kernel's path equal _sdpa's
    want = JA.attend_train(p, jcfg, jnp.asarray(x))
    got = PA.attend_train(_tree_t(p), pcfg, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_uses_kernel_sends_only_what_the_kernel_takes():
    """float16 and head_dims the kernel refuses (8, 24: not a multiple of
    16; 272: past 256) go to _sdpa; gemma-7b's bf16 at D 256 and the
    float32 and bfloat16 multiples of 16 go to the kernel."""
    gemma = P_GEMMA.attn_cfg(0)
    assert gemma.head_dim == 256
    assert PA.uses_kernel(gemma, torch.bfloat16)
    assert PA.uses_kernel(gemma, torch.float32)
    assert not PA.uses_kernel(gemma, torch.float16)
    base = PA.AttnConfig(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16)
    for d, want in ((8, False), (16, True), (24, False), (128, True),
                    (272, False)):
        cfg = dataclasses.replace(base, head_dim=d)
        assert PA.uses_kernel(cfg, torch.bfloat16) == want, d
        assert not PA.uses_kernel(cfg, torch.float16), d


def test_attend_train_float16_takes_sdpa():
    """A float16 full-attention layer runs _sdpa, never the kernel (which
    raises on float16 on the card), and agrees with the float32 layer to
    float16 rounding."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    pcfg = PA.AttnConfig(**kw)
    p = JA.attn_init(jax.random.PRNGKey(11), JA.AttnConfig(**kw))
    x = np.random.default_rng(11).normal(size=(2, 24, 64)).astype(np.float32)
    calls = []
    kernel_attn = PA.causal_attention
    PA.causal_attention = lambda *a: calls.append(a) or kernel_attn(*a)
    try:
        half = PA.attend_train(
            {k: {n: v.half() for n, v in d.items()}
             for k, d in _tree_t(p).items()}, pcfg, _t(x, torch.float16))
        full = PA.attend_train(_tree_t(p), pcfg, _t(x))
    finally:
        PA.causal_attention = kernel_attn
    assert len(calls) == 1 and calls[0][0].dtype == torch.float32
    assert half.dtype == torch.float16
    np.testing.assert_allclose(half.float().numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_attend_train_bf16_matches_reference():
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    jcfg, pcfg = JA.AttnConfig(**kw), PA.AttnConfig(**kw)
    p = JA.attn_init(jax.random.PRNGKey(10), jcfg, jnp.bfloat16)
    x = np.random.default_rng(10).normal(size=(2, 40, 64)).astype(np.float32)
    want = JA.attend_train(p, jcfg, jnp.asarray(x, jnp.bfloat16))
    got = PA.attend_train(_tree_t(p), pcfg, _t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **BF16)


def test_mask_kinds_match_reference():
    q = np.arange(10, 30)
    k = np.arange(0, 30)
    for kind in ("full", "swa", "chunked"):
        got = PA._mask(kind, torch.from_numpy(q), torch.from_numpy(k), 6, 8)
        want = JA._mask(kind, jnp.asarray(q), jnp.asarray(k), 6, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        PA._mask("ring", torch.from_numpy(q), torch.from_numpy(k), 6, 8)


# ------------------------------------------------------- flash attention --
FLASH_CASES = [                  # tests/test_kernels.py's sweep
    (2, 3, 128, 32, 32, 32),
    (1, 4, 256, 64, 64, 128),
    (2, 2, 64, 16, 64, 32),
]


def _qkv(B, H, S, D, dtype, Hkv=None):
    rng = np.random.default_rng(B * S + D)
    Hkv = H if Hkv is None else Hkv
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    # rounded to the dtype once, so both packages see the same values
    q, k, v = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("B,H,S,D,tq,tk", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_oracle(B, H, S, D, tq, tk,
                                                         dtype):
    q, k, v = _qkv(B, H, S, D, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    got = flash_attention_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert got.dtype == tdt and got.shape == (B, H, S, D)
    tol = F32 if dtype == "float32" else BF16
    want = j_flash_ref(jq, jk, jv)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)
    pallas = j_flash(jq, jk, jv, tq=tq, tk=tk, interpret=True)
    np.testing.assert_allclose(
        got.float().numpy(), _np(pallas),
        rtol=3e-2 if dtype == "bfloat16" else 2e-4, atol=3e-2)
    # in query chunks (the card's 32k check): the same rows
    chunked = flash_attention_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                  q_chunk=48)
    np.testing.assert_allclose(chunked.float().numpy(),
                               got.float().numpy(), **F32)


@pytest.mark.parametrize("Hkv", [1, 2])
def test_flash_attention_plain_groups_heads_as_the_reference_broadcasts(Hkv):
    """GQA: query head h reads KV head h // (H / Hkv), which equals the
    reference callers' broadcast of k and v to H heads."""
    B, H, S, D = 2, 4, 40, 16
    q, k, v = _qkv(B, H, S, D, "float32", Hkv)
    G = H // Hkv
    want = j_flash_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=1)),
                       jnp.asarray(np.repeat(v, G, axis=1)))
    got = flash_attention_ref(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_causal_attention_dispatch_on_cpu_takes_the_plain_version():
    q, k, v = (_t(a) for a in _qkv(1, 2, 70, 32, "float32"))
    reset_launches()
    got = faops.causal_attention(q, k, v)
    assert torch.equal(got, flash_attention_ref(q, k, v, q_chunk=1024))
    assert LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        faops.flash_attention(q, k, v)


def test_flash_attention_layout_helper_keeps_strided_views():
    """A [B, S, H, D] tensor's transpose(1, 2) is read in place (no copy);
    a view the kernel cannot read in 16-byte pieces is copied."""
    x = torch.zeros(2, 9, 3, 32, dtype=torch.bfloat16).transpose(1, 2)
    assert faops._aligned(x).data_ptr() == x.data_ptr()
    odd = torch.zeros(2, 3, 9, 40)[..., :36]            # row stride 40
    assert faops._aligned(odd) is odd
    skew = torch.zeros(2 * 3 * 9 * 32 + 1)[1:].view(2, 3, 9, 32)
    assert faops._aligned(skew).data_ptr() != skew.data_ptr()


# ------------------------------------------------- flash_attention's plan --
def _plan_strides(B, H, Hkv, S, D, layout):
    """The element strides (batch, head, position) of q, k, v and o in the
    given layout, from tensors on the meta device (no memory)."""
    def one(h):
        if layout == "bshd":
            t = torch.empty(B, S, h, D, device="meta").transpose(1, 2)
        else:
            t = torch.empty(B, h, S, D, device="meta")
        return t.stride()[:3]
    return one(H), one(Hkv), one(Hkv), one(H)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("D", list(range(16, 257, 16)))
def test_flash_plan_fits_the_card_and_tma(D, layout):
    """The bf16 launch plan at every head_dim the kernel takes, at lengths
    on either side of the tile edges: shared memory within the card's
    227 KB, TMA boxes of at most 128 bytes inside and 256 elements a
    dimension over 16-byte strides, the caller's strides read in place, a
    grid under 2**31 blocks numbered longest first."""
    B, H, Hkv = 2, 4, 2
    for S in (1, 63, 64, 65, 127, 128, 129, 32768):
        strides = _plan_strides(B, H, Hkv, S, D, layout)
        plan = faops.flash_plan(B, H, Hkv, S, D, torch.bfloat16, strides)
        assert plan.DT >= D and plan.DT % faops.BOX_COLS == 0
        assert (plan.BQ, plan.threads) == (128, 384) and plan.stages >= 2
        assert plan.smem <= faops.SMEM_LIMIT
        assert len(plan.maps) == 4            # q, k, v and the output o
        for m, heads, st in zip(plan.maps, (H, Hkv, Hkv, H), strides):
            assert m.dims == (D, S, heads, B)
            assert m.strides == tuple(2 * x for x in reversed(st))
            assert all(x % 16 == 0 and 0 < x < 2 ** 40 for x in m.strides)
            assert m.box[0] * 2 <= 128 and m.box[2:] == (1, 1)
            assert all(0 < b <= 256 for b in m.box)
        n_qt = -(-S // plan.BQ)
        assert plan.grid == n_qt * B * H < 2 ** 31
        # block_work: every (batch, head, query tile) once, longest first
        blocks = [plan.work(i) for i in range(plan.grid)]
        assert sorted(blocks) == sorted((b, h, t) for b in range(B)
                                        for h in range(H)
                                        for t in range(n_qt))
        assert all(x[2] >= y[2] for x, y in zip(blocks, blocks[1:]))
        assert [x[2] for x in blocks[:B * H]] == [n_qt - 1] * (B * H)


@pytest.mark.parametrize("D", [16, 80, 256])
def test_flash_plan_fp32_and_the_grid_limit(D):
    """fp32 runs the FMA kernel: 16-row blocks, no tensor maps. A grid of
    2**31 blocks or more is refused before any launch."""
    plan = faops.flash_plan(1, 2, 1, 100, D, torch.float32)
    assert (plan.DT, plan.BQ, plan.BK, plan.threads) == (D, 16, 32, 256)
    assert plan.maps is None and plan.grid == 7 * 2
    assert plan.smem == (16 * D + 32 * (D + 1) + 32 * D) * 4
    assert plan.as_array()[7:] == [0] * 44
    with pytest.raises(ValueError, match="exceed the grid"):
        faops.flash_plan(2 ** 16, 256, 1, 2 ** 16, D, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        faops.flash_plan(1, 2, 1, 100, D, torch.float16)


# ------------------------------------------------------------- the prefill --
def _tiny_lm(name, **kw):
    """tests/test_smoke_archs.py's reduced LM variants."""
    base = dict(name=name, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, vocab=512, param_dtype="float32",
                q_chunk=32)
    base.update(kw)
    return base


LM_VARIANTS = {
    "gemma-7b": _tiny_lm("gemma-7b", act="gelu", embed_scale=True,
                         tie_embeddings=True),
    "yi-6b": _tiny_lm("yi-6b", n_kv_heads=2, tie_embeddings=False),
    "qwen3-4b": _tiny_lm("qwen3-4b", n_kv_heads=2, qk_norm=True),
}


def _prefill_pair(name, dtype, seed=0, B=3, S=64):
    kw = dict(LM_VARIANTS[name], param_dtype=dtype)
    jcfg, pcfg = JLMConfig(**kw), LMConfig(**kw)
    params = jax.device_get(j_lm_init(jax.random.PRNGKey(seed), jcfg))
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, S))
    want = jax.jit(JS.build_lm_prefill(jcfg))(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    model = convert.lm_params_from_reference(params, pcfg, device="cpu")
    reset_launches()
    got = PS.build_lm_prefill(pcfg)(model, {"tokens": torch.from_numpy(
        tokens)})
    assert all(v == 0 for v in LAUNCHES.values())
    return params, model, want, got


@pytest.mark.parametrize("name", list(LM_VARIANTS))
def test_prefill_fp32_matches_reference(name):
    """fp32: the last hidden state to 1e-5, the logits to 1e-4 (measured
    on this data: under 1e-5), next tokens equal."""
    _, _, want, got = _prefill_pair(name, "float32")
    assert got["logits"].dtype == torch.float32
    np.testing.assert_allclose(got["hidden"].numpy(), _np(want["hidden"]),
                               **F32)
    np.testing.assert_allclose(got["logits"].numpy(), _np(want["logits"]),
                               rtol=1e-4, atol=1e-4)
    assert got["next_token"].dtype == torch.int32
    np.testing.assert_array_equal(
        got["next_token"].numpy(),
        np.asarray(jnp.argmax(want["logits"], -1)))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", list(LM_VARIANTS))
def test_prefill_bf16_matches_reference(name):
    """bf16: the last hidden state and the logits to a relative L2 error of
    3e-2 (measured on this data: 6e-3 to 1.6e-2). The two packages round
    some bf16 intermediates apart by one unit: the reference's CPU
    activations round after each op of x·sigmoid(x) and of the tanh form
    of gelu, the port's fused F.silu / F.gelu once; two layers carry a few
    such units into the hidden state. Next tokens are equal wherever the
    reference's top-2 gap is not a near tie (2e-2 of the top logit)."""
    _, _, want, got = _prefill_pair(name, "bfloat16", seed=1)
    assert got["hidden"].dtype == torch.bfloat16
    assert got["logits"].dtype == torch.float32
    assert _rel_l2(got["hidden"].float().numpy(), want["hidden"]) <= 3e-2
    logits, ref = got["logits"].numpy(), _np(want["logits"])
    assert _rel_l2(logits, ref) <= 3e-2
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2e-2 * np.abs(top2[:, 1])
    np.testing.assert_array_equal(got["next_token"].numpy()[clear],
                                  ref.argmax(-1)[clear])


@pytest.mark.parametrize("name", list(LM_VARIANTS))
def test_lm_params_round_trip_through_the_reference_layout(name):
    params, model, _, _ = _prefill_pair(name, "bfloat16", seed=2, B=1, S=8)
    back = convert.lm_params_to_reference(model)
    got, want = JM.flatten_with_paths(back), JM.flatten_with_paths(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32), path)
    again = convert.lm_params_from_reference(back, model.cfg, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_model_parameter_names_follow_the_reference_paths():
    cfg = LMConfig(**dict(LM_VARIANTS["qwen3-4b"], n_layers=4))
    model = lm_init(cfg, seed=3, device="cpu")
    jparams = j_lm_init(jax.random.PRNGKey(0), JLMConfig(**dict(
        LM_VARIANTS["qwen3-4b"], n_layers=4)))
    names = {n for n, _ in model.named_parameters()}
    want = set()
    for path, leaf in JM.flatten_with_paths(jparams):
        parts = path.split("/")
        if parts[0] != "layers":
            want.add(".".join(parts))
            continue
        for g in range(leaf.shape[0]):
            want.add(".".join(["layers", str(g)] + parts[2:]))
    assert names == want
    assert PM.param_count(model) == JM.param_count(jparams)
    # n_params counts no qk-norm scales, in both packages
    assert PM.param_count(model) == cfg.n_params + 4 * 2 * 16
    assert model["layers"][1]["attn"]["q_proj"]["kernel"].shape == (64, 64)


def test_lm_init_distributions_and_seed():
    cfg = LMConfig(**dict(LM_VARIANTS["gemma-7b"], d_model=256, d_ff=512))
    a = lm_init(cfg, seed=5, device="cpu")
    b = lm_init(cfg, seed=5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    w = a["layers"][0]["mlp"]["gate"]["kernel"]
    assert abs(float(w.std()) * 256 ** 0.5 - 1) < 0.05
    t = a["embed"]["table"]
    assert abs(float(t.std()) * 256 ** 0.5 - 1) < 0.05
    assert float(a["ln_final"]["scale"].abs().sum()) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_init(cfg, device="cuda")


def test_embed_scale_rounds_to_the_activation_dtype(monkeypatch):
    """sqrt(3072) = 55.4256 is 55.5 in bf16: the first layer's input is
    the embedding times the rounded factor, bit for bit the reference's
    ``x * jnp.asarray(sqrt(d), x.dtype)``."""
    cfg = LMConfig(name="gemma-7b", n_layers=1, d_model=3072, n_heads=1,
                   n_kv_heads=1, head_dim=16, d_ff=16, vocab=16,
                   act="gelu", embed_scale=True)
    model = lm_init(cfg, seed=0, device="cpu")
    tokens = torch.tensor([[3, 7, 1]])
    seen = []
    rms = PL.rmsnorm_apply
    monkeypatch.setattr(PL, "rmsnorm_apply",
                        lambda p, x, *a: seen.append(x) or rms(p, x, *a))
    PS.build_lm_prefill(cfg)(model, {"tokens": tokens})
    table = model["embed"]["table"][tokens]
    assert torch.equal(seen[0], table * torch.tensor(55.5,
                                                     dtype=torch.bfloat16))
    want = jnp.asarray(table.float().numpy(), jnp.bfloat16) * jnp.asarray(
        3072 ** 0.5, jnp.bfloat16)
    np.testing.assert_array_equal(seen[0].float().numpy(), _np(want))
    assert not torch.equal(seen[0], (table.float() * 3072 ** 0.5).to(
        torch.bfloat16))


def test_next_token_breaks_ties_toward_the_smaller_id():
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    assert PS.next_token(logits).tolist() == [1, 0]
    assert PS.next_token(logits).dtype == torch.int32
    np.testing.assert_array_equal(
        PS.next_token(logits).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)))


@pytest.mark.parametrize("jcfg,pcfg", [(J_GEMMA, P_GEMMA), (J_QWEN, P_QWEN),
                                       (J_YI, P_YI)])
def test_configs_copy_the_reference_value_for_value(jcfg, pcfg):
    """Every field equals the reference's, the mesh's seq_shard_attn and
    the attention's seq_shard included, with it off and on."""
    def same_fields(port, ref):
        got, want = dataclasses.asdict(port), dataclasses.asdict(ref)
        assert got == {k: want[k] for k in got}
        defaults = {f.name: f.default for f in dataclasses.fields(ref)}
        assert {k: want[k] for k in want if k not in got} == \
            {k: defaults[k] for k in want if k not in got}
        return set(want) - set(got)

    assert same_fields(pcfg, jcfg) == set()
    assert pcfg.n_params == jcfg.n_params
    assert pcfg.n_active_params == jcfg.n_active_params
    for on in (False, True):
        p = dataclasses.replace(pcfg, seq_shard_attn=on)
        j = dataclasses.replace(jcfg, seq_shard_attn=on)
        for i in range(pcfg.period):
            assert same_fields(p.attn_cfg(i), j.attn_cfg(i)) == set()
