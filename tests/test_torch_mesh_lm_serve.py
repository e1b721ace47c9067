"""The LM's prefill and KV-cache decode on a mesh: ``launch/steps.
build_lm_prefill`` and ``build_lm_decode`` on DTensors against the
meshless steps, on the CPU.

One spawn of 4 gloo ranks on a (data 2, model 2) mesh runs every case of
``torch_mesh_serve_ranks.serve_cases`` (the tiny LM variants of
``tests/test_smoke_archs.py`` in fp32, and gemma with 16 kv heads, whose
caches split their heads over "model"): the prefill, three decode steps
in the decode_32k layout (the caches' kv heads or sequence over "model";
a 37-slot context in uneven blocks, a write across the blocks' boundary,
the SWA ring wrapping) and three in the long_500k layout (one row, the
token whole, the sequence over ("data", "model")). Tolerances: logits and
hidden states to 1e-5 of the largest |value|, the caches after each step
to 1e-5 of the largest value, next tokens equal; the mesh prefill bills
one flash_attention call a full-attention layer on each rank, as the
meshless one does.

One case (``torch_mesh_serve_ranks.REF_CASE``) also decodes from the
reference's draws: the mesh steps' logits against the reference's
``lm_decode_step`` on the same caches, at 1e-5 of the largest |logit|.
"""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.models.attention import _kv_heads_of  # noqa: E402
from repro_torch.models.module import flatten_with_paths  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
import torch_mesh_serve_ranks as SR  # noqa: E402

CASES = list(SR.serve_cases())
HAS_JAX = importlib.util.find_spec("jax") is not None
TOL = 1e-5
#: full-attention layers of each case: one flash_attention call each
FULL_LAYERS = {"gemma-7b": 2, "yi-6b": 2, "qwen3-4b": 2, "mixtral-8x7b": 0,
               "llama4-maverick-400b-a17b": 1, "gemma-7b-kv16": 0}
#: the reference's decode: its first positions and tokens
REF_SEED = 4


def _reference():
    import jax
    from repro.models import transformer as JT
    from test_smoke_archs import LM_VARIANTS as J_VARIANTS
    jax.config.update("jax_platforms", "cpu")
    return jax, JT, J_VARIANTS


def _ref_tokens(cfg):
    return np.random.default_rng(REF_SEED).integers(
        0, cfg.vocab, (SR.STEPS, len(SR.FIRST_POS))).astype(np.int32)


@pytest.fixture(scope="module")
def serve_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    if HAS_JAX:
        jax, JT, J_VARIANTS = _reference()
        cfg = SR.serve_cases()[SR.REF_CASE]
        tree = convert.lm_tree_from_reference(jax.device_get(JT.lm_init(
            jax.random.PRNGKey(0), J_VARIANTS[SR.REF_CASE])), cfg,
            device="cpu")
        np.savez(tmp / "ref_decode.npz",
                 **{f"param__{p}": t.numpy()
                    for p, t in flatten_with_paths(tree)},
                 first_pos=np.array(SR.FIRST_POS), seed=REF_SEED,
                 tokens=_ref_tokens(cfg))
    R.spawn(SR.serve_ranks, 4, tmp, timeout=400.0)
    out = {n: dict(np.load(tmp / f"{n}.npz")) for n in CASES}
    out["ties"] = dict(np.load(tmp / "ties.npz"))
    if HAS_JAX:
        out["ref"] = dict(np.load(tmp / "ref_mesh.npz"))
    return out


@pytest.mark.parametrize("name", CASES)
def test_mesh_prefill_equals_the_meshless_prefill(serve_results, name):
    r = serve_results[name]
    assert float(r["prefill_logits_err"]) <= TOL
    assert float(r["prefill_hidden_err"]) <= TOL
    assert bool(r["prefill_tokens_equal"])
    assert bool(r["prefill_outputs_dtensors"])


@pytest.mark.parametrize("name", CASES)
def test_mesh_prefill_calls_the_kernel_on_each_rank(serve_results, name):
    """The mesh prefill's attention takes ``causal_attention`` on the
    rank's block, one call a full-attention layer, as the meshless
    prefill does (its plain version on the CPU, billed as the kernel)."""
    r = serve_results[name]
    assert int(r["prefill_flash"]) == int(r["prefill_flash_meshless"]) \
        == FULL_LAYERS[name]


@pytest.mark.parametrize("layout", ["decode", "long"])
@pytest.mark.parametrize("name", CASES)
def test_mesh_decode_equals_the_meshless_decode(serve_results, name,
                                                layout):
    """Three steps in a row: each step's logits, next tokens and the
    caches after it; the mesh step writes the DTensor caches it was given
    and returns them."""
    r = serve_results[name]
    assert r[f"{layout}_logit_err"].max() <= TOL, r[f"{layout}_logit_err"]
    assert r[f"{layout}_cache_err"].max() <= TOL, r[f"{layout}_cache_err"]
    assert r[f"{layout}_tokens_equal"].all()
    assert r[f"{layout}_dtensor_caches"].all()
    assert len(r[f"{layout}_logit_err"]) == SR.STEPS


def test_cache_layouts_of_the_cases(serve_results):
    """gemma with 16 kv heads splits the caches' heads, every other case
    their sequence (``_cache_sharding`` on a 16-wide "model" axis)."""
    got = {n: str(serve_results[n]["cache_layout"]) for n in CASES}
    assert got == {n: "heads" if n == "gemma-7b-kv16" else "seq"
                   for n in CASES}


def test_next_token_ties_across_vocabulary_blocks(serve_results):
    """Vocabulary-split logits: the greedy token is the smaller id of a
    tie across the ranks' blocks, as ``torch.argmax`` of the whole row
    gives it; the output keeps the rows' layout."""
    t = serve_results["ties"]
    np.testing.assert_array_equal(t["got"], t["want"])
    assert "Shard(dim=0)" in str(t["placements"])


@pytest.mark.skipif(not HAS_JAX, reason="the reference needs jax")
def test_mesh_decode_equals_the_reference(serve_results):
    """The REF_CASE decode on the mesh from the reference's draws against
    the reference's ``lm_decode_step`` on the same caches, positions and
    tokens, step by step: logits to 1e-5 of the largest |logit|, next
    tokens equal to its argmax."""
    jax, JT, J_VARIANTS = _reference()
    jnp = jax.numpy
    jcfg = J_VARIANTS[SR.REF_CASE]
    cfg = SR.serve_cases()[SR.REF_CASE]
    params = JT.lm_init(jax.random.PRNGKey(0), jcfg)
    caches = SR._random_caches(cfg, len(SR.FIRST_POS), SR.CONTEXT, REF_SEED)
    jc = [{n: jnp.asarray(c[n].numpy()) for n in ("k", "v")} for c in caches]
    toks = _ref_tokens(cfg)
    got = serve_results["ref"]
    for s in range(SR.STEPS):
        pos = np.array([p + s for p in SR.FIRST_POS], np.int32)
        want, jc = JT.lm_decode_step(params, jcfg, jnp.asarray(toks[s]), jc,
                                     jnp.asarray(pos))
        want = np.asarray(want)
        err = np.abs(got["logits"][s] - want).max() / np.abs(want).max()
        assert err <= TOL, (s, err)
        np.testing.assert_array_equal(got["tokens"][s], want.argmax(-1))


@pytest.mark.parametrize("H, Kv, h0, H_l, want", [
    (32, 4, 2, 2, (0, 1)),        # yi-6b on a 16-wide axis: one kv head
    (32, 8, 30, 2, (7, 1)),       # qwen3-4b's last rank
    (8, 2, 0, 4, (0, 1)),
    (8, 4, 4, 4, (2, 2)),         # two groups of two query heads
    (6, 2, 2, 2, (0, 2)),         # heads 2, 3 read kv heads 0 and 1
    (12, 4, 3, 3, (1, 1)),
    (12, 4, 2, 3, None),          # heads 2 | 3, 4: 1 and 2 a kv head
])
def test_kv_heads_of_a_rank(H, Kv, h0, H_l, want):
    """The distinct kv heads a rank's query heads read, where the
    kernel's GQA reads them so; None where it cannot (one copy a query
    head instead)."""
    assert _kv_heads_of(H, Kv, h0, H_l) == want
