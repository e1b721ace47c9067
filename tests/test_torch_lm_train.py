"""The port's LM training path against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``repro`` and its
counterpart in ``repro_torch``: ``chunked_xent`` at one chunk and several,
``lm_loss``, ``attend_train`` under a gradient for the full, swa and
chunked kinds, and ``build_lm_train_step`` for each of the five reduced LM
configs the reference launcher trains (``repro_torch.launch.train.
LM_VARIANTS``, equal field for field to ``tests/test_smoke_archs.
LM_VARIANTS``), in both microbatch groupings and with ``n_micro`` not
dividing the batch. The JAX draws cross by ``convert.lm_tree_from_
reference`` and ``convert.adamw_state_from_reference``.

Tolerances: outputs and gradients to 1e-5 relative to each leaf's largest
|g| (the gradient against ``jax.value_and_grad``); after an AdamW step,
whose first update is about lr·sign(g), the parameters and moments are
compared where |g| is above 1e-3 of the leaf's largest |g|, and the count
of the rest is bounded (a near-zero gradient's sign may differ between
packages and move its parameter by 2·lr).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import steps as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.launch.train import LM_VARIANTS  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.module import (map_with_paths,  # noqa: E402
                                       tensor_tree)

from test_smoke_archs import LM_VARIANTS as J_VARIANTS  # noqa: E402
from torch_grad_check import (ZERO_LEAF, _grad_tree, _leaves,  # noqa: E402
                              _np, _requires_grad, assert_grads,
                              assert_step)

jax.config.update("jax_platforms", "cpu")

B, S = 4, 64


@pytest.fixture(autouse=True)
def one_thread():
    """These models are tiny: one intra-op thread runs them fastest and
    keeps a worker from oversubscribing the cores it shares with the
    others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab, seed=0, gb=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (gb, S)).astype(np.int32),
            rng.integers(0, vocab, (gb, S)).astype(np.int32))


# --------------------------------------------------------------- configs --
def test_lm_variants_equal_the_reference_field_for_field():
    assert list(LM_VARIANTS) == list(J_VARIANTS)
    for name, cfg in LM_VARIANTS.items():
        ref = J_VARIANTS[name]
        for f in dataclasses.fields(cfg):
            want = getattr(ref, f.name)
            got = getattr(cfg, f.name)
            if f.name == "moe" and want is not None:
                assert {g.name: getattr(got, g.name) for g in
                        dataclasses.fields(got)} == {
                    g.name: getattr(want, g.name)
                    for g in dataclasses.fields(got)}, name
            else:
                assert got == want, (name, f.name)


# ------------------------------------------------------------ chunked CE --
@pytest.mark.parametrize("ce_chunk,tied", [(64, True), (4 * 16, False),
                                           (4 * 8, True)],
                         ids=["one-chunk", "several-untied", "several-tied"])
def test_chunked_xent_value_and_grads(ce_chunk, tied):
    """One chunk (ce_chunk // B >= S... or S // Cs <= 1) and several, tied
    and untied head: the loss and its gradients in h and the params."""
    name = "gemma-7b" if tied else "yi-6b"
    jc = dataclasses.replace(J_VARIANTS[name], ce_chunk=ce_chunk)
    pc = dataclasses.replace(LM_VARIANTS[name], ce_chunk=ce_chunk)
    params = JT.lm_init(jax.random.PRNGKey(3), jc)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    labels = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    head = {k: v for k, v in params.items() if k in ("embed", "lm_head")}

    jv, (jgh, jgp) = jax.jit(jax.value_and_grad(
        lambda hh, p: JT.chunked_xent(p, jc, hh, jnp.asarray(labels),
                                      jnp.asarray(mask)),
        argnums=(0, 1)))(jnp.asarray(h), head)
    ph = torch.from_numpy(h).requires_grad_(True)
    pp = convert.tree_from_reference(jax.device_get(head), device="cpu")
    _requires_grad(pp)
    pv = PT.chunked_xent(pp, pc, ph, torch.from_numpy(labels),
                         torch.from_numpy(mask))
    pv.backward()
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-5)
    assert_grads({"h": ph.grad.numpy()}, {"h": jax.device_get(jgh)})
    assert_grads(_grad_tree(pp), jax.device_get(jgp))


# ---------------------------------------------------- attention under grad --
@pytest.mark.parametrize("kind", ["full", "swa", "chunked"])
def test_attend_train_under_a_gradient(kind):
    """Several query chunks, each recomputed in the backward: output and
    gradients in x and the projections, and no kernel (the plain path on
    the CPU; the choice is ``uses_kernel(..., grad=True)``: False)."""
    cfg = JA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                        kind=kind, window=12, chunk=16, q_chunk=8,
                        qk_norm=kind == "swa")
    pcfg = PA.AttnConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(PA.AttnConfig)})
    assert not PA.uses_kernel(pcfg, torch.float32, grad=True)
    p = JA.attn_init(jax.random.PRNGKey(2), cfg)
    x = np.random.default_rng(4).normal(size=(2, 32, 32)).astype(np.float32)
    g_out = np.random.default_rng(5).normal(size=(2, 32, 32)).astype(
        np.float32)

    def jf(pp, xx):
        return jnp.sum(JA.attend_train(pp, cfg, xx) * g_out)
    jy = jax.jit(lambda pp, xx: JA.attend_train(pp, cfg, xx))(
        p, jnp.asarray(x))
    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(p, jnp.asarray(x))

    pp = convert.tree_from_reference(jax.device_get(p), device="cpu")
    _requires_grad(pp)
    px = torch.from_numpy(x).requires_grad_(True)
    reset_launches()
    py = PA.attend_train(pp, pcfg, px)
    (py * torch.from_numpy(g_out)).sum().backward()
    assert sum(LAUNCHES.values()) == 0
    np.testing.assert_allclose(py.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    assert_grads({"x": px.grad.numpy()}, {"x": _np(jgx)})
    assert_grads(_grad_tree(pp), jax.device_get(jgp))


# --------------------------------------------------------------- lm_loss --
_JIT = {}


@functools.lru_cache(maxsize=None)
def _j_params(name):
    """The JAX draws of a variant (key 0), shared by its tests: the port's
    side copies them (``convert``), so no test changes another's."""
    return JT.lm_init(jax.random.PRNGKey(0), J_VARIANTS[name])


def _j_loss_grad(name):
    if name not in _JIT:
        jc = J_VARIANTS[name]
        _JIT[name] = jax.jit(jax.value_and_grad(
            lambda p, t, lb: JT.lm_loss(p, jc, t, lb), has_aux=True))
    return _JIT[name]


@pytest.mark.parametrize("name", list(LM_VARIANTS))
def test_lm_loss_and_grads_match_reference(name):
    """``lm_loss`` (ce + 0.01·aux, with the remat groups and the chunked
    attention under the gradient) and its gradient in every leaf, one
    microbatch, against ``jax.value_and_grad``."""
    jc, pc = J_VARIANTS[name], LM_VARIANTS[name]
    params = _j_params(name)
    toks, labs = _batch(jc.vocab)
    (jl, jaux), jg = _j_loss_grad(name)(params, jnp.asarray(toks[:2]),
                                        jnp.asarray(labs[:2]))
    pp = convert.lm_tree_from_reference(jax.device_get(params), pc,
                                        device="cpu")
    reset_launches()
    loss, metrics, pg = PS.grads_of(
        lambda p, t, lb: PT.lm_loss(p, pc, t, lb), pp,
        torch.from_numpy(toks[:2]), torch.from_numpy(labs[:2]))
    assert sum(LAUNCHES.values()) == 0
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jaux["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"].detach()),
                               float(jaux["aux"]),
                               rtol=1e-5, atol=1e-6)
    assert_grads(convert.lm_params_to_reference(pg, pc),
                 jax.device_get(jg))


# ------------------------------------------------------------ train step --
# llama4's plain grouping is left out for the suite's time (its strided
# case and its lm_loss gradients run); the others run both groupings
CASES = [(n, 2, "strided") for n in LM_VARIANTS] \
    + [(n, 2, "plain") for n in LM_VARIANTS if not n.startswith("llama4")] \
    + [("gemma-7b", 3, "strided"), ("mixtral-8x7b", 3, "plain")]


@pytest.mark.parametrize("name,n_micro,grouping", CASES,
                         ids=[f"{n}-{m}-{g}" for n, m, g in CASES])
def test_lm_train_step_matches_reference(name, n_micro, grouping):
    """One AdamW step of ``build_lm_train_step`` from the JAX draws: loss
    and grad_norm to 1e-5; the accumulated gradient (recovered from the
    first moment m = (1 - b1)·clip(g)) to 1e-5 of each leaf's largest |g|;
    the updated params and both moments under the sign rule. n_micro = 3
    does not divide the batch of 4: one microbatch, as the reference."""
    jc, pc = J_VARIANTS[name], LM_VARIANTS[name]
    params = _j_params(name)
    toks, labs = _batch(jc.vocab, seed=7)
    jstep, jopt = JS.build_lm_train_step(jc, "adamw_nomaster",
                                         n_micro=n_micro,
                                         micro_split=grouping, lr=1e-3)
    jstate = {"params": params, "opt": jopt.init(params)}
    jnew, jm = jax.jit(jstep)(jstate, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labs)})
    jnew = jax.device_get(jnew)

    host = jax.device_get(jstate)
    pp = convert.lm_tree_from_reference(host["params"], pc, device="cpu")
    popt = convert.adamw_state_from_reference(
        host["opt"], lambda t, device: convert.lm_tree_from_reference(
            t, pc, device=device), device="cpu")
    pstep, _ = PS.build_lm_train_step(pc, "adamw_nomaster", n_micro=n_micro,
                                      micro_split=grouping, lr=1e-3)
    reset_launches()
    pnew, pm = pstep({"params": pp, "opt": popt},
                     {"tokens": toks, "labels": labs})
    assert sum(LAUNCHES.values()) == 0
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    to_ref = lambda t: convert.lm_params_to_reference(t, pc)  # noqa: E731
    back = convert.adamw_state_to_reference(pnew["opt"], to_ref)
    assert int(back["step"]) == int(jnew["opt"]["step"]) == 1
    # m = (1 - b1) · clip(g): the clipped gradient of each package
    g_ref = jax.tree.map(lambda m: _np(m) / 0.1, jnew["opt"]["m"])
    g_got = jax.tree.map(lambda m: _np(m) / 0.1, back["m"])
    assert_grads(g_got, g_ref)
    assert_grads(back["v"], jnew["opt"]["v"], zero_leaf=ZERO_LEAF ** 2)
    rest = assert_step(to_ref(pnew["params"]), jnew["params"], g_ref, 1e-3)
    n = sum(a.size for _, a in _leaves(g_ref))
    assert rest < 0.1 * n, (rest, n)


def test_lm_train_step_mesh_waits(tmp_path):
    """build_lm_train_step(mesh=) builds a step (it raised before the
    mesh machinery came); on a one-rank gloo mesh, from the JAX draws, the
    gradient it takes (``lm_grads`` on the placed state, two microbatches)
    and its loss equal ``jax.value_and_grad`` of the reference's
    ``lm_loss`` on the whole batch (a dense model: the mean of the
    microbatch means is the batch mean), and its first step's loss and
    grad_norm equal the meshless step's (``tests/test_torch_mesh_lm.py``
    holds every LM family on 4 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.lm_common import lm_rules
    from torch_dist_ranks import one_rank_group
    pc = LM_VARIANTS["gemma-7b"]
    tree = convert.lm_tree_from_reference(jax.device_get(_j_params(
        "gemma-7b")), pc, device="cpu")
    toks, labs = _batch(pc.vocab)
    batch = {"tokens": toks, "labels": labs}
    step, opt = PS.build_lm_train_step(pc, "adamw_nomaster", n_micro=2)
    _, want = step({"params": tree, "opt": opt.init(tree)}, batch)
    tree = convert.lm_tree_from_reference(jax.device_get(_j_params(
        "gemma-7b")), pc, device="cpu")
    with one_rank_group(tmp_path):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        mstep, _ = PS.build_lm_train_step(pc, "adamw_nomaster", n_micro=2,
                                          mesh=mesh)
        specs = lm_rules(pc).specs(tree)
        state = PS.place_train_state(
            {"params": tree, "opt": opt.init(tree)}, specs,
            PS.opt_state_specs("adamw_nomaster", tree, specs, mesh), mesh)
        mb = PS._placed(state["params"], batch, mesh)
        mloss, mg = PS.lm_grads(state["params"], pc, mb["tokens"],
                                mb["labels"], 2)
        mloss = float(mloss.full_tensor() if hasattr(mloss, "full_tensor")
                      else mloss)
        mg = map_with_paths(lambda _, t: t.full_tensor(), mg)
        _, got = mstep(state, batch)
    (jl, _), jg = _j_loss_grad("gemma-7b")(
        _j_params("gemma-7b"), jnp.asarray(toks), jnp.asarray(labs))
    np.testing.assert_allclose(mloss, float(jl), rtol=1e-5)
    assert_grads(convert.lm_params_to_reference(mg, pc), jax.device_get(jg))
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"])


def test_remat_and_chunks_recompute_the_same_loss():
    """remat on and off give the same loss and gradients (the recompute
    sees the same inputs: no in-place write touches a saved tensor), and
    the module and its tensor_tree run the same forward."""
    pc = LM_VARIANTS["mixtral-8x7b"]
    model = PT.lm_init(pc, seed=0, device="cpu")
    tree = tensor_tree(model)
    toks, labs = _batch(pc.vocab)
    t, lb = torch.from_numpy(toks[:2]), torch.from_numpy(labs[:2])
    outs = []
    for remat in (True, False):
        cfg = dataclasses.replace(pc, remat=remat)
        loss, _, g = PS.grads_of(lambda p, a, b: PT.lm_loss(p, cfg, a, b),
                                 tree, t, lb)
        outs.append((float(loss), convert.lm_params_to_reference(g, pc)))
    assert outs[0][0] == outs[1][0]
    assert_grads(outs[0][1], outs[1][1], tol=1e-6)
    with torch.no_grad():
        h1, _ = PT.lm_backbone(model, pc, t)
        h2, _ = PT.lm_backbone(tree, pc, t)
    assert torch.equal(h1, h2)
