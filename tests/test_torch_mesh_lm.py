"""The LM train step on a mesh: ``launch/steps.build_lm_train_step(mesh=)``
on DTensors against the meshless step, on the CPU.

One spawn of 4 gloo ranks on a (data 2, model 2) mesh runs every case of
``torch_mesh_ranks.lm_cases`` (the tiny LM variants of
``tests/test_smoke_archs.py``: gemma, yi, qwen3 with and without
``seq_shard_attn`` and with one kv head or 3 query heads, mixtral with
both routers, llama4 with Adafactor):
the same state and batches, two steps each way. Tolerances: the losses
and grad norms to 1e-4 relative, every gradient leaf (before each step,
``full_tensor``) to 1e-4 of the leaf's largest |g|, the state after two
steps to 2e-3 of each leaf's largest value (AdamW's first steps move a
parameter by about lr·sign(g), and a near-zero gradient's sign may differ
between the two sums); every DTensor leaf keeps its placements.

One case (``torch_mesh_ranks.REF_CASE``) starts from the reference's
draws: its mesh loss and gradient (two microbatches) are also held to
``jax.value_and_grad`` of the reference's ``lm_loss`` on the whole batch,
at the meshless tests' tolerance (1e-5; the model is dense, so the mean
of the microbatch means is the batch mean).

The helpers (spec -> placements, a tree placed and read back, the
replicated-compute wrapper) and a one-rank mesh step are checked in this
process.
"""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs.lm_common import lm_rules  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.module import (flatten_with_paths,  # noqa: E402
                                       tensor_tree, tree_to)
from repro_torch.models.transformer import lm_init  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
import torch_mesh_ranks as MR  # noqa: E402

CASES = list(MR.lm_cases())
# the reference (jax) where it is installed: the card machine, which has
# none, runs this file too (torch 2.11 there refuses more than here)
HAS_JAX = importlib.util.find_spec("jax") is not None


def _reference():
    """(jax, the reference's transformer, its tiny LM variants, the
    gradient comparison), imported only where jax is."""
    import jax
    from repro.models import transformer as JT
    from test_smoke_archs import LM_VARIANTS as J_VARIANTS
    from torch_grad_check import assert_grads
    jax.config.update("jax_platforms", "cpu")
    return jax, JT, J_VARIANTS, assert_grads


def _ref_params():
    jax, JT, J_VARIANTS, _ = _reference()
    return JT.lm_init(jax.random.PRNGKey(0), J_VARIANTS[MR.REF_CASE])


@pytest.fixture(scope="module")
def lm_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_lm")
    if HAS_JAX:
        cfg = MR.lm_cases()[MR.REF_CASE][0]
        tree = convert.lm_tree_from_reference(
            _reference()[0].device_get(_ref_params()), cfg, device="cpu")
        np.savez(tmp / f"{MR.REF_CASE}.params.npz",
                 **{p: t.numpy() for p, t in flatten_with_paths(tree)})
    R.spawn(MR.lm_ranks, 4, tmp, timeout=400.0)
    return {n: dict(np.load(tmp / f"{n}.npz")) for n in CASES}


@pytest.mark.skipif(not HAS_JAX, reason="the reference needs jax")
def test_mesh_loss_and_gradients_equal_the_reference(lm_results):
    """The 4-rank mesh's loss and gradient (``lm_grads`` on DTensors, two
    strided microbatches, before the first step) from the reference's
    draws against ``jax.value_and_grad`` of its ``lm_loss``."""
    jax, JT, J_VARIANTS, assert_grads = _reference()
    jnp = jax.numpy
    r = lm_results[MR.REF_CASE]
    cfg = MR.lm_cases()[MR.REF_CASE][0]
    b = MR.lm_batches(cfg)[0]
    jc = J_VARIANTS[MR.REF_CASE]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, t, lb: JT.lm_loss(p, jc, t, lb), has_aux=True))(
        _ref_params(), jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    got = M.map_with_paths(
        lambda p, _: torch.from_numpy(r[f"g0__{p}"]),
        tensor_tree(lm_init(cfg, seed=0, device="cpu")))
    np.testing.assert_allclose(float(r["ref_loss"]), float(jl), rtol=1e-5)
    assert_grads(convert.lm_params_to_reference(got, cfg),
                 jax.device_get(jg))


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_losses_equal_the_meshless_step(lm_results, name):
    r = lm_results[name]
    np.testing.assert_allclose(r["mesh_loss"], r["loss"], rtol=1e-4)
    np.testing.assert_allclose(r["mesh_grad_norm"], r["grad_norm"],
                               rtol=1e-4)


@pytest.mark.parametrize("name", CASES)
def test_mesh_gradients_equal_the_meshless_gradients(lm_results, name):
    assert max(lm_results[name]["grad_err"]) <= 1e-4


@pytest.mark.parametrize("name", CASES)
def test_mesh_state_after_two_steps(lm_results, name):
    r = lm_results[name]
    bad = [(p, e) for p, e in zip(r["state_err_paths"], r["state_err"])
           if e > 2e-3]
    assert not bad, bad


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_keeps_every_placement(lm_results, name):
    r = lm_results[name]
    assert bool(r["placements_kept"])
    assert int(r["n_dtensors"]) > 0


# ------------------------------------------------------------- in process --
class _Mesh:
    """The two attributes ``placements`` reads."""
    def __init__(self, names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec, want", [
    ((), ["R", "R", "R"]),
    ((None, "model"), ["R", "R", "S1"]),
    ((("pod", "data"), None), ["S0", "S0", "R"]),
    (("model", None, "data"), ["R", "S2", "S0"]),
    ((None, ("data", "model")), ["R", "S1", "S1"]),
    ((("data",), "absent"), ["R", "S0", "R"]),
])
def test_placements_of_a_spec(spec, want):
    from torch.distributed.tensor import Shard
    got = M.placements(spec, _Mesh(("pod", "data", "model")))
    assert [f"S{p.dim}" if isinstance(p, Shard) else "R"
            for p in got] == want


def test_placements_refuse_axes_out_of_the_mesh_order():
    with pytest.raises(ValueError, match="order"):
        M.placements((("model", "data"),), _Mesh(("data", "model")))


def test_on_whole_without_a_mesh_is_the_call():
    x = torch.arange(6.0)
    assert M.on_whole(lambda a, b: (a * b, "x"), x, 2.0)[1] == "x"
    assert torch.equal(M.on_whole(torch.neg, x), -x)
    assert M.pin_batch(x) is x
    assert M.unshard_dim(x, 0) is x
    assert M.replicated_like(x, x) is x


def test_on_rows_without_a_mesh_is_the_call():
    x = torch.arange(6.0).reshape(3, 2)
    assert M.on_rows(lambda a, b: (a * b, "x"), x, 2.0)[1] == "x"
    assert torch.equal(M.on_rows(torch.neg, x), -x)


def test_opt_state_specs_of_the_tiny_lm():
    cfg = MR.lm_cases()["yi-6b"][0]
    params = tensor_tree(lm_init(cfg, seed=0, device="cpu"))
    specs = lm_rules(cfg).specs(params)
    z = PS.opt_state_specs("adamw", params, specs, {"data": 2, "model": 2})
    assert z["step"] == ()
    assert z["m"]["embed"]["table"] == ("model", "data")
    assert z["m"]["layers"]["0"]["attn"]["q_proj"]["kernel"] == ("data",
                                                                 "model")
    assert z["master"] == z["m"] == z["v"]
    a = PS.opt_state_specs("adafactor", params, specs, {"data": 2})
    assert a["v"]["layers"]["0"]["attn"]["q_proj"]["kernel"] == {"v": (
        None, "model")}                     # 64 x 64: below 128, unfactored


def _one_rank(tmp_path, fn):
    with R.one_rank_group(tmp_path):
        from torch.distributed.device_mesh import init_device_mesh
        return fn(init_device_mesh("cpu", (1, 1),
                                   mesh_dim_names=("data", "model")))


def test_place_tree_keeps_storage_on_one_rank(tmp_path):
    cfg = MR.lm_cases()["gemma-7b"][0]
    params = tensor_tree(lm_init(cfg, seed=0, device="cpu"))

    def run(mesh):
        placed = M.place_tree(params, lm_rules(cfg).specs(params), mesh)
        return [(a, b) for (_, a), (_, b) in zip(flatten_with_paths(params),
                                                 flatten_with_paths(placed))]

    for a, b in _one_rank(tmp_path, run):
        assert b.to_local().data_ptr() == a.data_ptr()


def test_one_rank_mesh_step_equals_the_meshless_step(tmp_path):
    """The world-size-1 mesh (the chip's phase 18 (b) at the tests' size):
    two AdamW steps on DTensors = the meshless steps, bit for bit."""
    cfg, opt_kind, split = MR.lm_cases()["gemma-7b"]
    params = tensor_tree(lm_init(cfg, seed=0, device="cpu"))
    batches = MR.lm_batches(cfg)
    kw = dict(n_micro=MR.N_MICRO, micro_split=split, lr=1e-3)
    step, opt = PS.build_lm_train_step(cfg, opt_kind, **kw)
    state = {"params": tree_to(params, "cpu"), "opt": opt.init(params)}
    want = [step(state, b)[1] for b in batches]

    def run(mesh):
        mstep, _ = PS.build_lm_train_step(cfg, opt_kind, mesh=mesh, **kw)
        specs = lm_rules(cfg).specs(params)
        st = PS.place_train_state(
            {"params": tree_to(params, "cpu"), "opt": opt.init(params)},
            specs, PS.opt_state_specs(opt_kind, params, specs, mesh), mesh)
        got = [mstep(st, b)[1] for b in batches]
        return got, {p: t.to_local() for p, t in flatten_with_paths(st)
                     if hasattr(t, "to_local")}

    got, local = _one_rank(tmp_path, run)
    for w, g in zip(want, got):
        assert float(g["loss"]) == float(w["loss"])
        assert float(g["grad_norm"]) == float(w["grad_norm"])
    for p, t in flatten_with_paths(state):
        if p in local:
            assert torch.equal(local[p], t), p
