"""The port's architecture registry against the reference's, on the CPU.

For every arch of ``repro.configs.registry``: the same cells (names,
kinds, skip reasons), optimizer, family and model FLOPs a token; the
abstract params leaf by leaf (shape and dtype: the reference's
``jax.eval_shape`` against the port's ``FakeTensorMode``, so llama4's
400B allocates nothing); and on both production meshes, single (16, 16)
and multi-pod (2, 16, 16), each cell's inputs, input specs, params and
param specs, the arch's parameter specs and its optimizer-state specs.

The port's meshes are ``DeviceMesh``es over torch's ``fake`` process
group (512 fake ranks); the reference's are a stand-in with
``axis_names`` and ``devices.shape``, all its spec functions read.

The reference stacks an LM's layers (``layers/sub{i}/...`` with a
leading group axis) where the port keeps one entry a layer
(``layers/{g·period + i}/...``): a port layer leaf is compared with its
reference leaf without the leading axis (shape) or its leading entry
(spec). An optimizer-state spec of a stacked leaf whose ZeRO axis the
reference put on the group axis (yi-6b, mixtral-8x7b: 32 groups) has no
unstacked counterpart; there the port's is the reference's
``zero_state_spec`` of the port's own shape.

Also here: ``compress_grads`` against the reference with JAX's uniform
noise injected, ``compressed_psum`` over 2 gloo ranks against the
reference's formula in numpy, ``Prefetcher`` and ``ShardedLoader``.
"""
import functools
import importlib
import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JR  # noqa: E402
from repro.configs.base import zero_state_spec as j_zero  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.module import flatten_with_paths as j_flat  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.configs.base import zero_state_spec as p_zero  # noqa: E402
from repro_torch.data.loader import Prefetcher  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.models.module import \
    flatten_with_paths as p_flat  # noqa: E402
from repro_torch.models.module import placements  # noqa: E402
from repro_torch.optim import compression as PC  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
import torch_mesh_ranks as MR  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ARCHS = list(JR.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class JMesh:
    """The reference's mesh as its spec functions read it."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


@pytest.fixture(scope="module")
def meshes():
    """{name: (the port's DeviceMesh, the reference's stand-in)} over a
    512-rank fake process group, destroyed after the module."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {k: (DeviceMesh("cpu", torch.arange(int(np.prod(shape)))
                              .reshape(shape), mesh_dim_names=names),
                   JMesh(shape, names))
               for k, (shape, names) in MESHES.items()}
    finally:
        dist.destroy_process_group()


@functools.cache
def _abstract(name):
    return (JR.get_arch(name).abstract_params(),
            PR.get_arch(name).abstract_params())


def _period(name) -> int:
    cfg = getattr(importlib.import_module(PR.ARCHS[name]), "CONFIG", None)
    return cfg.period if PR.get_arch(name).family == "lm" else 0


def _ref_path(path: str, period: int) -> tuple[str, int]:
    """A port LM path -> (the reference's path, the group index); other
    paths map to themselves (group -1)."""
    parts = path.split("/")
    if period and parts[0] == "layers":
        j = int(parts[1])
        return "/".join(["layers", f"sub{j % period}"] + parts[2:]), \
            j // period
    return path, -1


def _norm(spec):
    """A PartitionSpec or spec tuple -> a tuple of entries, a one-axis
    tuple entry as its name."""
    if spec is None:
        return None
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def _leaves(tree, prefix=""):
    """[(path, leaf)] of nested dicts and lists; anything else (a tensor,
    a PartitionSpec, a spec tuple) is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in
                _leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _sd(x) -> tuple:
    """(shape, dtype name) of a jax ShapeDtypeStruct or a torch tensor."""
    dt = str(x.dtype).removeprefix("torch.")
    return tuple(int(s) for s in x.shape), dt


def _pairs(name, jtree, ptree):
    """(path, reference leaf, port leaf, group index) for every port leaf,
    after checking the leaf sets correspond."""
    period = _period(name)
    jl = dict(_leaves(jtree))
    pl = _leaves(ptree)
    seen = set()
    out = []
    for path, leaf in pl:
        jp, g = _ref_path(path, period)
        assert jp in jl, (name, path)
        seen.add(jp)
        out.append((path, jl[jp], leaf, g))
    assert seen == set(jl), (name, sorted(set(jl) - seen)[:5])
    return out


# --------------------------------------------------------------- registry --
def test_registry_lists_the_reference_cells():
    got = PR.all_cells()
    assert got == JR.all_cells()
    assert len(got) == 42
    assert PR.all_cells(include_irli=False) == JR.all_cells(
        include_irli=False)
    assert list(PR.ARCHS) == list(JR.ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        PR.get_arch("no-such-arch")
    assert PR.get_arch("dien") is PR.get_arch("dien")


@pytest.mark.parametrize("name", ARCHS)
def test_arch_fields_equal_the_reference(name):
    j, p = JR.get_arch(name), PR.get_arch(name)
    for f in ("name", "family", "opt", "opt_kw", "model_flops_per_token"):
        assert getattr(p, f) == getattr(j, f), f
    assert list(p.cells) == list(j.cells)
    for cell in j.cells:
        jc, pc = j.cells[cell], p.cells[cell]
        assert (pc.kind, pc.skip, pc.step_with_mesh) == (
            jc.kind, jc.skip, jc.step_with_mesh), cell
        for f in ("inputs", "in_specs", "step", "params", "param_specs"):
            assert (getattr(pc, f) is None) == (getattr(jc, f) is None), \
                (cell, f)


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params_leaf_by_leaf(name):
    jp, pp = _abstract(name)
    assert all(t.device.type != "cuda" for _, t in p_flat(pp))
    for path, j, p, g in _pairs(name, jp, pp):
        js, jd = _sd(j)
        if g >= 0:
            js = js[1:]
        assert _sd(p) == (js, jd), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_equal_the_reference(meshes, name, mesh_name):
    jp, pp = _abstract(name)
    jspecs = JR.get_arch(name).rules().specs(jp)
    pspecs = PR.get_arch(name).rules().specs(pp)
    pm = meshes[mesh_name][0]
    for path, j, p, g in _pairs(name, jspecs, pspecs):
        j = _norm(j)
        assert _norm(p) == (j[1:] if g >= 0 and j else j), path
        assert len(placements(p, pm)) == pm.ndim    # placeable on the mesh


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_cells_inputs_and_specs_equal_the_reference(meshes, name,
                                                    mesh_name):
    pm, jm = meshes[mesh_name]
    j, p = JR.get_arch(name), PR.get_arch(name)
    n = 0
    for cell, jc in j.cells.items():
        pc = p.cells[cell]
        if jc.skip:
            continue
        ji, pi = jc.inputs(jm), pc.inputs(pm)
        assert [(k, _sd(v)) for k, v in _leaves(pi)] == [
            (k, _sd(v)) for k, v in _leaves(ji)], cell
        assert all(v.device.type == "meta" for _, v in _leaves(pi))
        assert [(k, _norm(v)) for k, v in _leaves(pc.in_specs(pm))] == [
            (k, _norm(v)) for k, v in _leaves(jc.in_specs(jm))], cell
        if jc.params is not None:
            jpar, ppar = jc.params(jm), pc.params(pm)
            assert [(k, _sd(v)) for k, v in _leaves(ppar)] == [
                (k, _sd(v)) for k, v in _leaves(jpar)], cell
            if jc.param_specs is not None:
                assert [(k, _norm(v)) for k, v in
                        _leaves(pc.param_specs(pm, ppar))] == [
                    (k, _norm(v)) for k, v in
                    _leaves(jc.param_specs(jm, jpar))], cell
        n += 1
    assert n == sum(1 for c in j.cells.values() if not c.skip)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_opt_state_specs_equal_the_reference(meshes, name, mesh_name):
    pm, jm = meshes[mesh_name]
    j, p = JR.get_arch(name), PR.get_arch(name)
    jp, pp = _abstract(name)
    jo = JS.opt_state_specs(j.opt, jp, j.rules().specs(jp), jm)
    po = PS.opt_state_specs(p.opt, pp, p.rules().specs(pp), pm)
    assert sorted(po) == sorted(jo)
    assert po["step"] == () and _norm(jo["step"]) == ()
    dsize = dict(zip(jm.axis_names, jm.devices.shape)).get("data", 1)
    pspecs = p.rules().specs(pp)
    shapes = dict(p_flat(pp))
    for key in (k for k in jo if k != "step"):
        for path, js, ps, g in _pairs(name, jo[key], po[key]):
            js = _norm(js)
            if g < 0:
                assert _norm(ps) == js, (key, path)
            elif js[0] is None:
                assert _norm(ps) == js[1:], (key, path)
            else:                      # ZeRO on the reference's group axis
                assert ps == p_zero(dict(p_flat(pspecs))[path],
                                    tuple(shapes[path].shape), "data",
                                    dsize), (key, path)


@pytest.mark.parametrize("spec, shape, size", [
    ((), (64, 32), 16), ((None, "model"), (32, 48), 16),
    (("model", None), (48, 8), 16), ((("data", "model"), None), (64, 4), 4),
    (("data",), (8, 8), 2), ((None,), (7,), 2), ((), (), 2),
])
def test_zero_state_spec_equals_the_reference(spec, shape, size):
    from jax.sharding import PartitionSpec as P
    assert p_zero(spec, shape, "data", size) == _norm(
        j_zero(P(*spec), shape, "data", size))


# ------------------------------------------------------------ compression --
def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"a": {"kernel": rng.standard_normal((6, 5)).astype(np.float32),
                  "bias": rng.standard_normal((5,)).astype(np.float32)},
            "b": rng.standard_normal((13,)).astype(np.float32) * 3.0}
    tree["c"] = np.round(rng.standard_normal((4, 4)), 1).astype(np.float32)
    return tree                    # "c": many equal |values|, top-k ties


def _jax_noise(key, tree):
    flat, _ = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(flat))
    return [np.asarray(jax.random.uniform(k, g.shape, jnp.float32, -0.5,
                                          0.5)) for k, g in zip(keys, flat)]


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_compression_equals_the_reference(seed):
    g, e = _grad_tree(seed), _grad_tree(seed + 10)
    e = jax.tree.map(lambda x: x * 0.01, e)
    key = jax.random.PRNGKey(seed)
    cfg = JC.CompressionConfig(kind="int8")
    jpay, jdec, jef = JC.compress_grads(cfg, g, e, key)
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    ppay, pdec, pef = PC.compress_grads(
        PC.CompressionConfig(kind="int8"), to_t(g), to_t(e),
        [torch.from_numpy(u.copy()) for u in _jax_noise(key, g)])
    for (jq, js), (pq, ps) in zip(jpay, ppay):
        assert pq.dtype == torch.int8
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ps), float(js), rtol=1e-6)
    for (path, a), (_, b) in zip(j_flat(jef), p_flat(pef)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6, err_msg=path)
    jd, pd = jdec(jpay), pdec(ppay)
    for (path, a), (_, b) in zip(j_flat(jd), p_flat(pd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7, err_msg=path)


@pytest.mark.parametrize("frac", [0.01, 0.3])
def test_topk_compression_equals_the_reference(frac):
    g, e = _grad_tree(3), jax.tree.map(np.zeros_like, _grad_tree(4))
    jpay, _, jef = JC.compress_grads(
        JC.CompressionConfig(kind="topk", topk_frac=frac), g, e,
        jax.random.PRNGKey(0))
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    ppay, _, pef = PC.compress_grads(
        PC.CompressionConfig(kind="topk", topk_frac=frac), to_t(g),
        to_t(e))
    for a, b in zip(jpay, ppay):       # the kept ids and values, exactly
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for (path, a), (_, b) in zip(j_flat(jef), p_flat(pef)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=path)


def test_int8_noise_from_a_generator_and_the_ef_identity():
    g = jax.tree.map(torch.from_numpy, _grad_tree(5))
    e = PC.ef_init(g)
    cfg = PC.CompressionConfig(kind="int8")
    pay1, dec, ef1 = PC.compress_grads(cfg, g, e,
                                       torch.Generator().manual_seed(0))
    pay2, _, _ = PC.compress_grads(cfg, g, e,
                                   torch.Generator().manual_seed(0))
    for (q1, _), (q2, _) in zip(pay1, pay2):
        assert torch.equal(q1, q2)
    deq = dec(pay1)
    for (path, gg), (_, d), (_, e1) in zip(p_flat(g), p_flat(deq),
                                           p_flat(ef1)):
        torch.testing.assert_close(gg, d + e1, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="noise"):
        PC.compress_grads(cfg, g, e)
    assert PC.compress_grads(PC.CompressionConfig(), g, e)[0] is g


# -------------------------------------------------------- two gloo ranks --
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    inputs = {}
    for r in range(2):
        g = _grad_tree(20 + r)
        for (path, v), u in zip(j_flat(g), _jax_noise(
                jax.random.PRNGKey(r), g)):
            inputs[f"g{r}__{path.replace('/', '.')}"] = v
            inputs[f"u{r}__{path.replace('/', '.')}"] = u
    np.savez(tmp / "psum_in.npz", **inputs)
    R.spawn(MR.two_rank_checks, 2, tmp, timeout=120.0)
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _psum_expected(inputs, kind, name):
    """The reference's compressed_psum of leaf ``name`` over 2 ranks, in
    numpy: int8 sums the int32 codes and scales by the mean scale."""
    gs = [inputs[f"g{r}__{name}"] for r in range(2)]
    us = [inputs[f"u{r}__{name}"] for r in range(2)]
    if kind == "none":
        return gs[0] + gs[1]
    if kind == "int8":
        scales = [np.float32(np.max(np.abs(g)) / np.float32(127.0)
                             + np.float32(1e-12)) for g in gs]
        qs = [np.clip(np.round(g / s + u), -127, 127).astype(np.int8)
              for g, s, u in zip(gs, scales, us)]
        total = qs[0].astype(np.int32) + qs[1].astype(np.int32)
        return total.astype(np.float32) * ((scales[0] + scales[1])
                                           / np.float32(2.0))
    out = 0
    for g in gs:
        flat = g.reshape(-1)
        k = max(1, int(0.25 * flat.size))
        keep = np.zeros_like(flat)
        order = np.lexsort((np.arange(flat.size), -np.abs(flat)))[:k]
        keep[order] = flat[order]
        out = out + keep.reshape(g.shape)
    return out


@pytest.mark.parametrize("kind", ["none", "int8", "topk"])
def test_compressed_psum_equals_the_reference_formula(two_ranks, kind):
    inputs, outs = two_ranks
    names = sorted({k.split("__")[1] for k in inputs if k.startswith("g")})
    for name in names:
        want = _psum_expected(inputs, kind, name)
        for out in outs:
            np.testing.assert_allclose(out[f"{kind}__{name}"], want,
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_sharded_loader_gives_each_rank_its_block(two_ranks):
    _, outs = two_ranks
    full = np.arange(12, dtype=np.int32).reshape(4, 3)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["tokens_local"],
                                      full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["tokens_full"], full)
        assert str(out["tokens_placements"]) == "(Shard(dim=0),)"
        np.testing.assert_array_equal(out["mask_local"], np.ones(4))
        assert str(out["note"]) == "kept"
        assert bool(out["second_equal"])


def test_on_rows_gives_each_data_rank_its_rows(two_ranks):
    """``models.module.on_rows`` on a replicated [5, 3] DTensor: rank 0
    computes on rows 0-2 and rank 1 on rows 3-4; the outputs come back
    split over "data" and whole under ``full_tensor``, and the gradient
    reaches the input."""
    _, outs = two_ranks
    x = np.arange(15.0, dtype=np.float32).reshape(5, 3)
    for r, out in enumerate(outs):
        assert tuple(out["on_rows_seen"]) == ((3, 3), (2, 3))[r]
        np.testing.assert_array_equal(out["on_rows_y"], 2 * x)
        np.testing.assert_array_equal(out["on_rows_s"], x.sum(1))
        assert str(out["on_rows_placements"]) == \
            "((Shard(dim=0),), (Shard(dim=0),))"
        np.testing.assert_array_equal(out["on_rows_grad"],
                                      np.full((5, 3), 3.0))


# -------------------------------------------------------------- prefetch --
def test_prefetcher_keeps_the_order():
    assert list(itertools.islice(Prefetcher(iter(range(10)), 3), 10)) == \
        list(range(10))


def test_prefetcher_ends_with_its_source():
    p = Prefetcher(iter(range(5)), 2)
    assert list(p) == list(range(5))
    with pytest.raises(StopIteration):
        next(p)


def test_prefetcher_queue_is_bounded_by_its_depth():
    p = Prefetcher(itertools.count(), depth=2)
    time.sleep(0.2)
    assert p.depth == 2 and p.thread.is_alive()
    assert next(p) == 0
    p.close()


def test_prefetcher_surfaces_the_loader_exception():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("loader crashed")

    p = Prefetcher(gen(), depth=4)
    assert [next(p), next(p)] == [1, 2]
    with pytest.raises(RuntimeError, match="loader crashed"):
        next(p)


def test_prefetcher_close_stops_the_producer():
    p = Prefetcher(itertools.count(), depth=1)
    assert next(p) == 0
    p.close()
    end = time.monotonic() + 5.0
    while p.thread.is_alive() and time.monotonic() < end:
        try:
            p.q.get(timeout=0.05)
        except Exception:
            pass
    assert not p.thread.is_alive()
