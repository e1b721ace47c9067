"""The port's distributed surfaces (core/distributed.py, launch/mesh.py,
launch/steps.build_irli_serve, the (data × rep) mesh fit, fit(mesh=) and
OnlineRefitLoop(mesh=)) on the CPU over gloo, against the JAX package.

The JAX side runs as tests/test_distributed.py runs it: in a subprocess
with 8 fake host devices, over a (4, 2) ("data", "model") mesh, writing its
results to an .npz. The port runs the same inputs on 8 gloo ranks spawned
with torch.multiprocessing (one rank a mesh position, each with its
shard), rendezvousing through a FileStore in tmp_path; the checks of one
world size share one spawn (module fixtures). Ids and n_candidates
exactly, scores to 1e-5 (|a - b| <= 1e-5 + 1e-5·|b|). The mesh fit (4
ranks, 2 × 2) is held to the port's single-device engine with
tests/test_fit_engine.py's tolerances (loss rtol 1e-4, assign match >
0.98, load_std rtol 0.05): the JAX package's own 4-device fit test fails
under jax 0.9.0, so the single-device engine is the reference there, with
the JAX package's initial scorer, batches and insertion orders injected.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as TR  # noqa: E402
from repro.core import network as JN  # noqa: E402
from repro.core import partition as JP  # noqa: E402
from repro.core.distributed import local_search as j_local  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    shard_search_local as j_shard_local)
from repro.core.search_api import SearchParams as JSP  # noqa: E402
from repro.fit.engine import FitEngine as JEngine  # noqa: E402
from repro.store.quantized import encode as j_encode  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core.index import IRLIIndex  # noqa: E402
from repro_torch.core.search_api import SearchParams  # noqa: E402
from repro_torch.fit.engine import FitEngine  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch.steps import build_irli_serve  # noqa: E402

P_SHARDS, P2 = 8, 4
L_LOC, D, B, R, H, BLOCK = 512, 16, 32, 4, 32, 8
Q, K = 16, 5
TOL = 1e-5

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core.distributed import (make_distributed_search,
                                        make_production_search)
    from repro.core.search_api import SearchParams
    from repro.launch.steps import build_irli_serve
    from repro.store.quantized import QuantizedStore

    z = np.load(sys.argv[1])
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    sc = lambda p: {k: jnp.asarray(z[p + k]) for k in ("w1", "b1", "w2",
                                                       "b2")}
    q = jnp.asarray(z["queries"])
    sp = SearchParams(m=4, tau=1, k=5, topC=1024)
    out = {}
    def put(name, r):
        out[name + "_ids"] = np.asarray(r.ids)
        out[name + "_scores"] = np.asarray(r.scores)
        out[name + "_ncand"] = np.asarray(r.n_candidates)
    put("prod_fp32", make_production_search(mesh, sp)(
        sc("s_"), jnp.asarray(z["members"]), jnp.asarray(z["base"]), q))
    store = QuantizedStore("int8", int(z["block"]), jnp.asarray(z["codes"]),
                           jnp.asarray(z["scales"]))
    put("prod_int8", make_production_search(
        mesh, sp.replace(store_dtype="int8"))(
        sc("s_"), jnp.asarray(z["members"]), store, q))
    put("dist", make_distributed_search(mesh, sp)(
        sc("d_"), jnp.asarray(z["members2"]), jnp.asarray(z["base2"]), q))
    o = build_irli_serve(mesh, m=4, tau=1, k=5, store_dtype="int8",
                         store_block=int(z["block"]))(
        {"scorer": sc("s_"), "members": jnp.asarray(z["members"]),
         "base_codes": jnp.asarray(z["codes"]),
         "base_scales": jnp.asarray(z["scales"])}, {"queries": q})
    out["serve_int8_ids"] = np.asarray(o["ids"])
    out["serve_int8_scores"] = np.asarray(o["scores"])
    np.savez(sys.argv[2], **out)
    print("devices", len(jax.devices()))
""")


def _scorer_np(seed):
    p = JN.scorer_init(jax.random.PRNGKey(seed), JN.ScorerConfig(
        d_in=D, d_hidden=H, n_buckets=B, n_reps=R))
    return {k: np.array(v) for k, v in p.items()}


def _members(seed):
    a = JP.hash_init(L_LOC, B, R, seed=seed)
    return np.array(JP.build_inverted_index(a, B,
                                            max_load=2 * L_LOC // B).members)


def _search_inputs(path: Path) -> None:
    rng = np.random.default_rng(0)
    z = {"queries": rng.normal(size=(Q, D)).astype(np.float32),
         "base": rng.normal(size=(P_SHARDS, L_LOC, D)).astype(np.float32),
         "members": np.stack([_members(s) for s in range(P_SHARDS)]),
         "base2": rng.normal(size=(P2, L_LOC, D)).astype(np.float32),
         "members2": np.stack([_members(20 + s) for s in range(P2)]),
         "block": np.int32(BLOCK)}
    for k, v in _scorer_np(0).items():
        z["s_" + k] = v
    ds = [_scorer_np(100 + s) for s in range(P2)]
    for k in ds[0]:
        z["d_" + k] = np.stack([d[k] for d in ds])
    st = j_encode(jnp.asarray(z["base"].reshape(-1, D)), "int8", BLOCK)
    z["codes"] = np.asarray(st.codes).reshape(P_SHARDS, L_LOC, D)
    z["scales"] = np.asarray(st.scales).reshape(P_SHARDS, L_LOC, -1)
    np.savez(path, **z)


def _fit_inputs(path: Path) -> None:
    """The JAX package's initial scorer and hash partition at the fit
    config, its batches for rounds 0 and 1 (FitEngine.round_batches) and
    its insertion orders (the round's split key folded with each rep)."""
    cfg = TR.fit_cfg()
    scfg = JN.ScorerConfig(d_in=cfg.d, d_hidden=cfg.d_hidden,
                           n_buckets=cfg.n_buckets, n_reps=cfg.n_reps)
    z = {"f_" + k: np.asarray(v) for k, v in JN.scorer_init(
        jax.random.PRNGKey(7), scfg).items()}
    z["f_assign"] = np.asarray(JP.hash_init(cfg.n_labels, cfg.n_buckets,
                                            cfg.n_reps, cfg.seed))
    jcfg = dataclasses.replace(cfg)
    jeng = JEngine(jcfg, scfg)
    key = jax.random.PRNGKey(cfg.seed)
    for rnd in range(2):
        idx, w = jeng.round_batches(cfg.n_labels, 0, rnd)
        z[f"b_idx{rnd}"], z[f"b_wt{rnd}"] = np.asarray(idx), np.asarray(w)
        key, kr = jax.random.split(key)
        z[f"b_orders{rnd}"] = np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(kr, r), cfg.n_labels))
            for r in range(cfg.n_reps)])
    np.savez(path, **z)


def _load(tmp, name, world):
    return [torch.load(Path(tmp) / f"{name}{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 8 search ranks and one of 4 fit ranks, beside the JAX
    subprocess; -> (inputs, JAX outputs, per-rank search outputs, per-rank
    fit outputs, fit inputs)."""
    tmp = tmp_path_factory.mktemp("dist")
    stmp, ftmp = tmp / "search", tmp / "fit"
    stmp.mkdir()
    ftmp.mkdir()
    _search_inputs(stmp / "inputs.npz")
    _fit_inputs(ftmp / "fit_inputs.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(stmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        TR.spawn(TR.search_ranks, P_SHARDS, stmp)
        TR.spawn(TR.fit_ranks, 4, ftmp)
        out, err = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    assert "devices 8" in out
    return (dict(np.load(stmp / "inputs.npz")), dict(np.load(tmp / "jax.npz")),
            _load(stmp, "search", P_SHARDS), _load(ftmp, "fit", 4),
            dict(np.load(ftmp / "fit_inputs.npz")))


def _near(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    return bool(np.all(np.abs(a[fin] - b[fin]) <= TOL + TOL * np.abs(b[fin])))


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def _same_on_every_rank(ranks, name):
    """Every rank's result ``name``, bit for bit the same -> rank 0's."""
    first = ranks[0][name]
    for r in ranks[1:]:
        assert _equal(first, r[name]), name
    return first


# ----------------------------------------------- parity with the JAX package
@pytest.mark.parametrize("name", ["prod_fp32", "prod_int8", "dist"])
def test_sharded_search_matches_jax(runs, name):
    """make_production_search at P = 8 over ("data", "model") (fp32 and
    int8 stores) and make_distributed_search over "data" = 4 with distinct
    scorers: every rank returns the same result, with the JAX package's
    ids and n_candidates exactly and its scores to 1e-5."""
    _, jx, ranks, _, _ = runs
    ids, scores, ncand, mode, epoch = _same_on_every_rank(ranks, name)
    np.testing.assert_array_equal(ids.numpy(), jx[name + "_ids"])
    assert _near(scores.numpy(), jx[name + "_scores"])
    np.testing.assert_array_equal(ncand.numpy(), jx[name + "_ncand"])
    assert ids.dtype == torch.int32 and ncand.dtype == torch.int32
    # the production path pins compact; "auto" resolves per shard (dense
    # at L_loc = 512, as the reference's _resolve)
    assert mode == ("dense" if name == "dist" else "compact")
    assert epoch == (3 if name == "prod_int8" else 0)
    assert (ids.numpy() >= 0).all() and ids.numpy().max() < P_SHARDS * L_LOC


def test_build_irli_serve_matches_jax(runs):
    """build_irli_serve at int8 over the 8 ranks: the JAX step's ids
    exactly, scores to 1e-5; the same as the production search's."""
    _, jx, ranks, _, _ = runs
    ids, scores = _same_on_every_rank(ranks, "serve_int8")
    np.testing.assert_array_equal(ids.numpy(), jx["serve_int8_ids"])
    assert _near(scores.numpy(), jx["serve_int8_scores"])
    assert torch.equal(ids, ranks[0]["prod_int8"][0])


def test_merge_moves_one_all_gather_and_one_all_reduce(runs):
    """Every collective of one production search on every rank: one
    all-gather of 2·Q·P·k·4 bytes (the packed fp32 scores and int32 ids)
    and one all-reduce of Q int32, nothing else."""
    _, _, ranks, _, _ = runs
    for r in ranks:
        assert r["collectives"] == [
            ("all_gather", 2 * Q * P_SHARDS * K * 4), ("all_reduce", Q * 4)]


def test_ties_across_shards_go_to_the_smaller_shard(runs):
    """Eight shards holding the same corpus and index return the same
    local top-k with the same scores: the merged top-5 is each query's
    best local id from shards 0 to 4, in shard order."""
    inp, _, ranks, _, _ = runs
    ids, scores = _same_on_every_rank(ranks, "tie")
    loc = TD.local_search(
        {k: torch.from_numpy(inp["s_" + k]) for k in ("w1", "b1", "w2",
                                                      "b2")},
        torch.from_numpy(inp["members"][0]), torch.from_numpy(inp["base"][0]),
        torch.from_numpy(inp["queries"]), SearchParams(m=4, tau=1, k=K,
                                                       mode="compact"))
    want = loc.ids[:, :1] + torch.arange(K, dtype=torch.int32) * L_LOC
    assert torch.equal(ids, want)
    assert torch.equal(scores, loc.scores[:, :1].expand(-1, K))


# ------------------------------------------------------ parity, no ranks --
def _local_case(seed=3):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(L_LOC, D)).astype(np.float32)
    q = rng.normal(size=(32, D)).astype(np.float32)
    delta = rng.integers(0, L_LOC, size=(R, B, 6)).astype(np.int32)
    delta[rng.random(delta.shape) < 0.4] = -1
    tomb = rng.random(L_LOC) < 0.1
    return _scorer_np(seed), _members(seed), base, q, delta, tomb


@pytest.mark.parametrize("surface,q_chunk,stream", [
    ("local", 0, False), ("local", 0, True), ("shard", 512, False),
    ("shard", 16, False), ("shard", 16, True)])
def test_local_surfaces_match_jax(surface, q_chunk, stream):
    """local_search and shard_search_local (one chunk and chunks of 16
    queries; with delta members and a tombstone) against the JAX functions
    in-process: ids and n_candidates exactly, scores to 1e-5, epoch
    echoed."""
    sc, mem, base, q, delta, tomb = _local_case()
    extra = dict(delta_members=delta, tombstone=tomb) if stream else {}
    jsp = JSP(m=4, tau=1, k=K, topC=256, mode="compact")
    sp = SearchParams(m=4, tau=1, k=K, topC=256, mode="compact")
    j_args = ({k: jnp.asarray(v) for k, v in sc.items()}, jnp.asarray(mem),
              jnp.asarray(base), jnp.asarray(q))
    t_args = ({k: torch.from_numpy(v) for k, v in sc.items()},
              torch.from_numpy(mem), torch.from_numpy(base),
              torch.from_numpy(q))
    j_extra = {k: jnp.asarray(v) for k, v in extra.items()}
    t_extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    if surface == "local":
        jr = j_local(*j_args, jsp, epoch=2, **j_extra)
        tr = TD.local_search(*t_args, sp, epoch=2, **t_extra)
    else:
        jr = j_shard_local(*j_args, jsp, q_chunk=q_chunk, epoch=2,
                           **j_extra)
        tr = TD.shard_search_local(*t_args, sp, q_chunk=q_chunk, epoch=2,
                                   **t_extra)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
    np.testing.assert_array_equal(tr.n_candidates.numpy(),
                                  np.asarray(jr.n_candidates))
    assert _near(tr.scores.numpy(), np.asarray(jr.scores))
    assert tr.epoch == jr.epoch == 2 and tr.mode == jr.mode == "compact"
    if stream:
        assert not np.isin(tr.ids.numpy(), np.flatnonzero(tomb)).any()


# ------------------------------------------------- world size 1, in-process
@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed after the module's
    tests."""
    with TR.one_rank_group(tmp_path_factory.mktemp("solo")):
        yield


@pytest.fixture(scope="module")
def solo_index():
    from repro_torch.data.synthetic import clustered_ann
    data = clustered_ann(n_base=600, n_queries=40, d=16, n_clusters=30,
                         seed=1)
    idx = IRLIIndex(TR.fit_cfg(), device="cpu")
    idx.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    return idx, torch.from_numpy(data.base), torch.from_numpy(data.queries)


@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_world_size_one_is_the_compact_search(solo, solo_index, store):
    """One rank: the production search and build_irli_serve are bit-equal
    to the compact search (the merge of one shard is a stable top-k of a
    sorted row)."""
    idx, base, q = solo_index
    sp = SearchParams(m=4, tau=1, k=10, topC=256, mode="compact",
                      store_dtype=store)
    payload = base
    if store == "int8":
        from repro_torch.store.quantized import encode
        payload = encode(base, "int8", 8)
    want = idx.search(q, payload, sp)
    mesh = TM.make_host_mesh(1, device_type="cpu")
    got = TD.make_production_search(mesh, sp)(
        idx.params, idx.index.members, payload, q)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.n_candidates, want.n_candidates)
    params = {"scorer": idx.params, "members": idx.index.members}
    if store == "int8":
        params.update(base_codes=payload.codes, base_scales=payload.scales)
    else:
        params["base"] = base
    out = build_irli_serve(mesh, 4, 1, 10, store_dtype=store,
                           store_block=8)(params, {"queries": q})
    sp_serve = SearchParams(m=4, tau=1, k=10, store_dtype=store,
                            mode="compact")
    want = idx.search(q, payload, sp_serve)
    assert torch.equal(out["ids"], want.ids)
    assert torch.equal(out["scores"], want.scores)


def test_legacy_shims_and_refusals(solo, solo_index):
    """The legacy kwargs return the old (ids, scores) tuples with the typed
    path's values (and warn); params mixed with kwargs raise TypeError;
    "dense" raises on the production path; an unknown axis raises."""
    idx, base, q = solo_index
    mesh = TM.make_host_mesh(1, device_type="cpu")
    sp = SearchParams(m=4, tau=1, k=5, topC=1024, mode="compact")
    args = (idx.params, idx.index.members, base, q)
    typed = TD.make_production_search(mesh, sp)(*args)
    with pytest.warns(DeprecationWarning):
        fn = TD.make_production_search(mesh, m=4, tau=1, k=5)
    ids, scores = fn(*args)
    assert torch.equal(ids, typed.ids) and torch.equal(scores, typed.scores)
    with pytest.warns(DeprecationWarning):
        fn = TD.make_distributed_search(mesh, m=4, tau=1, k=5,
                                        mode="compact")
    ids, scores = fn(*args)
    assert torch.equal(ids, typed.ids)
    with pytest.warns(DeprecationWarning):
        ids, scores = TD.shard_search_local(*args, m=4, tau=1, k=5)
    loc = TD.shard_search_local(*args, sp)
    assert torch.equal(ids, loc.ids) and torch.equal(scores, loc.scores)
    with pytest.warns(DeprecationWarning):
        ids, _ = TD.local_search(*args, m=4, tau=1, k=5, mode="compact")
    assert torch.equal(ids, loc.ids)
    for call in (lambda: TD.make_production_search(mesh, sp, m=4),
                 lambda: TD.make_distributed_search(mesh, sp, k=3),
                 lambda: TD.shard_search_local(*args, sp, tau=2),
                 lambda: TD.local_search(*args, sp, metric="l2")):
        with pytest.raises(TypeError, match="not both"):
            call()
    with pytest.raises(ValueError, match="compact-only"):
        TD.make_production_search(mesh, sp.replace(mode="dense"))(*args)
    with pytest.raises(ValueError, match="compact-only"):
        TD.shard_search_local(*args, sp.replace(mode="dense"))
    with pytest.raises(ValueError, match="not axes"):
        TD.make_distributed_search(mesh, sp, corpus_axes=("pod",))
    assert TD.shard_corpus(base, 3).shape == (3, 200, 16)


def test_meshes_check_their_size(solo):
    """A mesh's size must be the world size; the axis helpers read it."""
    mesh = TM.make_fit_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "rep")
    assert TM.batch_axes(mesh) == ("data",)
    assert TM.batch_size_divisor(mesh) == 1
    host = TM.make_host_mesh(device_type="cpu")
    assert host.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TM.make_host_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        TM.make_production_mesh(device_type="cpu")
    from repro_torch.configs import irli_deep1b as C
    from repro.configs import irli_deep1b as JC
    for name in ("D", "B_BUCKETS", "R", "HIDDEN", "N_CORPUS", "MAX_LOAD",
                 "STORE_DTYPE", "STORE_BLOCK", "K_NEIGH", "FIT_K",
                 "FIT_BATCH", "FIT_AFFINITY_CHUNK"):
        assert getattr(C, name) == getattr(JC, name), name
    assert C.fit_affinity_bytes() == JC.fit_affinity_bytes()
    assert C.serve_store_bytes(256) == JC.serve_store_bytes(256)
    for reduced in (False, True):
        mine, ref = C.fit_config(reduced=reduced), JC.fit_config(
            reduced=reduced)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


# ---------------------------------------------------------- the mesh fit --
@pytest.fixture(scope="module")
def single_fit():
    """The port's single-device fit at the mesh tests' config and data."""
    data = TR.fit_data()
    idx = IRLIIndex(TR.fit_cfg(), device="cpu")
    st = idx.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    return idx, st


def _assign_match(a, b) -> float:
    return float((a == b).float().mean())


def test_fit_on_a_2x2_mesh_matches_the_single_device_fit(runs, single_fit):
    """IRLIIndex.fit(mesh=) on 4 gloo ranks ((data, rep) = (2, 2)): every
    rank ends with the whole index; round and epoch losses within rtol
    1e-4 of the single-device fit's, assign equal in > 98% of slots,
    load_std within rtol 0.05."""
    _, _, _, ranks, _ = runs
    idx, st = single_fit
    (loss, epoch_loss, n_re, lstd, assign, params, step,
     members) = _same_on_every_rank(ranks, "fit")
    np.testing.assert_allclose(loss, st.train_loss, rtol=1e-4)
    np.testing.assert_allclose(np.concatenate(epoch_loss),
                               np.concatenate(st.epoch_loss), rtol=1e-4)
    np.testing.assert_allclose(lstd, st.load_std, rtol=0.05)
    assert len(n_re) == len(st.n_reassigned)
    assert assign.shape == idx.assign.shape
    assert _assign_match(assign, idx.assign) > 0.98
    assert step == int(idx.opt_state["step"])
    for k, v in params.items():
        assert v.shape == idx.params[k].shape
        np.testing.assert_allclose(v.numpy(), idx.params[k].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    assert torch.equal(members, TP.build_inverted_index(
        assign, idx.cfg.n_buckets, members.shape[-1]).members)


def test_mesh_rounds_with_the_jax_draws_match_the_engine(runs):
    """Two engine rounds on the 2 × 2 mesh with the JAX package's initial
    scorer, batches and insertion orders injected, against the port's
    single-device engine on the same: losses rtol 1e-4, assign match >
    0.98, load_std rtol 0.05, load_min/max and n_reassigned close."""
    _, _, _, ranks, z = runs
    assign, mets, params = _same_on_every_rank(ranks, "rounds")
    state, want = TR.injected_rounds(z)
    for got, ref in zip(mets, want):
        for key in ("loss", "epoch_loss", "step_loss", "grad_norm"):
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(float(got["load_std"]),
                                   float(ref["load_std"]), rtol=0.05)
        assert abs(int(got["n_reassigned"]) - int(ref["n_reassigned"])) \
            <= 0.02 * assign.numel()
    assert _assign_match(assign, state.assign) > 0.98
    for k in params:
        np.testing.assert_allclose(params[k].numpy(),
                                   state.params[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    ld = TP.loads(assign, TR.fit_cfg().n_buckets).float()
    assert float(mets[-1]["load_min"]) == float(ld.min())
    assert float(mets[-1]["load_max"]) == float(ld.max())


def test_refit_on_a_2x2_mesh_matches_the_single_device_loop(runs):
    """OnlineRefitLoop(mesh=) over the 2 × 2 mesh runs one cycle on every
    rank; its artifact matches the single-device loop's: the round's loss
    within rtol 1e-4, assign equal in > 98% of slots, load_std within rtol
    0.05, the params close."""
    _, _, _, ranks, _ = runs
    params, assign, loss, version = _same_on_every_rank(ranks, "refit")
    wparams, wassign, wloss, wversion = TR.refit_cycle()
    assert version == wversion == 1
    np.testing.assert_allclose(loss, wloss, rtol=1e-4)
    assert _assign_match(assign, wassign) > 0.98
    B = TR.fit_cfg().n_buckets
    live = wassign < B
    np.testing.assert_allclose(
        float(TP.load_std(torch.where(live, assign, 0), B)),
        float(TP.load_std(torch.where(live, wassign, 0), B)), rtol=0.05)
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), wparams[k].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_mesh_fit_replaces_assign_and_rng_at_the_end_only(solo):
    """fit(mesh=) on a 1 x 1 mesh: the rounds overwrite the sharded state
    in place, so the index's assign and generator state stay as they were
    at entry until the fit ends (what ``log`` sees each round)."""
    data = TR.fit_data()
    idx = IRLIIndex(TR.fit_cfg(), device="cpu")
    assign0, rng0 = idx.assign.clone(), idx.rng.clone()
    seen = []

    class Log:
        def log(self, row, step):
            seen.append((torch.equal(idx.assign, assign0),
                         torch.equal(idx.rng, rng0)))

    idx.fit(data.train_queries, data.train_gt, label_vecs=data.base,
            mesh=TM.make_fit_mesh(1, device_type="cpu"), log=Log())
    assert seen and all(a and r for a, r in seen), seen
    assert not torch.equal(idx.assign, assign0)


def test_one_by_one_mesh_is_bit_equal(solo):
    """A 1 × 1 mesh: fit(mesh=), the engine rounds and the refit cycle are
    bit-equal to the single-device ones (assign, losses, params)."""
    data = TR.fit_data()
    mesh = TM.make_fit_mesh(1, device_type="cpu")
    one = IRLIIndex(TR.fit_cfg(), device="cpu")
    s1 = one.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    two = IRLIIndex(TR.fit_cfg(), device="cpu")
    s2 = two.fit(data.train_queries, data.train_gt, label_vecs=data.base,
                 mesh=mesh)
    assert s1.train_loss == s2.train_loss and s1.epoch_loss == s2.epoch_loss
    assert s1.n_reassigned == s2.n_reassigned
    assert torch.equal(one.assign, two.assign)
    for k in one.params:
        assert torch.equal(one.params[k], two.params[k]), k
        assert torch.equal(one.opt_state["m"][k], two.opt_state["m"][k]), k
    # the Trainer's form: one mesh round over dict states
    from repro_torch.fit.engine import FitData, FitEngine
    from repro_torch.fit.state import FitState
    eng = FitEngine(one.cfg, one.scorer_cfg)
    fd = FitData.build(data.train_queries, data.train_gt,
                       label_vecs=data.base, chunk=one.cfg.affinity_chunk)
    states = [FitState.create({k: v.clone() for k, v in two.params.items()},
                              eng.opt.init(two.params), two.assign.clone(),
                              3) for _ in range(2)]
    idx_b, w_b = eng.round_batches(data.base.shape[0], 0, 0)
    s_a, m_a = eng.make_fit_round(fd)(states[0], idx_b, w_b)
    d_b, m_b = eng.sharded_step_fn(mesh, fd, states[1])(
        states[1].as_dict(), {"idx": idx_b, "w": w_b})
    assert torch.equal(s_a.assign, d_b["assign"])
    assert float(m_a["loss"]) == float(m_b["loss"])
    p1, a1, l1, _ = TR.refit_cycle()
    p2, a2, l2, _ = TR.refit_cycle(mesh)
    assert torch.equal(a1, a2) and l1 == l2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        one.fit(data.train_queries, data.train_gt, label_vecs=data.base,
                mesh=object())
    with pytest.raises(ValueError, match="needs axes"):
        one.fit(data.train_queries, data.train_gt, label_vecs=data.base,
                mesh=TM.make_host_mesh(1, device_type="cpu"))



def test_a_fit_without_a_mesh_updates_the_index_each_round():
    """On one device the index's assign is the round's own when ``log``
    sees the round (the fit cell's round-1 replay reads it there)."""
    data = TR.fit_data()
    idx = IRLIIndex(TR.fit_cfg(), device="cpu")
    start = idx.assign.clone()
    seen = []

    class Log:
        def log(self, row, step):
            seen.append(idx.assign.clone())

    idx.fit(data.train_queries, data.train_gt, label_vecs=data.base,
            log=Log())
    assert len(seen) == 2 and not torch.equal(seen[0], start)
    assert torch.equal(seen[-1], idx.assign)


# ------------------------------------------------- the Trainer on a mesh ----
@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """One spawn of 4 ranks: elastic restore, and the mesh Trainer
    (tests/torch_dist_ranks.train_ranks)."""
    tmp = tmp_path_factory.mktemp("train")
    TR.spawn(TR.train_ranks, 4, tmp)
    return _load(tmp, "train", 4)


def test_elastic_restore_splits_rows_on_a_2x2_mesh(train_runs):
    """A whole checkpoint restored onto (data 2 × model 2): w1's 4 rows
    split over "model" (rank at model index j keeps rows 2j, 2j+1), b1's 3
    rows do not divide by 2 and stay whole, emb's 8 rows split over the
    whole grid (block 2·data + model), a leaf without a rule whole."""
    want = TR.elastic_tree()
    for tree, step, at in (r["elastic"] for r in train_runs):
        assert step == 5
        j, blk = at["model"], 2 * at["data"] + at["model"]
        p = tree["params"]
        np.testing.assert_array_equal(p["w1"].numpy(),
                                      want["params"]["w1"][2 * j:2 * j + 2])
        np.testing.assert_array_equal(p["b1"].numpy(), want["params"]["b1"])
        np.testing.assert_array_equal(p["emb"].numpy(),
                                      want["params"]["emb"][2 * blk:
                                                            2 * blk + 2])
        assert int(tree["step"]) == 7
    coords = sorted((r["elastic"][2]["data"], r["elastic"][2]["model"])
                    for r in train_runs)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_mesh_trainer_resumes_on_another_mesh_shape(train_runs):
    """The Trainer over build_irli_fit_parts(mesh=): a 2 × 2 run writes
    whole-state checkpoints (R = 4 rows, each rank holding 2); one crashed
    at round 2 resumes from round 1's checkpoint on a 1 × 4 mesh (one rep a
    rank) and ends where the uninterrupted 2 × 2 run does, to the mesh
    fit's tolerances: round 2's loss rtol 1e-4, assign equal in > 98% of
    slots, params rtol 1e-3."""
    losses, assign, params, local = _same_on_every_rank(train_runs, "full")
    (rlosses, rassign, rparams, rlocal, resumed, start, saved,
     step) = _same_on_every_rank(train_runs, "resumed")
    R, L = TR.fit_cfg().n_reps, TR.fit_cfg().n_labels
    assert local == (2, L) and rlocal == (1, L) and saved == (R, L)
    assert resumed and start == 2 and len(rlosses) == 1 and len(losses) == 3
    assert assign.shape == rassign.shape == (R, L)
    np.testing.assert_allclose(rlosses[0], losses[2], rtol=1e-4)
    assert _assign_match(rassign, assign) > 0.98
    for k in params:
        np.testing.assert_allclose(rparams[k].numpy(), params[k].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    S = FitEngine(TR.fit_cfg(), None).batch_plan(L)[0]
    assert step == 3 * S
