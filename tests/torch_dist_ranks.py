"""Rank programs for tests/test_torch_distributed.py: several processes on
the CPU over gloo, each running the port's distributed surfaces on its
block. This module imports torch, numpy and the port only (no jax), so a
spawned rank starts quickly.

``spawn(fn, world, tmp)`` starts ``world`` processes with the ``spawn``
start method, each running ``fn(rank, world, tmp)`` after
``init_process_group("gloo")`` through a FileStore in ``tmp`` (no port to
clash under xdist), with a collective timeout, and joins them within a
time limit: a hung collective fails the test instead of hanging the suite.
A rank's exception is written to ``tmp/err<rank>.txt`` and raised here.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np


def _entry(fn, rank: int, world: int, tmp: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60))
        fn(rank, world, tmp)
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn(fn, world: int, tmp, timeout: float = 240.0) -> None:
    """Run ``fn(rank, world, tmp)`` on ``world`` gloo ranks; raise on any
    rank's failure or when they do not finish within ``timeout`` s."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [(Path(tmp) / f"err{r}.txt") for r in range(world)]
    text = "\n".join(e.read_text() for e in errs if e.exists())
    if text or hung or any(p.exitcode for p in procs):
        raise AssertionError(f"ranks {hung} hung past {timeout} s; exit "
                             f"codes {[p.exitcode for p in procs]}\n{text}")


@contextlib.contextmanager
def one_rank_group(tmp):
    """A one-rank gloo group in this process (FileStore rendezvous in
    ``tmp``), destroyed on exit."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "solo_store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _t(a, dtype=None):
    import torch
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _scorer(z, prefix: str, idx=None) -> dict:
    return {k: _t(z[prefix + k] if idx is None else z[prefix + k][idx])
            for k in ("w1", "b1", "w2", "b2")}


def _save(tmp, name: str, rank: int, out: dict) -> None:
    import torch
    torch.save(out, Path(tmp) / f"{name}{rank}.pt")


# ------------------------------------------------------------ the search --
def search_ranks(rank: int, world: int, tmp: str) -> None:
    """P = 8 ranks over a (4, 2) ("data", "model") mesh: the production
    search (fp32, int8), the distributed search over "data" with distinct
    scorers, build_irli_serve (int8), the collectives of one production
    search (the package's collective record), and a tie between
    shards."""
    import torch

    from repro_torch.analysis.collectives import CollectiveRecorder
    from repro_torch.core.distributed import (axis_group,
                                              make_distributed_search,
                                              make_production_search)
    from repro_torch.core.search_api import SearchParams
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_irli_serve
    from repro_torch.store.quantized import QuantizedStore

    z = np.load(Path(tmp) / "inputs.npz")
    mesh = make_host_mesh(world, model_axis=2, device_type="cpu")
    shard = axis_group(mesh, ("data", "model")).index
    dshard = axis_group(mesh, "data").index
    assert shard == rank and dshard == rank // 2
    sp = SearchParams(m=4, tau=1, k=5, topC=1024)
    scorer = _scorer(z, "s_")
    q = _t(z["queries"])
    members, base = _t(z["members"][shard]), _t(z["base"][shard])
    out = {}
    search = make_production_search(mesh, sp)
    r = search(scorer, members, base, q)
    out["prod_fp32"] = (r.ids, r.scores, r.n_candidates, r.mode, r.epoch)
    with CollectiveRecorder() as rec:
        search(scorer, members, base, q)
    out["collectives"] = rec.calls
    store = QuantizedStore("int8", int(z["block"]), _t(z["codes"][shard]),
                           _t(z["scales"][shard]))
    r = make_production_search(mesh, sp.replace(store_dtype="int8"),
                               epoch=3)(scorer, members, store, q)
    out["prod_int8"] = (r.ids, r.scores, r.n_candidates, r.mode, r.epoch)
    r = make_distributed_search(mesh, sp)(
        _scorer(z, "d_", dshard), _t(z["members2"][dshard]),
        _t(z["base2"][dshard]), q)
    out["dist"] = (r.ids, r.scores, r.n_candidates, r.mode, r.epoch)
    step = build_irli_serve(mesh, m=4, tau=1, k=5, store_dtype="int8",
                            store_block=int(z["block"]))
    o = step({"scorer": scorer, "members": members,
              "base_codes": store.codes, "base_scales": store.scales},
             {"queries": q})
    out["serve_int8"] = (o["ids"], o["scores"])
    # every shard the same corpus and index: equal scores on all shards
    r = search(scorer, _t(z["members"][0]), _t(z["base"][0]), q)
    out["tie"] = (r.ids, r.scores)
    _save(tmp, "search", rank, out)


# -------------------------------------------------------------- the fit --
def fit_cfg():
    """tests/test_fit_engine.py's sharded-fit config: affinity_chunk 150
    gives 4 label chunks, which the data axis (2) divides."""
    from repro_torch.core.index import IRLIConfig
    return IRLIConfig(d=16, n_labels=600, n_buckets=32, n_reps=4,
                      d_hidden=32, K=4, rounds=2, epochs_per_round=2,
                      batch_size=200, lr=2e-3, affinity_chunk=150, seed=1)


def fit_data():
    from repro_torch.data.synthetic import clustered_ann
    return clustered_ann(n_base=600, n_queries=20, d=16, n_clusters=30,
                         k_gt=10, k_train=20, seed=0)


def injected_rounds(z, mesh=None):
    """Two engine rounds from the JAX package's initial scorer and hash
    partition with its batches and insertion orders injected (arrays in
    ``z``) -> (whole state, [metrics a round])."""
    from repro_torch.core.network import ScorerConfig
    from repro_torch.fit.engine import FitData, FitEngine
    from repro_torch.fit.state import FitState
    cfg = fit_cfg()
    data = fit_data()
    eng = FitEngine(cfg, ScorerConfig(
        d_in=cfg.d, d_hidden=cfg.d_hidden, n_buckets=cfg.n_buckets,
        n_reps=cfg.n_reps, loss=cfg.loss))
    fd = FitData.build(data.train_queries, data.train_gt,
                       label_vecs=data.base, n_labels=cfg.n_labels,
                       chunk=cfg.affinity_chunk)
    params = _scorer(z, "f_")
    state = FitState.create(params, eng.opt.init(params),
                            _t(z["f_assign"]), 0)
    if mesh is None:
        round_fn = eng.make_fit_round(fd)
    else:
        state = eng.shard_state(state, mesh)
        round_fn = eng.make_sharded_fit_round(mesh, fd, state)
    mets = []
    for rnd in range(2):
        state, met = round_fn(state, _t(z[f"b_idx{rnd}"]).long(),
                              _t(z[f"b_wt{rnd}"]), _t(z[f"b_orders{rnd}"]))
        mets.append({k: v.clone() for k, v in met.items()})
    if mesh is not None:
        state = eng.gather_state(state, mesh)
    return state, mets


def refit_setup():
    """A hash-partitioned index over fit_data()'s base, its mutable index
    and a query log of one search: the same on every rank."""
    from repro_torch import obs
    from repro_torch.core.index import IRLIIndex
    from repro_torch.core.search_api import SearchParams
    from repro_torch.stream import MutableIRLIIndex
    data = fit_data()
    idx = IRLIIndex(fit_cfg(), device="cpu")
    idx.build_index()
    mut = MutableIRLIIndex(idx, data.base, registry=obs.MetricRegistry())
    qlog = obs.QueryLog(capacity=256)
    qs = np.concatenate([data.train_queries[:100], data.queries])
    qlog.record(qs, mut.search(qs, SearchParams(m=4, tau=1, k=10,
                                                mode="compact")).ids)
    return mut, qlog


def refit_cycle(mesh=None):
    """One OnlineRefitLoop cycle -> (artifact's params, assign, the
    round's loss gauge)."""
    from repro_torch.online import OnlineRefitLoop, RefitConfig
    mut, qlog = refit_setup()
    loop = OnlineRefitLoop(mut, qlog, config=RefitConfig(min_queries=32),
                           registry=mut.registry, mesh=mesh)
    art = loop.run_cycle()
    return ({k: v.clone() for k, v in art.params.items()},
            art.assign.clone(), mut.registry.gauge("refit_loss").value,
            int(art.version))


def fit_ranks(rank: int, world: int, tmp: str) -> None:
    """4 ranks over a 2 × 2 ("data", "rep") mesh: IRLIIndex.fit(mesh=),
    two engine rounds with the JAX package's draws injected, and one
    OnlineRefitLoop(mesh=) cycle."""
    from repro_torch.core.index import IRLIIndex
    from repro_torch.launch.mesh import make_fit_mesh

    mesh = make_fit_mesh(world, rep_axis=2, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "rep")
    data = fit_data()
    idx = IRLIIndex(fit_cfg(), device="cpu")
    st = idx.fit(data.train_queries, data.train_gt, label_vecs=data.base,
                 mesh=mesh)
    out = {"fit": (st.train_loss, st.epoch_loss, st.n_reassigned,
                   st.load_std, idx.assign.clone(),
                   {k: v.clone() for k, v in idx.params.items()},
                   int(idx.opt_state["step"]), idx.index.members.clone())}
    z = np.load(Path(tmp) / "fit_inputs.npz")
    state, mets = injected_rounds(z, mesh)
    out["rounds"] = (state.assign.clone(), mets,
                     {k: v.clone() for k, v in state.params.items()})
    out["refit"] = refit_cycle(mesh)
    _save(tmp, "fit", rank, out)


# --------------------------------------------------- the Trainer on a mesh --
ELASTIC_RULES = [(r"w1", ("model", None, None)), (r"b1", ("model", None)),
                 (r"emb", (("data", "model"), None)), (r".*", ())]


def elastic_tree() -> dict:
    """A whole checkpoint tree: w1 [4, 3, 2] (rows over "model"), b1
    [3, 5] (3 rows: not divisible by "model" = 2, so replicated), emb
    [8, 2] (rows over the whole ("data", "model") grid), step (no rule)."""
    return {"params": {
        "w1": np.arange(24, dtype=np.float32).reshape(4, 3, 2),
        "b1": np.arange(15, dtype=np.float32).reshape(3, 5),
        "emb": np.arange(16, dtype=np.float32).reshape(8, 2)},
        "step": np.asarray(7, np.int32)}


def train_ranks(rank: int, world: int, tmp: str) -> None:
    """4 ranks: elastic_restore of a whole checkpoint onto a (data 2 ×
    model 2) mesh; then the mesh Trainer over build_irli_fit_parts(mesh=)
    at fit_cfg() for 3 rounds (a checkpoint every 2): uninterrupted on a
    2 × 2 ("data", "rep") mesh, then crashed at round 2 on 2 × 2 and
    resumed on 1 × 4."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import CheckpointManager
    from repro_torch.launch.mesh import make_fit_mesh, make_host_mesh
    from repro_torch.launch.steps import build_irli_fit_parts
    from repro_torch.models.module import ShardRules
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.train.trainer import (SimulatedFailure, Trainer,
                                           TrainerConfig)

    out = {}
    el = str(Path(tmp) / "elastic")
    if rank == 0:
        CheckpointManager(el).save(5, elastic_tree())
    dist.barrier()
    mesh = make_host_mesh(world, model_axis=2, device_type="cpu")
    tree, manifest = elastic_restore(el, mesh, ShardRules(ELASTIC_RULES),
                                     device="cpu")
    out["elastic"] = (tree, manifest["step"],
                      {n: int(mesh.get_local_rank(n))
                       for n in mesh.mesh_dim_names})

    cfg, data = fit_cfg(), fit_data()

    def trainer(mesh, name, fail_at=None):
        parts = build_irli_fit_parts(cfg, data.train_queries, data.train_gt,
                                     label_vecs=data.base, mesh=mesh,
                                     device="cpu")
        return Trainer(TrainerConfig(total_steps=3, checkpoint_every=2,
                                     fail_at_step=fail_at), *parts,
                       str(Path(tmp) / name), device="cpu",
                       sharded=parts.sharded)

    m22 = make_fit_mesh(world, rep_axis=2, device_type="cpu")
    full = trainer(m22, "full")
    fout = full.run()
    whole = full.sharded.gather(full.state)
    out["full"] = ([m["loss"] for m in fout["metrics"]],
                   whole["assign"].clone(),
                   {k: v.clone() for k, v in whole["params"].items()},
                   tuple(full.state["assign"].shape))
    try:
        trainer(m22, "crash", fail_at=2).run()
        raise AssertionError("no SimulatedFailure")
    except SimulatedFailure:
        pass
    saved, _ = CheckpointManager(str(Path(tmp) / "crash")).restore(1)
    m14 = make_fit_mesh(world, rep_axis=4, device_type="cpu")
    res = trainer(m14, "crash")
    rout = res.run()
    whole = res.sharded.gather(res.state)
    out["resumed"] = ([m["loss"] for m in rout["metrics"]],
                      whole["assign"].clone(),
                      {k: v.clone() for k, v in whole["params"].items()},
                      tuple(res.state["assign"].shape), res.resumed,
                      res.start_step, tuple(saved["assign"].shape),
                      int(whole["opt"]["step"]))
    _save(tmp, "train", rank, out)
