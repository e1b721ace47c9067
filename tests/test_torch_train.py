"""The port's training entry point against the JAX package, on the CPU: the
fault-tolerant Trainer (crash/restart, final checkpoint, elastic restore,
straggler count), one Trainer step over build_irli_fit_parts against the
reference's, Adafactor, the schedules and the clip, ShardRules on the
reference's rule sets, build_retrieval_serve, the FitState carried across,
and the launchers (launch/train --arch irli, launch/obs_smoke). The same
numpy inputs go through both packages; integers exact, fp32 to 1e-5, a fit
round to tests/test_torch_fit.py's tolerances."""
import dataclasses
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import (  # noqa: E402
    CheckpointManager as JCheckpointManager)
from repro.configs import dien as JDIEN  # noqa: E402
from repro.configs import irli_deep1b as JDEEP  # noqa: E402
from repro.fit import affinity as JA  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import dien as TDIEN  # noqa: E402
from repro_torch.configs import irli_deep1b as TDEEP  # noqa: E402
from repro_torch.configs.irli_deep1b import fit_config  # noqa: E402
from repro_torch.core import network as TN  # noqa: E402
from repro_torch.fit.state import FitState  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models.module import ShardRules  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    SimulatedFailure, Trainer, TrainerConfig, host_metrics)

KEYS = ("b1", "b2", "w1", "w2")
SCFG = TN.ScorerConfig(d_in=8, d_hidden=16, n_buckets=32, n_reps=2)


# ------------------------------------- tests/test_fault_tolerance.py, port --
def _make_parts(ckpt_dir, total=30, fail_at=None):
    """The reference test's trainer on the port: the scorer's BCE through
    build_train_step (autograd, AdamW in place), data a pure function of
    the step."""
    step, opt = TS.build_train_step(
        lambda p, b: (TN.scorer_loss(p, SCFG, b["x"], b["t"]), {}),
        "adamw_nomaster", lr=1e-3)

    def init_state():
        params = TN.scorer_init(SCFG, torch.Generator().manual_seed(0))
        return {"params": params, "opt": opt.init(params)}

    def batch_fn(i):  # deterministic per-step data => exact replay
        g = torch.Generator().manual_seed(1234 + i)
        x = torch.randn((16, 8), generator=g)
        t = (torch.rand((2, 16, 32), generator=g) > 0.9).float()
        return {"x": x, "t": t}

    cfg = TrainerConfig(total_steps=total, checkpoint_every=10,
                        fail_at_step=fail_at)
    return Trainer(cfg, step, init_state, batch_fn, ckpt_dir, device="cpu")


def test_crash_restart_bitwise_identical(tmp_path):
    ref = _make_parts(str(tmp_path / "ref"), total=30)
    ref.run()
    # crashing run: dies at step 25 (after the checkpoint at 19)
    with pytest.raises(SimulatedFailure):
        _make_parts(str(tmp_path / "crash"), total=30, fail_at=25).run()
    # restart: resumes from step 20 and lands bit-identical
    tr2 = _make_parts(str(tmp_path / "crash"), total=30)
    assert tr2.resumed and tr2.start_step == 20
    assert int(tr2.state["opt"]["step"]) == 20
    assert tr2.state["opt"]["step"].device.type == "cpu"
    tr2.run()
    for k in KEYS:
        assert torch.equal(ref.state["params"][k], tr2.state["params"][k])
        assert torch.equal(ref.state["opt"]["v"][k], tr2.state["opt"]["v"][k])


def test_final_checkpoint_written(tmp_path):
    tr = _make_parts(str(tmp_path / "fin"), total=12)
    out = tr.run()
    assert tr.ckpt.latest_step() == 11
    assert out["final_step"] == 11
    assert tr.ckpt.all_steps() == [9, 11]
    # the JAX package's manager reads the port's checkpoint
    tree, manifest = JCheckpointManager(str(tmp_path / "fin")).restore(11)
    assert manifest["step"] == 11
    np.testing.assert_array_equal(tree["params"]["w2"],
                                  tr.state["params"]["w2"].numpy())
    assert int(tree["opt"]["step"]) == 12


def test_elastic_restore_respects_divisibility(tmp_path):
    """Checkpoint -> restore with rules onto a one-rank (1, 1) mesh: every
    spec falls back to its whole leaf gracefully (divisibility guard)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.elastic import elastic_restore
    from torch_dist_ranks import one_rank_group

    tr = _make_parts(str(tmp_path / "el"), total=10)
    tr.run()
    rules = ShardRules([(r"w1", ("model", None, None)), (r".*", ())])
    with one_rank_group(tmp_path):
        mesh = make_host_mesh(1, 1, device_type="cpu")
        state, manifest = elastic_restore(str(tmp_path / "el"), mesh, rules,
                                          device="cpu")
    assert manifest["step"] == 9
    w1 = state["params"]["w1"]
    assert w1.shape == (2, 8, 16)
    assert torch.equal(w1, tr.state["params"]["w1"])


def test_straggler_counter(tmp_path):
    """A step that sleeps well past the EMA of the others counts as a
    straggler; the count and every step's time come back."""
    tr = _make_parts(str(tmp_path / "st"), total=8)
    orig = tr.step_fn

    def slow_step(state, batch):
        if int(state["opt"]["step"]) == 6:
            time.sleep(0.5)
        return orig(state, batch)
    tr.step_fn = slow_step
    out = tr.run()
    assert out["straggler_steps"] >= 1
    assert len(out["metrics"]) == 8
    assert max(m["step_time_s"] for m in out["metrics"]) >= 0.5


# --------------------------- tests/test_fit_engine.py crash/resume, port --
def _fit_inputs(seed=7, n=110, L=128, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, L, (n, 4)).astype(np.int32),
            rng.normal(size=(L, d)).astype(np.float32))


def test_crash_resume_bitwise_identical(tmp_path):
    """Kill a fit mid-run via fail_at_step, restore, and the final assign,
    params and loss trajectory are bit-identical to an uninterrupted
    run."""
    cfg = dataclasses.replace(fit_config(reduced=True), n_labels=128,
                              n_buckets=16, rounds=3, epochs_per_round=2,
                              batch_size=50)
    x, ids, lv = _fit_inputs()

    def trainer(dir_, fail_at=None):
        parts = TS.build_irli_fit_parts(cfg, x, ids, label_vecs=lv,
                                        device="cpu")
        tcfg = TrainerConfig(total_steps=3, checkpoint_every=2,
                             fail_at_step=fail_at)
        return Trainer(tcfg, *parts, str(tmp_path / dir_), device="cpu")

    ref = trainer("ref")
    ref_out = ref.run()
    with pytest.raises(SimulatedFailure):
        trainer("crash", fail_at=2).run()
    tr2 = trainer("crash")
    assert tr2.resumed and tr2.start_step == 2
    assert tr2.state["rng"].dtype == torch.uint8
    out2 = tr2.run()
    assert torch.equal(ref.state["assign"], tr2.state["assign"])
    assert torch.equal(ref.state["rng"], tr2.state["rng"])
    for k in KEYS:
        assert torch.equal(ref.state["params"][k], tr2.state["params"][k])
    ref_losses = [m["loss"] for m in ref_out["metrics"]]
    res_losses = [m["loss"] for m in out2["metrics"]]
    assert ref_losses[2:] == res_losses   # the re-run round, bit-identical
    assert tr2.state["round"] == 3 and tr2.state["epoch"] == 6


def test_fit_parts_start_where_the_index_does():
    """init_state is the state IRLIIndex(cfg) starts from; a round's
    metric row keeps scalars as floats and vectors of at most 64 values as
    lists."""
    from repro_torch.core.index import IRLIIndex
    cfg = dataclasses.replace(fit_config(reduced=True), n_labels=128,
                              n_buckets=16)
    x, ids, lv = _fit_inputs()
    step, init_state, batch_fn = TS.build_irli_fit_parts(
        cfg, x, ids, label_vecs=lv, device="cpu")
    st = init_state()
    idx = IRLIIndex(cfg, device="cpu")
    assert torch.equal(st["assign"], idx.assign)
    assert torch.equal(st["rng"], idx.rng)
    assert all(torch.equal(st["params"][k], idx.params[k]) for k in KEYS)
    st, met = step(st, batch_fn(0))
    rec = host_metrics(dict(met, big=torch.zeros(65)))
    assert isinstance(rec["loss"], float) and "big" not in rec
    assert isinstance(rec["epoch_loss"], list)
    assert len(rec["epoch_loss"]) == cfg.epochs_per_round
    assert rec["n_reassigned"] == float(met["n_reassigned"])


# ------------------------------------- one Trainer step against the JAX one --
@pytest.mark.parametrize("loss", ["softmax_bce", "sigmoid_bce"])
def test_one_trainer_step_matches_the_reference(tmp_path, loss):
    """One Trainer step over build_irli_fit_parts in both packages from the
    JAX package's scorer init and hash partition, with its round batches
    and insertion orders injected: losses and the grad norm to 1e-4, params
    to test_torch_fit.py's round tolerance, the assignment equal in every
    rep whose top-K ids agree; the port's checkpoint reads back through the
    JAX package's manager."""
    cfg = dataclasses.replace(fit_config(reduced=True), n_labels=300,
                              n_buckets=24, n_reps=3, rounds=1,
                              epochs_per_round=2, batch_size=64,
                              affinity_chunk=64, loss=loss)
    jcfg = dataclasses.replace(JDEEP.fit_config(reduced=True), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    rng = np.random.default_rng(10)
    n, L = 150, cfg.n_labels
    x = rng.normal(size=(n, cfg.d)).astype(np.float32)
    ids = rng.integers(0, L, (n, 5)).astype(np.int32)
    mask = (rng.random((n, 5)) > 0.2).astype(np.float32)
    lv = rng.normal(size=(L, cfg.d)).astype(np.float32)

    jstep, jinit, jbatch = JS.build_irli_fit_parts(jcfg, x, ids, mask, lv)
    init = jax.tree.map(np.asarray, jinit())
    jtr = JTrainer(JTrainerConfig(total_steps=1, checkpoint_every=1), jstep,
                   jinit, jbatch, str(tmp_path / "jax"))
    jout = jtr.run()
    jstate = jax.tree.map(np.asarray, jtr.state)
    b = jax.tree.map(np.asarray, jbatch(0))
    _, kr = jax.random.split(jnp.asarray(init["rng"]))
    orders = np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(kr, r), L)) for r in range(cfg.n_reps)])

    step, _, _ = TS.build_irli_fit_parts(cfg, x, ids, mask, lv, device="cpu")
    tr = Trainer(
        TrainerConfig(total_steps=1, checkpoint_every=1), step,
        lambda: convert.fit_state_from_reference(init, device="cpu")
        .as_dict(),
        lambda s: {"idx": torch.tensor(b["idx"]).long(),
                   "w": torch.tensor(b["w"]),
                   "orders": torch.from_numpy(orders)},
        str(tmp_path / "port"), device="cpu")
    out = tr.run()
    jm, tm = jout["metrics"][0], out["metrics"][0]
    assert set(jm) <= set(tm) and tm["step"] == jm["step"] == 0
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(tm["epoch_loss"], jm["epoch_loss"], rtol=1e-4)
    st = tr.state
    for k in KEYS:
        np.testing.assert_allclose(st["params"][k].numpy(),
                                   jstate["params"][k], rtol=1e-3,
                                   atol=2e-5, err_msg=k)
    assert int(st["opt"]["step"]) == int(jstate["opt"]["step"])
    assert st["round"] == int(jstate["round"]) == 1
    assert st["epoch"] == int(jstate["epoch"]) == cfg.epochs_per_round
    _, jtop = JA.affinity_topk_ann(jstate["params"], jnp.asarray(lv), cfg.K,
                                   loss, chunk=cfg.affinity_chunk)
    _, ttop = JA.affinity_topk_ann(
        {k: v.numpy() for k, v in st["params"].items()}, jnp.asarray(lv),
        cfg.K, loss, chunk=cfg.affinity_chunk)
    same = (np.asarray(ttop) == np.asarray(jtop)).all(axis=(1, 2))
    assert same.sum() >= cfg.n_reps - 1, same
    for r in np.flatnonzero(same):
        np.testing.assert_array_equal(st["assign"][r].numpy(),
                                      jstate["assign"][r])
    tree, _ = JCheckpointManager(str(tmp_path / "port")).restore(0)
    np.testing.assert_array_equal(tree["assign"], st["assign"].numpy())


def test_irli_train_step_matches_the_reference():
    """build_irli_train_step (multi-hot bucket targets, the scorer's BCE,
    autograd, AdamW with its clip in place) against the reference's on the
    same params and batches, three steps: the loss and the params to
    1e-5."""
    from repro.core import network as JN
    R, d, H, B, L, N = 3, 8, 16, 24, 50, 20
    jcfg = JN.ScorerConfig(d_in=d, d_hidden=H, n_buckets=B, n_reps=R)
    tcfg = TN.ScorerConfig(d_in=d, d_hidden=H, n_buckets=B, n_reps=R)
    params = {k: np.asarray(v) for k, v in JN.scorer_init(
        jax.random.PRNGKey(0), jcfg).items()}
    jstep, jopt = JS.build_irli_train_step(jcfg, B, lr=3e-3)
    tstep, topt = TS.build_irli_train_step(tcfg, B, lr=3e-3)
    jstate = {"params": params, "opt": jopt.init(params)}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = {"params": tp, "opt": topt.init(tp)}
    rng = np.random.default_rng(4)
    assign = rng.integers(0, B, (R, L)).astype(np.int32)
    for _ in range(3):
        batch = {"x": rng.normal(size=(N, d)).astype(np.float32),
                 "label_ids": rng.integers(0, L, (N, 4)).astype(np.int32),
                 "label_mask": (rng.random((N, 4)) > 0.3).astype(np.float32),
                 "assign": assign}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["bce"]), float(jm["bce"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        for k in KEYS:
            np.testing.assert_allclose(tstate["params"][k].numpy(),
                                       np.asarray(jstate["params"][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(tstate["opt"]["step"]) == 3


# ------------------------------------------ Adafactor, schedules, the clip --
def _tree(rng, scale=1.0):
    """Nested params: a factored leaf (last two dims >= 128), an unfactored
    matrix, a vector."""
    return {"emb": (rng.normal(size=(130, 64)) * scale).astype(np.float32),
            "layer": {"w": (rng.normal(size=(2, 128, 160)) * scale)
                      .astype(np.float32),
                      "b": (rng.normal(size=(160,)) * scale)
                      .astype(np.float32)}}


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in t.items()}


def _close_tree(got, want, tol=1e-5):
    for k, v in want.items():
        if isinstance(v, dict):
            _close_tree(got[k], v, tol)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=tol, atol=tol * 1e-2, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),
    dict(lr="cosine", weight_decay=0.01, clip_threshold=0.5),
])
def test_adafactor_matches_reference(kw):
    """Four steps on the same gradients: params and the factored (vr, vc)
    and unfactored (v) moments to 1e-5, the state layouts equal."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    if kw["lr"] == "cosine":
        jkw = dict(kw, lr=JO.cosine_schedule(1e-2, 2, 10))
        tkw = dict(kw, lr=TO.cosine_schedule(1e-2, 2, 10))
    else:
        jkw = tkw = kw
    jopt = JO.make_optimizer("adafactor", **jkw)
    topt = TO.make_optimizer("adafactor", **tkw)
    jp, js = params, jopt.init(jax.tree.map(jnp.asarray, params))
    tp = _torch_tree(params)
    ts = topt.init(tp)
    assert set(ts["v"]["layer"]["w"]) == {"vr", "vc"}
    assert set(ts["v"]["emb"]) == set(ts["v"]["layer"]["b"]) == {"v"}
    assert ts["v"]["layer"]["w"]["vr"].shape == js["v"]["layer"]["w"][
        "vr"].shape
    for _ in range(4):
        g = _tree(rng, 0.3)
        jp, js, jinfo = jopt.update(jp, g, js)
        tp, ts, tinfo = topt.update(tp, _torch_tree(g), ts)
        _close_tree(tp, jp)
        _close_tree(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"])
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                                   rtol=1e-6)


def test_schedules_match_reference():
    steps = [0, 1, 3, 5, 10, 37, 100, 150]
    for args in ((3e-4, 10, 100), (1.0, 0, 50, 0.2)):
        j, t = JO.cosine_schedule(*args), TO.cosine_schedule(*args)
        for s in steps:
            np.testing.assert_allclose(float(t(s)), float(j(s)), rtol=1e-6,
                                       err_msg=f"{args} step {s}")
            np.testing.assert_allclose(float(t(torch.tensor(s))),
                                       float(j(s)), rtol=1e-6)
    assert float(TO.constant_schedule(0.25)(7)) == float(
        JO.constant_schedule(0.25)(7))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(1), 0.1)
    jg, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = TO.clip_by_global_norm(_torch_tree(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    _close_tree(tg, jax.tree.map(np.asarray, jg))


# ------------------------------------------------------------ ShardRules --
def _ref_spec(spec):
    return tuple(spec)


def test_shard_rules_match_the_reference_rule_sets():
    """The port's copies of configs/irli_deep1b._rules and
    configs/dien._rules give the reference's per-dimension axes for every
    path of their trees (and a few that no rule names), and the same
    divisibility problems on a (data 2 × model 4) mesh."""
    from repro_torch.models.recsys import DIENConfig, dien_init
    deep_paths = [f"{p}{k}" for p in ("", "opt/m/", "opt/v/") for k in KEYS]
    small = DIENConfig(item_vocab=64, cate_vocab=30, embed_dim=4, seq_len=5,
                       gru_dim=6, mlp=(8, 4))
    from repro_torch.models.module import flatten_with_paths, tree_paths
    dien = convert.dien_params_to_reference(
        dien_init(small, seed=0, device="cpu"))
    dien_paths = tree_paths(dien) + ["item_table/table", "other/x"]
    assert "item_emb/table" in dien_paths
    cases = ((TDEEP.rules(), JDEEP._rules(), deep_paths),
             (TDIEN.rules(), JDIEN._rules(), dien_paths))
    for mine, ref, paths in cases:
        for p in paths:
            assert mine.spec_for(p) == _ref_spec(ref.spec_for(p)), p
    # specs() and check_divisible over a params tree
    scorer = {"w1": np.zeros((6, 8, 16)), "b1": np.zeros((6, 16)),
              "w2": np.zeros((4, 16, 32)), "b2": np.zeros((4, 32))}
    assert TDEEP.rules().specs(scorer) == {
        k: _ref_spec(v) for k, v in JDEEP._rules().specs(scorer).items()}
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((2, 4)))
    assert TDEEP.rules().check_divisible(scorer, {"data": 2, "model": 4}) \
        == JDEEP._rules().check_divisible(scorer, mesh)
    assert len(TDEEP.rules().check_divisible(scorer, {"data": 2,
                                                      "model": 4})) == 2
    strict = ShardRules([(r"w1", ("model",))], strict=True)
    with pytest.raises(ValueError, match="no sharding rule"):
        strict.spec_for("b1")
    assert flatten_with_paths({"a": {"b": 1}})[0][0] == "a/b"


# ------------------------------------------------------------- retrieval --
@pytest.mark.parametrize("kind", ["gaussian", "ties"])
def test_build_retrieval_serve_matches_reference(kind):
    """[Bq, d] · [N, d]ᵀ -> top-k, ids equal and scores to 1e-5. "ties":
    small-integer embeddings, whose dot products are exact and tie often,
    and every row repeated: the smaller id first, as jax.lax.top_k."""
    rng = np.random.default_rng(3)
    N, d, k = 4096, 36, 100
    if kind == "ties":
        half = rng.integers(-2, 3, (N // 2, d)).astype(np.float32)
        table = np.concatenate([half, half])
        query = rng.integers(-2, 3, (3, d)).astype(np.float32)
    else:
        table = rng.normal(size=(N, d)).astype(np.float32)
        query = rng.normal(size=(3, d)).astype(np.float32)
    ref = JS.build_retrieval_serve(k)({"item_table": {"table": table}},
                                      {"query": query})
    got = TS.build_retrieval_serve(k)(
        {"item_table": {"table": torch.from_numpy(table)}},
        {"query": query})
    assert got["ids"].dtype == torch.int32 and got["ids"].shape == (3, k)
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(ref["ids"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), rtol=1e-5,
                               atol=1e-5)
    if kind == "ties":
        s = got["scores"].numpy()
        assert (s[:, 1:] == s[:, :-1]).sum() > 50


def test_retrieval_cell_constants_are_the_references():
    from repro.configs import recsys_common as JRC
    from repro_torch.configs import recsys_common as TRC
    assert TRC.N_CANDIDATES == JRC.N_CANDIDATES == 1_048_576
    assert TDIEN.RETRIEVAL_DIM == JDIEN.CONFIG.embed_dim * 2 == 36
    cell = JRC.retrieval_cell(JDIEN.CONFIG.embed_dim * 2)
    shapes = TRC.retrieval_shapes(TDIEN.RETRIEVAL_DIM)
    assert cell.inputs(None)["query"].shape == shapes["query"]
    assert cell.params(None)["item_table"]["table"].shape == \
        shapes["item_table"]
    import inspect
    assert inspect.signature(JRC.retrieval_cell).parameters["k"].default \
        == TRC.RETRIEVAL_K


# ------------------------------------------------- the state carried across --
def test_fit_state_from_reference_round_trip():
    """A reference FitState dict after one round (numpy, as its Trainer
    restores it) -> the port's FitState -> the reference's layout again:
    params, AdamW moments and step, assign, round and epoch bit-equal; the
    random stream starts from the seed (the documented divergence)."""
    cfg = dataclasses.replace(JDEEP.fit_config(reduced=True), n_labels=128,
                              n_buckets=16)
    x, ids, lv = _fit_inputs()
    step, init, batch = JS.build_irli_fit_parts(cfg, x, ids, label_vecs=lv)
    st, _ = step(init(), batch(0))
    st = jax.tree.map(np.asarray, st)
    port = convert.fit_state_from_reference(st, seed=3, device="cpu")
    assert isinstance(port, FitState)
    assert port.round_idx == 1 and port.epoch_idx == cfg.epochs_per_round
    assert torch.equal(port.rng, torch.Generator().manual_seed(3).get_state())
    back = convert.fit_state_to_reference(port)
    assert set(back) == set(st) - {"rng"}
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want = dict(flat({k: st[k] for k in back}))
    got = dict(flat(back))
    assert want.keys() == got.keys()
    for path, v in want.items():
        assert np.asarray(got[path]).dtype == np.asarray(v).dtype, path
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


# ---------------------------------------------------------- the launchers --
def test_launch_train_irli_resumes_and_logs(tmp_path, capsys):
    """--arch irli --steps 3 on the CPU; run again it resumes from its
    checkpoint and says the run is complete; --metrics-log wrote one row a
    round."""
    from repro_torch.launch import train
    log = tmp_path / "m.jsonl"
    args = ["--arch", "irli", "--steps", "3", "--device", "cpu", "--ckpt",
            str(tmp_path / "ck")]
    out = train.main(args + ["--metrics-log", str(log)])
    assert out is None
    text = capsys.readouterr().out
    assert "irli: 3 rounds" in text and "resumed=False" in text
    rows = [json.loads(r) for r in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(r["arch"] == "irli" and "loss" in r for r in rows)
    train.main(args)
    text = capsys.readouterr().out
    assert "irli: already complete at round 3 (resumed=True)" in text


def test_fit_mesh_split_is_the_references():
    from repro_torch.launch.train import fit_mesh_split
    assert fit_mesh_split(4, 4, 128) == 2
    assert fit_mesh_split(2, 4, 128) == 2
    assert fit_mesh_split(8, 4, 128) == 2
    assert fit_mesh_split(3, 4, 128) is None
    assert fit_mesh_split(4, 1, 128) == 1


def test_obs_smoke_on_the_cpu(capsys):
    """The reference's observability CI check, on the port: every metric
    family lands in one registry (its own asserts)."""
    from repro_torch.launch import obs_smoke
    obs_smoke.main(device="cpu")
    assert "obs smoke OK" in capsys.readouterr().out
