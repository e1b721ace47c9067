"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's records and its store accounting, and the irli-deep1b scorer's
train step on DTensors against the meshless step and against
``jax.value_and_grad`` of the reference's loss.

A process holds one default process group, so each world runs in a
process of its own: the fake 256-, 512- and 8-rank worlds in a
subprocess (``tests/torch_dryrun_ranks.py``), the gloo ranks through
``torch_dist_ranks.spawn``. The reference's own records of irli-deep1b
(``python -m repro.launch.dryrun --arch irli-deep1b``, jax 0.9.0, per
device) are the constants below.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks as R  # noqa: E402
import torch_dryrun_ranks as DRR  # noqa: E402
from repro.core import network as JN  # noqa: E402
from repro.core import partition as JP  # noqa: E402

#: the reference's per-device records of irli-deep1b
REF = {
    "single": {"serve_args": 2_828_029_952, "serve_flops": 5.3945e12,
               "serve_all_gather": 83_886_080,
               "train_args": 254_927_652},
    "multi": {"serve_args": 2_733_158_400, "serve_flops": 5.3945e12,
              "serve_all_gather": 167_772_160,
              "train_args": 253_715_236},
}
#: serve_query's [R, Q, B] fp32 logits, which the plain top-m would hold
LOGITS_BYTES = 32 * 4096 * 20_000 * 4

ROOT = Path(__file__).resolve().parents[1]


def _run(tmp, call: str, timeout: float = 300.0) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c", f"import torch_dryrun_ranks as T; {call}"],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_irli_deep1b_records_against_the_reference(tmp_path, mesh_kind):
    """serve_query's argument bytes and all-gather bytes exactly the
    reference's, its FLOPs within 2%, its temporaries far below the
    [R, Q, B] logits; train_scorers' argument bytes exactly the
    reference's; the CLI's cache, skip and error statuses and exit
    codes."""
    _run(tmp_path, f"T.serve_dryrun({str(tmp_path)!r}, {mesh_kind!r})")
    out = json.loads((tmp_path / "rc.json").read_text())
    ref = REF[mesh_kind]
    serve = out["before_error"]["irli-deep1b/serve_query"]
    train = out["before_error"]["irli-deep1b/train_scorers"]
    assert serve["status"] == train["status"] == "ok"
    assert serve["argument_bytes"] == ref["serve_args"]
    assert serve["collectives"]["all-gather"] == ref["serve_all_gather"]
    assert abs(serve["flops"] / ref["serve_flops"] - 1) < 0.02
    assert serve["temp_bytes"] < LOGITS_BYTES / 5
    assert serve["launches"] == {"irli_topk": 1, "freq_topc": 1,
                                 "quant_rerank": 1}
    assert serve["store_accounting"]["fp32_over_int8"] > 3
    assert train["argument_bytes"] == ref["train_args"]
    world = 256 if mesh_kind == "single" else 512
    assert serve["world_size"] == train["world_size"] == world
    skip = out["before_error"]["gemma-7b/long_500k"]
    assert skip["status"] == "skip" and "quadratic" in skip["reason"]
    # ok, cached, skip: 0; a shape the registry lacks: an error and exit
    # code 1
    assert out["rcs"] == [0, 0, 0, 1]
    err = json.loads((tmp_path / "dry.json").read_text())[
        "gemma-7b/no_such_shape"]
    assert err["status"] == "error" and "no_such_shape" in err["error"]


def test_deep1b_serve_store_accounting():
    """The port of test_store.py::test_deep1b_serve_store_accounting."""
    from repro_torch.configs.irli_deep1b import (D as D1B, N_CORPUS,
                                                 N_SCALE_BLOCKS,
                                                 serve_store_bytes)
    from repro_torch.launch.dryrun import check_store_accounting
    acct = serve_store_bytes(512)
    l_loc = N_CORPUS // 512
    assert acct["fp32_per_shard"] == l_loc * D1B * 4
    assert acct["int8_per_shard"] == l_loc * (D1B + 4 * N_SCALE_BLOCKS)
    assert acct["fp32_per_shard"] / acct["int8_per_shard"] > 3
    rec = {"argument_bytes":
           512 * (acct["int8_per_shard"] + acct["members_per_shard"])}
    check_store_accounting(rec, 512)
    assert rec["store_accounting"]["fp32_over_int8"] > 3
    bad = {"argument_bytes": 512 * (acct["fp32_per_shard"]
                                    + acct["members_per_shard"])}
    with pytest.raises(AssertionError, match="fp32"):
        check_store_accounting(bad, 512)


def test_tiny_lm_train_cell_on_a_fake_64_rank_mesh(tmp_path):
    """The reference's reduced mixtral (2 layers, d = 64) in a train_4k
    cell (its step, specs and 8 microbatches in the "plain" grouping;
    [256, 4096] tokens cut to [256, 32]) on a fake (data 16, model 4)
    mesh, more data ranks than microbatches as at full size: argument
    bytes the sum of rank 0's local shards by rules() and opt_state_specs,
    every model FLOP done on some rank, the router's tie tests answered
    and counted as host reads."""
    _run(tmp_path, f"T.lm_dryrun({str(tmp_path)!r})")
    out = json.loads((tmp_path / "lm.json").read_text())
    rec = out["record"]
    assert rec["status"] == "ok"
    assert rec["argument_bytes"] == out["want_argument_bytes"]
    assert rec["flops_ratio"] >= 1.0
    assert rec["world_size"] == 64
    assert rec["host_reads"].get("core/topk.py:topk_stable", 0) > 0
    assert rec["collective_count"] > 0
    assert rec["temp_bytes"] > 0 and rec["peak_bytes"] > \
        rec["argument_bytes"]


# ---------------------------------------- train_scorers on a mesh --------
def _inputs():
    rng = np.random.default_rng(0)
    params = {k: np.asarray(v, np.float32) for k, v in JN.scorer_init(
        jax.random.PRNGKey(3), JN.ScorerConfig(
            d_in=DRR.D, d_hidden=DRR.H, n_buckets=DRR.B, n_reps=DRR.R,
            loss="softmax_bce")).items()}
    params["b1"] = rng.standard_normal(params["b1"].shape).astype(
        np.float32) * 0.1
    params["b2"] = rng.standard_normal(params["b2"].shape).astype(
        np.float32) * 0.1
    batch = {
        "x": rng.standard_normal((DRR.N, DRR.D)).astype(np.float32),
        "label_ids": rng.integers(0, DRR.L, (DRR.N, DRR.K)).astype(
            np.int32),
        "label_mask": (rng.random((DRR.N, DRR.K)) < 0.7).astype(np.float32),
        "assign": rng.integers(0, DRR.B, (DRR.R, DRR.L)).astype(np.int32),
    }
    return params, batch


def _reference(params, batch):
    jcfg = JN.ScorerConfig(d_in=DRR.D, d_hidden=DRR.H, n_buckets=DRR.B,
                           n_reps=DRR.R, loss="softmax_bce")
    targets = JP.bucket_targets(jnp.asarray(batch["assign"]),
                                jnp.asarray(batch["label_ids"]),
                                jnp.asarray(batch["label_mask"]), DRR.B)
    loss, g = jax.value_and_grad(lambda p: JN.scorer_loss(
        p, jcfg, jnp.asarray(batch["x"]), targets))(
            {k: jnp.asarray(v) for k, v in params.items()})
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def _meshless(params, batch):
    from repro_torch.launch import steps as S
    step, opt = S.build_irli_train_step(DRR.scorer_cfg(), DRR.B)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, metrics = step({"params": p, "opt": opt.init(p)}, b)
    return float(metrics["loss"]), {
        k: state["opt"]["m"][k].numpy() for k in p}


def _close(got, want, tol=1e-4):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("world", [1, 4])
def test_irli_train_step_on_a_mesh(tmp_path, world):
    """build_irli_train_step on DTensors, rows and assign's labels over
    "data", the reps over "model": loss and gradient at JAX's draws equal
    jax.value_and_grad of the reference's scorer_loss, and AdamW's first
    moment after one step equals the meshless step's, to 1e-4."""
    params, batch = _inputs()
    np.savez(tmp_path / "irli_in.npz", **params, **batch)
    R.spawn(DRR.irli_mesh_ranks, world, tmp_path, timeout=200.0)
    z = np.load(tmp_path / "irli_mesh.npz")
    ref_loss, ref_g = _reference(params, batch)
    assert abs(float(z["loss"]) - ref_loss) <= 1e-4 * abs(ref_loss)
    _close({k: z["g_" + k] for k in params}, ref_g)
    step_loss, m = _meshless(params, batch)
    assert abs(float(z["step_loss"]) - step_loss) <= 1e-4 * abs(step_loss)
    _close({k: z["m_" + k] for k in params}, m)
