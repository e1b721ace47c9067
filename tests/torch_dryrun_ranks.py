"""Rank programs of tests/test_torch_dryrun.py. This module imports torch,
numpy and the port only (no jax), so a spawned rank starts quickly.

``irli_mesh_ranks`` runs the irli-deep1b scorer's train step
(``launch/steps.build_irli_train_step``) on DTensors placed as the
train_scorers cell places them, on gloo ranks through
``torch_dist_ranks.spawn``; ``lm_dryrun`` and ``serve_dryrun`` run the dry
run on torch's fake process group, one process a world size;
``ctr_dryrun`` records the 20 CTR and SchNet cells of one production mesh
for tests/test_torch_dryrun_ctr_*.py.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

#: the narrow scorer: d, H, B, R and rows, labels a row, labels in all
D, H, B, R, N, K, L = 8, 16, 12, 4, 16, 5, 40


def scorer_cfg():
    from repro_torch.core.network import ScorerConfig
    return ScorerConfig(d_in=D, d_hidden=H, n_buckets=B, n_reps=R,
                        loss="softmax_bce")


def irli_mesh_ranks(rank: int, world: int, tmp: str) -> None:
    """The step on a (world // 2, 2) mesh (world 1: (1, 1)) from the
    inputs in ``irli_in.npz``: the mesh loss and its gradient reduced to
    the params' placements (``irli_mesh_loss`` under ``grads_of``), then
    one step of ``build_irli_train_step`` (AdamW's first moment and the
    params after it, the step's loss). Rank 0 writes ``irli_mesh.npz``;
    every rank checks that the state kept its placements."""
    import torch

    from repro_torch.configs.irli_deep1b import rules
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.module import data_axes, place
    z = np.load(Path(tmp) / "irli_in.npz")
    cfg = scorer_cfg()
    mesh = make_host_mesh(world, model_axis=min(2, world), device_type="cpu")
    params = {k: torch.from_numpy(z[k]) for k in ("w1", "b1", "w2", "b2")}
    pspecs = rules().specs(params)
    step, opt = S.build_irli_train_step(cfg, B)
    ospecs = S.opt_state_specs("adamw_nomaster", params, pspecs, mesh)
    state = S.place_train_state({"params": params, "opt": opt.init(params)},
                                pspecs, ospecs, mesh)
    dp = data_axes(mesh)
    specs = {"x": (dp, None), "label_ids": (dp, None),
             "label_mask": (dp, None), "assign": ("model", ("data",))}
    batch = {k: place(torch.from_numpy(z[k]), s, mesh)
             for k, s in specs.items()}
    loss, _, grads = S.grads_of(
        lambda p, b: (S.irli_mesh_loss(p, cfg, b, B), {}), state["params"],
        batch)
    out = {"loss": loss.numpy()}
    for k, g in grads.items():
        out["g_" + k] = g.redistribute(
            g.device_mesh, state["params"][k].placements).full_tensor().numpy()
    placements = {k: v.placements for k, v in state["params"].items()}
    state, metrics = step(state, batch)
    for k, p in state["params"].items():
        assert p.placements == placements[k], (k, p.placements)
        out["p_" + k] = p.full_tensor().numpy()
        out["m_" + k] = state["opt"]["m"][k].full_tensor().numpy()
    out["step_loss"] = metrics["loss"].numpy()
    if rank == 0:
        np.savez(Path(tmp) / "irli_mesh.npz", **out)


def _fake_world(n: int):
    from repro_torch.launch.dryrun import fake_world
    fake_world(n)


#: the tiny LM cell's [batch, seq], train_4k's [256, 4096] with the
#: sequence cut so that the trace (about half a millisecond an op under
#: DTensor and the fake mode) takes seconds; its mesh, (data 16, model 4):
#: 8 microbatches of 32 rows over 16 data ranks, as at full size
LM_BATCH, LM_SEQ = 256, 32
LM_MESH = (16, 4)


def lm_dryrun(tmp: str) -> None:
    """The dry run of a tiny MoE LM's train_4k cell (the reference's
    reduced mixtral: 2 layers, d = 64, 4 experts, the "plain" microbatch
    grouping; the cell's step, specs and 8 microbatches at [LM_BATCH,
    LM_SEQ]) on a fake 64-rank LM_MESH mesh -> ``lm.json``: the record,
    and rank 0's local shard bytes of the params (by ``rules()``), the
    optimizer state (by ``opt_state_specs``) and the batch, summed
    independently."""
    import torch

    from repro_torch.configs import lm_common
    from repro_torch.configs.lm_common import make_lm_arch
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import opt_state_specs
    from repro_torch.launch.train import LM_VARIANTS
    from repro_torch.models.module import flatten_with_paths
    lm_common.SHAPES["train_4k"] = dict(seq=LM_SEQ, batch=LM_BATCH,
                                        kind="train")
    _fake_world(LM_MESH[0] * LM_MESH[1])
    mesh = make_host_mesh(LM_MESH[0] * LM_MESH[1], model_axis=LM_MESH[1],
                          device_type="cuda")
    arch = make_lm_arch(LM_VARIANTS["mixtral-8x7b"], opt="adamw")
    rec = DR.record_cell(arch, "train_4k", mesh)
    meta = arch.abstract_params()
    pspecs = arch.rules().specs(meta)
    ospecs = opt_state_specs("adamw", meta, pspecs, mesh)

    def shard_bytes(tree, specs, dtype=None):
        total = 0
        for path, t in flatten_with_paths(tree):
            spec = specs
            for k in path.split("/"):
                spec = spec[k]
            n = math.prod(DR._local_shape(t.shape, spec, mesh))
            total += n * (dtype or t.dtype).itemsize
        return total

    cell = arch.cells["train_4k"]
    want = (shard_bytes(meta, pspecs)
            + sum(shard_bytes(meta, ospecs[k], torch.float32)
                  for k in ("m", "v", "master"))
            + 4                                    # the host step counter
            + shard_bytes(cell.inputs(mesh), cell.in_specs(mesh)))
    (Path(tmp) / "lm.json").write_text(json.dumps(
        {"record": rec, "want_argument_bytes": want}))


def serve_dryrun(tmp: str, mesh_kind: str) -> None:
    """The CLI's dry run of irli-deep1b on one production mesh, then of a
    skipped cell and of a shape the registry lacks, into ``dry.json``; the
    exit codes to ``rc.json``."""
    from repro_torch.launch import dryrun as DR
    out = str(Path(tmp) / "dry.json")
    rcs = [DR.main(["--mesh", mesh_kind, "--arch", "irli-deep1b",
                    "--out", out]),
           DR.main(["--mesh", mesh_kind, "--arch", "irli-deep1b",
                    "--out", out]),
           DR.main(["--mesh", mesh_kind, "--arch", "gemma-7b", "--shape",
                    "long_500k", "--out", out])]
    ok = json.loads(Path(out).read_text())
    rcs.append(DR.main(["--mesh", mesh_kind, "--arch", "gemma-7b",
                        "--shape", "no_such_shape", "--out", out]))
    (Path(tmp) / "rc.json").write_text(json.dumps(
        {"rcs": rcs, "before_error": ok}))


#: the CTR and SchNet archs, each with its four cells
CTR_ARCHS = ("dlrm-mlperf", "dien", "bst", "xdeepfm", "schnet")


def ctr_dryrun(tmp: str, mesh_kind: str) -> None:
    """The CLI's dry run of the 20 CTR and SchNet cells on one production
    mesh, an arch a call, into ``ctr_<mesh>.json``; the exit codes to
    ``ctr_rc.json``."""
    from repro_torch.launch import dryrun as DR
    out = str(Path(tmp) / f"ctr_{mesh_kind}.json")
    rcs = [DR.main(["--mesh", mesh_kind, "--arch", a, "--out", out])
           for a in CTR_ARCHS]
    (Path(tmp) / "ctr_rc.json").write_text(json.dumps(rcs))


def _shard_bytes(tree, specs, mesh) -> int:
    """Bytes of rank 0's local shards of a tree (dicts and lists) of
    global shapes under its spec tree."""
    from repro_torch.launch import dryrun as DR
    if isinstance(tree, dict):
        return sum(_shard_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_shard_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return math.prod(DR._local_shape(tree.shape, specs, mesh)) \
        * tree.dtype.itemsize


def _kernel_layers(cfg) -> int:
    """The layers whose prefill attention takes the flash-attention
    kernel (``models/attention.uses_kernel`` at the params' dtype)."""
    import torch

    from repro_torch.models.attention import uses_kernel
    dt = getattr(torch, cfg.param_dtype)
    return sum(uses_kernel(cfg.attn_cfg(i % cfg.period), dt)
               for i in range(cfg.n_layers))


def lm_serve_dryrun(tmp: str, mesh_kind: str, group: str) -> None:
    """The dry run of the LM serve cells of ``group`` on one production
    mesh (``torch_dryrun_lm_serve``: "decode", the decode_32k and
    long_500k cells; "prefill", the prefill_32k cells) -> ``lm_<group>_
    <mesh>.json``: the records, rank 0's shard bytes of each cell's params
    (by ``rules()``) and inputs (by its in_specs, the caches' per layer)
    summed independently, the kernel layers of each prefill and the CLI's
    exit codes. The full-size cells go through the CLI, an arch and shape
    a call; the MoE prefill cells are recorded cut (``CUT_SEQ``,
    ``CUT_LAYERS``) by ``record_cell`` on an arch built from the cut
    config."""
    import dataclasses
    import importlib

    import torch_dryrun_lm_serve as C

    from repro_torch.configs import lm_common
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_production_mesh
    cells = C.DECODE_CELLS if group == "decode" else C.PREFILL_CELLS

    def cut(cell):
        return group == "prefill" and cell.split("/")[0] in C.CUT_LAYERS

    dry = str(Path(tmp) / f"dry_{group}_{mesh_kind}.json")
    rcs = [DR.main(["--mesh", mesh_kind, "--arch", c.split("/")[0],
                    "--shape", c.split("/")[1], "--out", dry])
           for c in cells if not cut(c)]
    recs = json.loads(Path(dry).read_text())
    DR.fake_world(DR.WORLD[mesh_kind])
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type="cuda")
    want, launches = {}, {}
    for cell in cells:
        name, shape = cell.split("/")
        cfg = importlib.import_module(ARCHS[name]).CONFIG
        arch = get_arch(name)
        if cut(cell):
            cfg = dataclasses.replace(cfg, n_layers=C.CUT_LAYERS[name])
            whole = lm_common.SHAPES[shape]
            lm_common.SHAPES[shape] = dict(whole, seq=C.CUT_SEQ)
            try:
                arch = lm_common.make_lm_arch(cfg, opt=arch.opt)
            finally:
                lm_common.SHAPES[shape] = whole
            recs[cell] = DR.record_cell(arch, shape, mesh)
        meta = arch.abstract_params()
        c = arch.cells[shape]
        want[cell] = (_shard_bytes(meta, arch.rules().specs(meta), mesh)
                      + _shard_bytes(c.inputs(mesh), c.in_specs(mesh),
                                     mesh))
        launches[cell] = _kernel_layers(cfg) if shape == "prefill_32k" \
            else 0
    (Path(tmp) / f"lm_{group}_{mesh_kind}.json").write_text(json.dumps(
        {"records": {c: recs[c] for c in cells}, "want": want,
         "launches": launches, "rcs": rcs}))
