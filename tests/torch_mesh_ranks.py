"""Rank programs of tests/test_torch_mesh_lm.py and tests/test_torch_
configs.py: gloo ranks on the CPU running the port's mesh surfaces (the
LM train step on DTensors, compressed_psum, ShardedLoader). This module
imports torch, numpy and the port only (no jax), so a spawned rank starts
quickly; the ranks meet through ``torch_dist_ranks.spawn``.

Each program writes its results to ``.npz`` files in ``tmp`` (rank 0, or
every rank under its own name) for the tests to read.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

#: the mesh LM's batch and microbatches: [GB, S] with n_micro 2
GB, S, N_MICRO = 4, 64, 2
#: an MoE ffn_chunk below a microbatch's GB / N_MICRO · S = 128 tokens:
#: the per-row dispatch in sequence chunks of 64 // 2 = 32
ROWS_FFN_CHUNK = 64
#: the case that starts from the reference's draws, written by the test
#: to ``<case>.params.npz`` under the port's paths; its mesh loss and
#: gradient before the first step are saved whole, to be held against
#: the reference's
REF_CASE = "gemma-7b"


def lm_cases() -> dict:
    """name -> (LMConfig, optimizer, microbatch grouping): the reference
    launcher's tiny LM variants (``launch/train.LM_VARIANTS``, equal to
    ``tests/test_smoke_archs.LM_VARIANTS``) with their arch's optimizer
    and grouping, qwen3 also with ``seq_shard_attn``, with one kv head and
    with 3 query heads (the attention's three layouts on a 2-wide "model"
    axis), mixtral also with the k-choice router, and the per-row MoE
    dispatch (``ffn_chunk`` below a microbatch's tokens: ``moe._moe_rows``,
    the path of train_4k's microbatches at full size) with both routers
    over tensor-parallel experts and with 16 experts over "model"."""
    from repro_torch.launch.train import LM_VARIANTS
    out = {}
    for name, cfg in LM_VARIANTS.items():
        opt = "adafactor" if name.startswith("llama4") else "adamw"
        split = "plain" if name.startswith("mixtral") else "strided"
        out[name] = (cfg, opt, split)
    qwen = LM_VARIANTS["qwen3-4b"]
    out["qwen3-4b-seq-shard"] = (
        dataclasses.replace(qwen, seq_shard_attn=True), "adamw", "strided")
    # one kv head (each rank's query heads read it whole), and 3 query
    # heads (the "model" axis splits no head: every rank computes all)
    out["qwen3-4b-one-kv-head"] = (
        dataclasses.replace(qwen, n_kv_heads=1), "adamw", "strided")
    out["qwen3-4b-three-heads"] = (
        dataclasses.replace(qwen, n_heads=3, n_kv_heads=1), "adamw",
        "strided")
    mix = LM_VARIANTS["mixtral-8x7b"]
    out["mixtral-8x7b-kchoice"] = (
        dataclasses.replace(mix, moe=dataclasses.replace(
            mix.moe, router="irli_kchoice")), "adamw", "plain")
    rows = dict(ffn_chunk=ROWS_FFN_CHUNK)
    out["mixtral-8x7b-rows"] = (
        dataclasses.replace(mix, moe=dataclasses.replace(mix.moe, **rows)),
        "adamw", "plain")
    out["mixtral-8x7b-kchoice-rows"] = (
        dataclasses.replace(mix, moe=dataclasses.replace(
            mix.moe, router="irli_kchoice", **rows)), "adamw", "plain")
    llama = LM_VARIANTS["llama4-maverick-400b-a17b"]
    out["llama4-16-experts-rows"] = (
        dataclasses.replace(llama, moe=dataclasses.replace(
            llama.moe, n_experts=16, **rows)), "adafactor", "strided")
    return out


def lm_batches(cfg, n: int = 2) -> list[dict]:
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, cfg.vocab, (GB, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (GB, S)).astype(np.int32)}
            for _ in range(n)]


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))


def lm_ranks(rank: int, world: int, tmp: str) -> None:
    """Every case of ``lm_cases`` on a (data 2, model 2) mesh: the same
    state stepped twice meshless and on the mesh. Per case, rank 0 saves
    the two steps' losses and grad norms (meshless, mesh), the largest
    relative error of any gradient leaf before each step (``lm_grads`` at
    the meshless state, placed on the mesh for the mesh's, read back by
    ``full_tensor``), each state leaf's after the two steps,
    and whether every DTensor leaf kept its placements."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.lm_common import lm_rules
    from repro_torch.launch import steps as PS
    from repro_torch.models import module as M
    from repro_torch.models.module import (flatten_with_paths, tensor_tree,
                                           tree_to)
    from repro_torch.models.transformer import lm_init

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name, (cfg, opt_kind, split) in lm_cases().items():
        params = tensor_tree(lm_init(cfg, seed=0, device="cpu"))
        ref = Path(tmp) / f"{name}.params.npz"
        if ref.exists():
            z = np.load(ref)
            params = M.map_with_paths(
                lambda p, _: torch.from_numpy(z[p]), params)
        kw = dict(n_micro=N_MICRO, micro_split=split, lr=1e-3)
        step, opt = PS.build_lm_train_step(cfg, opt_kind, **kw)
        mstep, _ = PS.build_lm_train_step(cfg, opt_kind, mesh=mesh, **kw)
        state = {"params": tree_to(params, "cpu"), "opt": opt.init(params)}
        pspecs = lm_rules(cfg).specs(params)
        ospecs = PS.opt_state_specs(opt_kind, params, pspecs, mesh)
        mstate = PS.place_train_state(
            {"params": tree_to(params, "cpu"), "opt": opt.init(params)},
            pspecs, ospecs, mesh)
        before = {p: tuple(t.placements)
                  for p, t in flatten_with_paths(mstate)
                  if hasattr(t, "placements")}
        out = {"loss": [], "mesh_loss": [], "grad_norm": [],
               "mesh_grad_norm": [], "grad_err": []}
        for b in lm_batches(cfg):
            # the gradient both ways at the meshless state of this step
            t = {k: torch.from_numpy(v) for k, v in b.items()}
            _, g = PS.lm_grads(state["params"], cfg, t["tokens"],
                               t["labels"], N_MICRO, split)
            here = M.place_tree(state["params"], pspecs, mesh)
            mb = PS._placed(here, t, mesh)
            mloss, mg = PS.lm_grads(here, cfg, mb["tokens"], mb["labels"],
                                    N_MICRO, split)
            out["grad_err"].append(max(
                _rel(a, c.full_tensor()) for (_, a), (_, c) in zip(
                    flatten_with_paths(g), flatten_with_paths(mg))))
            if ref.exists() and "ref_loss" not in out:
                out["ref_loss"] = float(mloss.full_tensor()
                                        if M.is_dtensor(mloss) else mloss)
                out.update({f"g0__{p}": c.full_tensor().numpy()
                            for p, c in flatten_with_paths(mg)})
            state, m = step(state, b)
            mstate, mm = mstep(mstate, b)
            out["loss"].append(float(m["loss"]))
            out["mesh_loss"].append(float(mm["loss"]))
            out["grad_norm"].append(float(m.get("grad_norm", np.nan)))
            out["mesh_grad_norm"].append(float(mm.get("grad_norm", np.nan)))
        state_err = {p: _rel(a, c.full_tensor() if hasattr(c, "full_tensor")
                             else c)
                     for (p, a), (_, c) in zip(flatten_with_paths(state),
                                               flatten_with_paths(mstate))}
        after = {p: tuple(t.placements)
                 for p, t in flatten_with_paths(mstate)
                 if hasattr(t, "placements")}
        if rank == 0:
            np.savez(Path(tmp) / f"{name}.npz", **out,
                     placements_kept=before == after,
                     n_dtensors=len(after),
                     state_err_paths=np.array(list(state_err)),
                     state_err=np.array(list(state_err.values())))


def two_rank_checks(rank: int, world: int, tmp: str) -> None:
    """compressed_psum (none, int8, top-k) over "data" on inputs the test
    wrote (``psum_in.npz``: each rank's gradient leaves and int8 noise),
    ShardedLoader's blocks of a batch and ``models.module.on_rows``; each
    rank saves ``rank<r>.npz``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.loader import ShardedLoader
    from repro_torch.optim.compression import (CompressionConfig, ef_init,
                                               compressed_psum)

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    z = np.load(Path(tmp) / "psum_in.npz")
    names = sorted({k.split("__")[1] for k in z.files if k.startswith("g")})
    grads = {n: torch.from_numpy(z[f"g{rank}__{n}"]) for n in names}
    noise = [torch.from_numpy(z[f"u{rank}__{n}"]) for n in names]
    out = {}
    for kind in ("none", "int8", "topk"):
        cfg = CompressionConfig(kind=kind, topk_frac=0.25)
        summed, ef = compressed_psum(cfg, grads, ef_init(grads), noise,
                                     "data", mesh=mesh)
        for n in names:
            out[f"{kind}__{n}"] = summed[n].numpy()
            out[f"{kind}_ef__{n}"] = ef[n].numpy()

    batch = {"tokens": np.arange(4 * 3, dtype=np.int32).reshape(4, 3),
             "mask": np.ones((4,), np.float32), "note": "kept"}
    loader = ShardedLoader(iter([batch, batch]), mesh,
                           lambda k: ("data", None) if k == "tokens" else (),
                           prefetch=2)
    got = next(loader)
    out["tokens_local"] = got["tokens"].to_local().numpy()
    out["tokens_full"] = got["tokens"].full_tensor().numpy()
    out["tokens_placements"] = str(tuple(got["tokens"].placements))
    out["mask_local"] = got["mask"].to_local().numpy()
    out["note"] = got["note"]
    out["second_equal"] = bool(
        (next(loader)["tokens"].to_local() == got["tokens"].to_local()).all())

    # on_rows: each data rank computes on its own rows (5 split 3 + 2),
    # outputs and gradients whole again
    from repro_torch.models.module import on_rows, place
    x = place(torch.arange(15.0).reshape(5, 3), (), mesh).requires_grad_()
    seen = []

    def fn(a, k):
        seen.append(tuple(a.shape))
        return a * k, a.sum(1)

    y, s = on_rows(fn, x, 2.0)
    (y.sum() + s.sum()).backward()
    out["on_rows_seen"] = np.array(seen[0])
    out["on_rows_y"] = y.full_tensor().detach().numpy()
    out["on_rows_s"] = s.full_tensor().detach().numpy()
    out["on_rows_placements"] = str((tuple(y.placements),
                                     tuple(s.placements)))
    out["on_rows_grad"] = x.grad.full_tensor().numpy()
    np.savez(Path(tmp) / f"rank{rank}.npz", **out)
