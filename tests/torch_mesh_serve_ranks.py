"""Rank programs of tests/test_torch_mesh_lm_serve.py: gloo ranks on the
CPU running the LM's prefill and KV-cache decode on DTensors
(``launch/steps.build_lm_prefill`` and ``build_lm_decode`` on a placed
params tree and placed batches) beside the meshless steps. This module
imports torch, numpy and the port only (no jax), so a spawned rank starts
quickly; the ranks meet through ``torch_dist_ranks.spawn``.

Rank 0 writes each case's results to ``<case>.npz`` in ``tmp``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

#: the prefill's [B, S]; the decode's context and steps
PREFILL_B, PREFILL_S = 4, 48
CONTEXT, STEPS = 37, 3
#: each decode row's first position: with CONTEXT = 37 over a 2-wide
#: "model" axis the blocks are slots 0-18 and 19-36, so row 1 writes
#: 18, 19, 20 across the boundary; on the tiny mixtral's 32-slot ring
#: (blocks 0-15, 16-31) row 2 writes slots 30, 31, 0 (the ring wraps)
#: and row 3 slots 1, 2, 3
FIRST_POS = (5, 18, 30, 33)
#: the long_500k-style layout: one row, the token whole, the sequence over
#: ("data", "model") (37 slots in blocks of 10, 10, 10, 7)
LONG_FIRST_POS = 8
#: the case whose decode starts from the reference's draws, written by
#: the test to ``<case>.params.npz`` under the port's paths
REF_CASE = "yi-6b"


def serve_cases() -> dict:
    """name -> LMConfig: the reference launcher's tiny LM variants
    (``launch/train.LM_VARIANTS``: gemma, yi, qwen3, mixtral's SWA ring,
    llama4's chunked and NoPE layers), and gemma with 16 kv heads of 8
    (``configs/lm_common._cache_sharding`` then splits the caches' kv
    heads over "model", as for gemma-7b; the others split the
    sequence)."""
    from repro_torch.launch.train import LM_VARIANTS
    out = dict(LM_VARIANTS)
    out["gemma-7b-kv16"] = dataclasses.replace(
        LM_VARIANTS["gemma-7b"], n_heads=16, n_kv_heads=16, head_dim=8)
    return out


def _rel(a, b) -> float:
    """The largest |a - b| over the largest |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _random_caches(cfg, B: int, ctx: int, seed: int):
    """The decode's caches filled with N(0, 1) draws (a prompt's K and V
    stand-ins) in fp32."""
    import torch

    from repro_torch.models.transformer import init_cache
    gen = torch.Generator().manual_seed(seed)
    caches = init_cache(cfg, B, ctx, device="cpu")
    for c in caches:
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    return caches


def _decode_run(cfg, params, mesh, cache_specs, batch_spec, first_pos,
                seed: int, steps: int, ref_tokens=None) -> dict:
    """``steps`` decode steps meshless and on the mesh from the same caches
    and tokens (each step's input the meshless step's next token) ->
    per step the logits' and the caches' largest relative errors, whether
    the next tokens are equal, and the mesh steps' logits."""
    import torch

    from repro_torch.launch import steps as PS
    from repro_torch.models.module import place, place_tree
    B = len(first_pos)
    caches = _random_caches(cfg, B, CONTEXT, seed)
    mcaches = place_tree(caches, cache_specs, mesh)
    placed = place_tree(params, _rules(cfg).specs(params), mesh)
    step = PS.build_lm_decode(cfg, CONTEXT)
    rng = np.random.default_rng(seed)
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (B,)).astype(
        np.int32)) if ref_tokens is None else torch.from_numpy(ref_tokens[0])
    out = {"logit_err": [], "cache_err": [], "tokens_equal": [],
           "mesh_logits": [], "mesh_tokens": [], "dtensor_caches": []}
    for s in range(steps):
        pos = torch.tensor([p + s for p in first_pos], dtype=torch.int32)
        want = step(params, {"token": token, "pos": pos, "caches": caches})
        got = step(placed, {"token": place(token, batch_spec, mesh),
                            "pos": place(pos, batch_spec, mesh),
                            "caches": mcaches})
        out["dtensor_caches"].append(got["caches"] is mcaches and all(
            hasattr(t, "placements") for c in mcaches for t in c.values()))
        logits = _whole(got["logits"])
        nt = _whole(got["next_token"])
        out["logit_err"].append(_rel(logits, want["logits"]))
        out["cache_err"].append(max(
            _rel(_whole(mc[n]), c[n]) for mc, c in zip(mcaches, caches)
            for n in ("k", "v")))
        out["tokens_equal"].append(bool(torch.equal(nt, want["next_token"])))
        out["mesh_logits"].append(logits.numpy())
        out["mesh_tokens"].append(nt.numpy())
        token = want["next_token"] if ref_tokens is None else \
            torch.from_numpy(ref_tokens[min(s + 1, len(ref_tokens) - 1)])
    return out


def _rules(cfg):
    from repro_torch.configs.lm_common import lm_rules
    return lm_rules(cfg)


def serve_ranks(rank: int, world: int, tmp: str) -> None:
    """Every case of ``serve_cases`` on a (data 2, model 2) mesh: the
    prefill at [PREFILL_B, PREFILL_S] (logits, hidden and next token
    against the meshless step's; the flash_attention billings of the
    mesh step), STEPS decode steps in the decode_32k layout
    (``_cache_sharding``) and in the long_500k layout
    (``_long_cache_sharding``, one row, token and pos whole); the greedy
    token of vocabulary-split logits with ties across blocks; the REF_CASE decode from the reference's draws
    (``ref_decode.npz``: params, caches' seed, tokens, positions)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.cost import analyze_call
    from repro_torch.configs.lm_common import (_cache_sharding,
                                               _long_cache_sharding)
    from repro_torch.launch import steps as PS
    from repro_torch.models import module as M
    from repro_torch.models.module import place, place_tree, tensor_tree
    from repro_torch.models.transformer import lm_init

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name, cfg in serve_cases().items():
        params = tensor_tree(lm_init(cfg, seed=0, device="cpu"))
        out = {}
        # ---- prefill
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (PREFILL_B, PREFILL_S)).astype(np.int32))
        prefill = PS.build_lm_prefill(cfg)
        want = prefill(params, {"tokens": tokens})
        placed = place_tree(params, _rules(cfg).specs(params), mesh)
        rec, got = analyze_call(prefill, (placed, {"tokens": place(
            tokens, (("data",), None), mesh)}), device="cpu")
        for k in ("logits", "hidden"):
            out[f"prefill_{k}_err"] = _rel(_whole(got[k]), want[k])
        out["prefill_tokens_equal"] = bool(torch.equal(
            _whole(got["next_token"]), want["next_token"]))
        out["prefill_outputs_dtensors"] = all(
            M.is_dtensor(v) for v in got.values())
        out["prefill_flash"] = rec["launches"].get("flash_attention", 0)
        out["prefill_flash_meshless"] = analyze_call(
            prefill, (params, {"tokens": tokens}), device="cpu")[0][
                "launches"].get("flash_attention", 0)
        # ---- decode_32k layout
        dec = _decode_run(cfg, params, mesh, _cache_sharding(cfg, mesh),
                          (("data",),), FIRST_POS, seed=2, steps=STEPS)
        out.update({f"decode_{k}": np.array(v) for k, v in dec.items()
                    if not k.startswith("mesh")})
        out["cache_layout"] = "heads" if cfg.n_kv_heads % 16 == 0 else "seq"
        # ---- long_500k layout
        long = _decode_run(cfg, params, mesh,
                           _long_cache_sharding(cfg, mesh), (),
                           (LONG_FIRST_POS,), seed=3, steps=STEPS)
        out.update({f"long_{k}": np.array(v) for k, v in long.items()
                    if not k.startswith("mesh")})
        if rank == 0:
            np.savez(Path(tmp) / f"{name}.npz", **out)

    # the greedy token across the vocabulary's blocks (ids 0-3 on the
    # first "model" rank, 4-7 on the second): ties go to the smaller id
    logits = torch.tensor([[0., 1., 3., 0., 2., 1., 3., 0.],
                           [0., 1., 2., 0., 2., 5., 3., 0.],
                           [-4., -1., -3., -2., -1., -5., -3., -1.],
                           [7., 7., 7., 7., 7., 7., 7., 7.]])
    got = PS.next_token(M.place(logits, (("data",), "model"), mesh))
    whole = _whole(got)
    if rank == 0:
        np.savez(Path(tmp) / "ties.npz", got=whole.numpy(),
                 placements=str(tuple(got.placements)),
                 want=np.array([2, 5, 1, 0]))

    ref = Path(tmp) / "ref_decode.npz"
    if ref.exists():
        z = np.load(ref)
        cfg = serve_cases()[REF_CASE]
        params = M.map_with_paths(
            lambda p, _: torch.from_numpy(z[f"param__{p}"]),
            tensor_tree(lm_init(cfg, seed=0, device="cpu")))
        dec = _decode_run(cfg, params, mesh, _cache_sharding(cfg, mesh),
                          (("data",),), tuple(int(p) for p in z["first_pos"]),
                          seed=int(z["seed"]), steps=STEPS,
                          ref_tokens=z["tokens"])
        if rank == 0:
            np.savez(Path(tmp) / "ref_mesh.npz",
                     logits=np.stack(dec["mesh_logits"]),
                     tokens=np.stack(dec["mesh_tokens"]))
