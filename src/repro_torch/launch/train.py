"""Training launcher CLI. Port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id>
        [--steps N] [--ckpt DIR] [--devices N] [--metrics-log F]
        [--device cuda|cpu]

Every branch of the reference runs through the fault-tolerant ``Trainer``
(auto-resume from the newest checkpoint under ``<ckpt>/<arch>``):

  * the LM archs (gemma-7b, yi-6b, qwen3-4b, mixtral-8x7b,
    llama4-maverick-400b-a17b): ``LM_VARIANTS``, the reference's reduced
    configs (its ``tests/test_smoke_archs.py:22-45``, value for value),
    through ``build_lm_train_step`` (``adamw_nomaster``, ``n_micro=2``, lr
    1e-3) on [4, 64] token batches with next-token labels;
  * ``schnet``: a reduced SchNet (32 RBFs, width 32) through
    ``build_gnn_energy_train`` on ``molecule_batch(16, 8, 16)``;
  * ``irli``: the paper's own workload, fit rounds (the eager train /
    re-partition round of ``fit/engine.py``) over
    ``configs/irli_deep1b.fit_config(reduced=True)`` on ``clustered_ann``;
    ``--steps`` counts ROUNDS;
  * any other arch: the recsys family's reduced DLRM (3 sparse fields)
    through ``build_ctr_train_step`` on a seeded synthetic stream.

A batch is a pure function of the step (a ``torch.Generator`` or numpy
generator seeded with it; RNG streams do not cross packages), so a resumed
run replays the same batches. A run whose checkpoints already reach
``--steps`` says so and stops; raise ``--steps`` to go on. ``--metrics-log``
appends one JSONL row a step (``obs.MetricsLogger``).

``--devices N`` (N > 1, ``irli`` only) starts N ranks on this host
(``torch.multiprocessing`` spawn, ``torch.distributed`` over
``tcp://localhost`` with a free port: NCCL with one card a rank when there
are N cards, gloo otherwise, on the CPU with ``--device cpu``) and fits on
a (data × rep) mesh chosen as the reference chooses it
(``launch/mesh.make_fit_mesh``). The checkpoint holds the WHOLE state:
rank 0 writes it and every rank takes its rep rows of a restored one, so a
fit checkpointed on one mesh shape resumes on another. Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

LM_ARCHS = ("gemma-7b", "yi-6b", "qwen3-4b", "mixtral-8x7b",
            "llama4-maverick-400b-a17b")


def _tiny_lm(name, **kw):
    base = dict(name=name, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, vocab=512, param_dtype="float32",
                q_chunk=32, ce_chunk=64)
    base.update(kw)
    return LMConfig(**base)


#: the reference's reduced LM configs (tests/test_smoke_archs.py:22-45)
LM_VARIANTS = {
    "gemma-7b": _tiny_lm("gemma-7b", act="gelu", embed_scale=True,
                         tie_embeddings=True),
    "yi-6b": _tiny_lm("yi-6b", n_kv_heads=2, tie_embeddings=False),
    "qwen3-4b": _tiny_lm("qwen3-4b", n_kv_heads=2, qk_norm=True),
    "mixtral-8x7b": _tiny_lm(
        "mixtral-8x7b", attn_pattern=("swa",), window=32,
        moe=MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                      ffn_chunk=1 << 16)),
    "llama4-maverick-400b-a17b": _tiny_lm(
        "llama4", n_layers=4,
        attn_pattern=("chunked", "chunked", "chunked", "full"), chunk=32,
        nope_on_full=True,
        moe=MoEConfig(d_model=64, d_ff=128, n_experts=8, top_k=1,
                      n_shared_experts=1, ffn_chunk=1 << 16)),
}

#: the reduced DLRM of the recsys branch
DLRM_REDUCED = dict(vocab_sizes=(1000, 500, 300), n_sparse=3, n_dense=8,
                    embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 1))


def fit_mesh_split(n_dev: int, n_reps: int, batch_size: int) -> int | None:
    """The rep axis of the (data × rep) mesh over ``n_dev`` ranks, as the
    reference picks it: rep | n_reps and data | batch_size, 2 when it is
    valid (both axes used), else the smallest valid; None when none is."""
    valid = [r for r in range(1, n_dev + 1)
             if n_dev % r == 0 and n_reps % r == 0
             and batch_size % (n_dev // r) == 0]
    if not valid:
        return None
    return 2 if 2 in valid else valid[0]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt", default="build/repro_ckpt",
                    help="checkpoint root; the run uses <ckpt>/<arch>")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to start on this host (0 or 1: one)")
    ap.add_argument("--metrics-log", default="",
                    help="append per-step metric rows to this JSONL file "
                         "(obs.MetricsLogger, docs/observability.md)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if args.arch != "irli":
        run_model(args)
        return
    if args.devices > 1:
        import socket

        import torch.multiprocessing as mp
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(_rank, args=(args, port), nprocs=args.devices, join=True)
        return
    run_irli(args)


def _log_metrics(args, out, start: int):
    from repro_torch import obs
    with obs.MetricsLogger(args.metrics_log) as mlog:
        for i, m in enumerate(out["metrics"]):
            mlog.log(dict(m, arch=args.arch), step=start + i)
    print(f"metrics log -> {args.metrics_log}")


def model_parts(arch: str, dev):
    """(step, init_state, batch_fn) of the LM, ``schnet`` and recsys
    branches on ``dev``, as the reference builds them."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch import steps as S
    from repro_torch.models.module import tensor_tree

    if arch in LM_ARCHS:
        from repro_torch.models.transformer import lm_init
        cfg = LM_VARIANTS[arch]
        step, opt = S.build_lm_train_step(cfg, "adamw_nomaster", n_micro=2,
                                          lr=1e-3)

        def init_state():
            params = tensor_tree(lm_init(cfg, seed=0, device=dev))
            return {"params": params, "opt": opt.init(params)}

        def batch_fn(i):
            g = torch.Generator().manual_seed(i)
            t = torch.randint(0, cfg.vocab, (4, 64), generator=g,
                              dtype=torch.int32)
            return {"tokens": t, "labels": torch.roll(t, -1, 1)}
    elif arch == "schnet":
        from repro_torch.data.synthetic import molecule_batch
        from repro_torch.models.gnn import SchNetConfig, schnet_init
        cfg = SchNetConfig(d_in=0, n_types=10, n_out=1, readout="sum",
                           n_rbf=32, d_hidden=32)
        step, opt = S.build_gnn_energy_train(cfg, 16, lr=1e-3)

        def init_state():
            params = schnet_init(cfg, seed=0, device=dev)
            return {"params": params, "opt": opt.init(params)}

        def batch_fn(i):
            return molecule_batch(16, 8, 16, seed=i)
    else:  # recsys family: dlrm-style CTR on a synthetic stream
        from repro_torch.models.recsys import (DLRMConfig, dlrm_apply,
                                               dlrm_init)
        cfg = dataclasses.replace(DLRMConfig(), **DLRM_REDUCED)
        params0, offsets = dlrm_init(cfg, seed=0, device=dev)
        step, opt = S.build_ctr_train_step(
            lambda p, b: dlrm_apply(p, cfg, offsets, b["dense"],
                                    b["sparse"]), lr=1e-3)

        def init_state():
            return {"params": params0, "opt": opt.init(params0)}

        def batch_fn(i):
            r = np.random.default_rng(i)
            return {"dense": r.normal(size=(64, 8)).astype(np.float32),
                    "sparse": r.integers(0, 300, (64, 3)).astype(np.int32),
                    "label": r.integers(0, 2, 64).astype(np.float32)}
    return step, init_state, batch_fn


def run_model(args):
    """The LM, ``schnet`` and recsys branches: ``--steps`` train steps
    through the Trainer (checkpoint every 10 and at the end)."""
    from repro_torch.kernels import resolve_device
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    tr = Trainer(TrainerConfig(total_steps=args.steps, checkpoint_every=10),
                 *model_parts(args.arch, dev),
                 os.path.join(args.ckpt, args.arch), device=dev)
    out = tr.run()
    losses = [m["loss"] for m in out["metrics"]]
    if not losses:       # restored a finished run: nothing left to do
        print(f"{args.arch}: already complete at step {tr.start_step} "
              f"(resumed={out['resumed']}); raise --steps to continue")
        return out
    print(f"{args.arch}: {len(losses)} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, resumed={out['resumed']}")
    if args.metrics_log:
        _log_metrics(args, out, tr.start_step)
    return out


def _rank(rank: int, args, port: int):
    import torch
    import torch.distributed as dist
    cards = torch.cuda.device_count() if args.device != "cpu" else 0
    nccl = cards >= args.devices
    if args.device != "cpu":
        torch.cuda.set_device(rank % max(cards, 1))
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=args.devices, rank=rank)
    try:
        run_irli(args, device_type="cpu" if args.device == "cpu" else "cuda",
                 quiet=rank != 0)
    finally:
        dist.destroy_process_group()


def run_irli(args, device_type: str | None = None, quiet: bool = False):
    """The ``irli`` branch; on a mesh when a process group is up."""
    import torch.distributed as dist

    from repro_torch.configs.irli_deep1b import fit_config
    from repro_torch.data.synthetic import clustered_ann
    from repro_torch.kernels import resolve_device
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_fit_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    say = (lambda *a: None) if quiet else print
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = fit_config(reduced=True)
    data = clustered_ann(n_base=cfg.n_labels, n_queries=32, d=cfg.d,
                         n_clusters=cfg.n_labels // 20, k_gt=10, k_train=20,
                         seed=0)
    mesh = None
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    if n_dev > 1:
        rep = fit_mesh_split(n_dev, cfg.n_reps, cfg.batch_size)
        if rep is None:
            raise ValueError(
                f"fit mesh: no (data, rep) split of {n_dev} ranks fits "
                f"n_reps={cfg.n_reps} / batch={cfg.batch_size}")
        mesh = make_fit_mesh(n_dev, rep_axis=rep, device_type=device_type)
        say(f"fit mesh: "
            f"{dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))}")
    parts = S.build_irli_fit_parts(cfg, data.train_queries, data.train_gt,
                                   label_vecs=data.base, mesh=mesh,
                                   device=dev)
    tr = Trainer(TrainerConfig(total_steps=args.steps,
                               checkpoint_every=max(2, args.steps // 2)),
                 *parts, os.path.join(args.ckpt, args.arch), device=dev,
                 sharded=parts.sharded)
    out = tr.run()
    losses = [m["loss"] for m in out["metrics"]]
    if not losses:       # restored a finished run: nothing left to do
        say(f"irli: already complete at round {tr.start_step} "
            f"(resumed={out['resumed']}); raise --steps to continue")
        return out
    moved = [m["n_reassigned"] for m in out["metrics"]]
    say(f"irli: {len(losses)} rounds, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"reassigned {moved[0]:.0f} -> {moved[-1]:.0f}, "
        f"resumed={out['resumed']}")
    if args.metrics_log and not quiet:
        _log_metrics(args, out, tr.start_step)
    return out


if __name__ == "__main__":
    main()
