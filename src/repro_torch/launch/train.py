"""Training launcher CLI. Port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch irli
        [--steps N] [--ckpt DIR] [--devices N] [--metrics-log F]
        [--device cuda|cpu]

``--arch irli`` is the paper's own workload: fit rounds (the eager train /
re-partition round of ``fit/engine.py``) through the fault-tolerant
``Trainer``, over ``configs/irli_deep1b.fit_config(reduced=True)`` on
``clustered_ann``. ``--steps`` counts ROUNDS. A run whose checkpoints
already reach ``--steps`` says so and stops; raise ``--steps`` to go on.
``--metrics-log`` appends one JSONL row a round (``obs.MetricsLogger``).

``--devices N`` (N > 1) starts N ranks on this host (``torch.
multiprocessing`` spawn, ``torch.distributed`` over ``tcp://localhost``
with a free port: NCCL with one card a rank when there are N cards, gloo
otherwise, on the CPU with ``--device cpu``) and fits on a (data × rep)
mesh chosen as the reference chooses it (``launch/mesh.make_fit_mesh``).
The checkpoint holds the WHOLE state: rank 0 writes it and every rank takes
its rep rows of a restored one, so a fit checkpointed on one mesh shape
resumes on another. Runs on the card unless ``--device cpu``.

The reference's other branches wait, each for its ROADMAP item: the LM
archs (item 7: their train step needs a backward through the attention),
``schnet`` and the recsys/DLRM default (item 8).
"""
from __future__ import annotations

import argparse
import os

LM_ARCHS = ("gemma-7b", "yi-6b", "qwen3-4b", "mixtral-8x7b",
            "llama4-maverick-400b-a17b")


def unported(arch: str) -> str | None:
    """Why ``arch``'s branch is not ported, or None for ``irli``."""
    if arch == "irli":
        return None
    if arch in LM_ARCHS:
        return (f"--arch {arch}: the LM train step waits for ROADMAP.md "
                f"queue 1 item 7 (a backward pass through the attention)")
    if arch == "schnet":
        return ("--arch schnet: the GNN waits for ROADMAP.md queue 1 "
                "item 8 (models/gnn.py)")
    return (f"--arch {arch}: the recsys/DLRM train step waits for "
            f"ROADMAP.md queue 1 item 8 (models/recsys DLRM, "
            f"build_ctr_train_step)")


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
    why = unported(args.arch)
    if why is not None:
        raise NotImplementedError(why)
    if args.devices > 1:
        import socket

        import torch.multiprocessing as mp
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(_rank, args=(args, port), nprocs=args.devices, join=True)
        return
    run_irli(args)


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
        from repro_torch import obs
        with obs.MetricsLogger(args.metrics_log) as mlog:
            for i, m in enumerate(out["metrics"]):
                mlog.log(dict(m, arch=args.arch), step=tr.start_step + i)
        say(f"metrics log -> {args.metrics_log}")
    return out


if __name__ == "__main__":
    main()
