"""Static-contract audit CLI — the gate over repro_torch.analysis.
Port of ``repro/launch/audit.py``.

Runs every contract registered beside the port's entry points (compact
query, quantized store, fit round in-place state and signatures, mesh
collectives, each kernel dispatch site) over their concrete toy fixtures
on one device, REQUIRING each negative contract's control to trip (no
vacuous proofs), writes a JSON report and exits non-zero on any violation:

    PYTHONPATH=src python -m repro_torch.launch.audit              # on the card
    PYTHONPATH=src python -m repro_torch.launch.audit --device cpu
    PYTHONPATH=src python -m repro_torch.launch.audit --contract query.compact_no_dense_table
    PYTHONPATH=src python -m repro_torch.launch.audit --list
    PYTHONPATH=src python -m repro_torch.launch.audit --seed-violation dense_table

``--device`` is ``cuda`` unless the caller asks for the CPU, and raises
without a card. Contracts with ``min_devices > 1`` (the mesh collectives)
run inside one spawned world of WORLD gloo ranks on that device (NCCL
refuses two ranks on one card); rank 0 reports. The report goes to
``--json`` (default ``build/audit/ANALYSIS.json``, git-ignored); no
trajectory rows are written.

``--seed-violation {dense_table,drop_donation,extra_retrace,
split_dispatch}`` registers a deliberately violating contract and audits it
alone: the self-test that each analyser detects the regression class it
guards against. Exit codes: 0 all passed, 1 a violation, 2 a seeded
violation that went undetected.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[3]
#: ranks of the world the mesh contracts run in
WORLD = 4


# ------------------------------------------------------- seeded violations --
def _seed_dense_table():
    """A pipeline that DOES build the [Q, L] table, registered under the
    compact contract's checks: the op recorder must fail it."""
    from repro_torch.analysis import contracts as C

    def fixture():
        from repro_torch.analysis import fixtures as FX
        return FX.query_search("dense")

    return C.Contract(
        id="seeded.dense_table",
        site="repro_torch.launch.audit --seed-violation dense_table",
        description="deliberate violation: dense mode under the compact "
                    "no-[Q, L] contract",
        fixture=fixture,
        checks=[C.forbid_dims("Q", "L")],
        control=fixture,
    )


def _seed_drop_donation():
    """A state update whose result CANNOT hold the donated input's storage
    (its shape changes): the donation check must fail it, the way it
    would a refactor that made the fit round return a fresh copy of its
    state."""
    from repro_torch.analysis import contracts as C

    def fixture():
        s = torch.zeros((64,), dtype=torch.float32,
                        device=C.audit_device())

        def fn(state, g):
            # the [128] result can never be the donated [64] input
            return torch.cat([state + g, state - g])
        return C.Fixture(fn=fn, args=(s, s.clone()), donate_argnums=(0,))

    return C.Contract(
        id="seeded.drop_donation",
        site="repro_torch.launch.audit --seed-violation drop_donation",
        description="deliberate violation: donation requested but the "
                    "result holds none of the donated storage",
        fixture=fixture,
        checks=[C.require_donated()],
    )


def _seed_extra_retrace():
    """A dtype-drift sweep (an int32 then an int64 tensor under one
    logical key): the signature counter must fail it."""
    from repro_torch.analysis import contracts as C
    from repro_torch.analysis.recompile import SignatureCounter

    def fixture():
        dev = C.audit_device()
        counted = SignatureCounter(lambda x, s: x * s)
        x = torch.ones((8,), dtype=torch.int32, device=dev)
        variants = [("int32-scale", torch.tensor(2, dtype=torch.int32,
                                                 device=dev)),
                    ("int64-scale", torch.tensor(2, dtype=torch.int64,
                                                 device=dev))]
        return C.Fixture(
            fn=None, args=(),
            sweep={"call": lambda s: counted(x, s), "variants": variants,
                   "counter": counted})

    return C.Contract(
        id="seeded.extra_retrace",
        site="repro_torch.launch.audit --seed-violation extra_retrace",
        description="deliberate violation: dtype drift gives one logical "
                    "cache key a second signature",
        fixture=fixture,
        checks=[C.max_trace_count(1)],
    )


def _seed_split_dispatch():
    """The compact query path run as its separate stages: three dispatch
    sites (and, on the card, many CUDA kernels) under the fused path's
    single-dispatch contract. The counters must fail it, the way they
    would a refactor that quietly hoisted a stage back out of mega."""
    from repro_torch.analysis import contracts as C

    def fixture():
        from repro_torch.analysis import fixtures as FX
        return FX.mega_split_control()

    return C.Contract(
        id="seeded.split_dispatch",
        site="repro_torch.launch.audit --seed-violation split_dispatch",
        description="deliberate violation: per-stage dispatch sequence "
                    "under the mega single-dispatch contract",
        fixture=fixture,
        checks=[C.max_dispatches(1)],
        control=fixture,
    )


SEEDED = {"dense_table": _seed_dense_table,
          "drop_donation": _seed_drop_donation,
          "extra_retrace": _seed_extra_retrace,
          "split_dispatch": _seed_split_dispatch}


# -------------------------------------------------------------- the world --
def _world_rank(rank: int, world: int, tmp: str, ids: list, device: str,
                run_control: bool) -> None:
    """One rank of the mesh contracts' world: audit ``ids`` in lockstep
    with the other ranks; rank 0 writes the reports to tmp/reports.json,
    a failing rank its traceback to tmp/err<rank>.txt."""
    import torch.distributed as dist

    from repro_torch.kernels import resolve_device
    try:
        torch.set_num_threads(1)
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=300))
        from repro_torch.analysis import REGISTRY, load_all
        load_all()
        reps = [REGISTRY.audit(cid, run_control=run_control, device=dev)
                for cid in ids]
        if rank == 0:
            (Path(tmp) / "reports.json").write_text(
                json.dumps([r.to_dict() for r in reps]))
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def audit_in_world(ids, *, device, run_control: bool = True,
                   world: int = WORLD, timeout: float = 600.0) -> list:
    """Audit ``ids`` inside one spawned world of ``world`` gloo ranks on
    ``device`` -> rank 0's ContractReports. Raises with the ranks'
    tracebacks if one fails or outlives ``timeout`` s; every rank is
    stopped before this returns."""
    import multiprocessing

    from repro_torch.analysis.contracts import ContractReport
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="irli_audit_") as tmp:
        procs = [ctx.Process(target=_world_rank,
                             args=(r, world, tmp, list(ids), str(device),
                                   run_control))
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
        text = "\n".join(f.read_text() for f in sorted(Path(tmp).glob(
            "err*")))
        if text or hung or any(p.exitcode for p in procs):
            raise RuntimeError(f"audit world failed: ranks {hung} past "
                               f"{timeout} s, exit codes "
                               f"{[p.exitcode for p in procs]}\n{text}")
        return [ContractReport.from_dict(d) for d in json.loads(
            (Path(tmp) / "reports.json").read_text())]


def audit_ids(ids, *, device, run_control: bool = True) -> list:
    """Audit registered contracts on ``device``, in ``ids`` order: those
    with ``min_devices > 1`` in one spawned world of WORLD ranks (when
    this process is in no world of that size already), the others
    here."""
    from repro_torch.analysis import REGISTRY
    from repro_torch.analysis.contracts import world_size
    from repro_torch.kernels import resolve_device
    device = resolve_device(device)
    mesh = [cid for cid in ids
            if REGISTRY.get(cid).min_devices > world_size()]
    out = dict(zip(mesh, audit_in_world(mesh, device=device,
                                        run_control=run_control)
                   if mesh else []))
    for cid in ids:
        if cid not in out:
            out[cid] = REGISTRY.audit(cid, run_control=run_control,
                                      device=device)
    return [out[cid] for cid in ids]


def audit_seeded(name: str, *, device):
    """Register the seeded violation ``name`` and audit it alone -> its
    ContractReport."""
    from repro_torch.analysis import REGISTRY
    contract = SEEDED[name]()
    REGISTRY.register(contract)
    return REGISTRY.audit(contract.id, device=device)


# ---------------------------------------------------------------- reporting --
def report_lines(r) -> list:
    """A report as the CLI prints it."""
    status = ("SKIP" if r.skipped else "PASS" if r.passed else "FAIL")
    lines = [f"[{status}] {r.contract_id}  ({r.site})  {r.seconds:.2f} s"]
    if r.skipped:
        return lines + [f"       {r.control_detail}"]
    if r.error:
        lines.append(f"       fixture error: {r.error}")
    for c in r.checks:
        lines.append(f"       {'ok ' if c.passed else 'BAD'} {c.check}: "
                     f"{c.detail}")
    if r.control_ok is not None:
        lines.append(f"       {'ok ' if r.control_ok else 'BAD'} "
                     f"control: {r.control_detail}")
    if r.peak_bytes:
        lines.append(f"       peak intermediate: {r.peak_bytes} bytes "
                     f"({r.peak})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.audit",
        description="prove every registered static contract (memory, "
                    "in-place state, signatures, dispatches, collectives); "
                    "nonzero exit on any violation")
    ap.add_argument("--contract", action="append", default=None,
                    help="audit only this contract id (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list registered contract ids and exit")
    ap.add_argument("--no-control", action="store_true",
                    help="skip the control runs (faster, but negative "
                    "proofs are then unverified)")
    ap.add_argument("--json", default=str(REPO / "build" / "audit"
                                          / "ANALYSIS.json"),
                    help="report path (default build/audit/ANALYSIS.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--seed-violation", choices=sorted(SEEDED),
                    help="register a deliberately violating contract and "
                    "audit it alone (must exit nonzero — analyser "
                    "self-test)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import REGISTRY, load_all
    from repro_torch.kernels import resolve_device
    dev = resolve_device(args.device)
    load_all()

    if args.list:
        for cid in REGISTRY.ids():
            print(cid)
        return 0

    t0 = time.perf_counter()
    if args.seed_violation:
        reports = [audit_seeded(args.seed_violation, device=dev)]
    else:
        reports = audit_ids(args.contract or REGISTRY.ids(), device=dev,
                            run_control=not args.no_control)
    for r in reports:
        print("\n".join(report_lines(r)))

    n_pass = sum(r.passed and not r.skipped for r in reports)
    n_skip = sum(r.skipped for r in reports)
    n_fail = sum(not r.passed for r in reports)
    ok = n_fail == 0
    seconds = time.perf_counter() - t0
    out = {
        "ts": time.time(), "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch_version": torch.__version__, "world": WORLD,
        "seconds": seconds, "passed": ok,
        "n_pass": n_pass, "n_skip": n_skip, "n_fail": n_fail,
        "contracts": [r.to_dict() for r in reports],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)

    print(f"\naudit: {n_pass} passed, {n_skip} skipped, {n_fail} failed "
          f"({seconds:.2f} s on {dev}, torch {torch.__version__}) -> "
          f"{args.json}")
    if args.seed_violation and ok:
        print("SEEDED VIOLATION WAS NOT DETECTED — analyser is blind",
              file=sys.stderr)
        return 2
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
