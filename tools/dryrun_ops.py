#!/usr/bin/env python3
"""One dry-run cell's mesh step, op by op: every collective and every op
the cost model bills FLOPs for, with its local operand shapes and the
port's calling line, written to a JSON file; or two such files compared.
Two torch versions (a CPU host's and the card machine's) that record a
cell differently show where they differ.

    PYTHONPATH=src python3 tools/dryrun_ops.py record mixtral-8x7b \\
        long_500k ops_a.json [--mesh single]
    python3 tools/dryrun_ops.py diff ops_a.json ops_b.json

``record`` prints the torch version, the record's FLOPs and collective
count; ``diff`` prints each (op, shapes) whose count differs.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def record(arch: str, shape: str, out: str, mesh_kind: str) -> dict:
    import torch

    from repro_torch.analysis import cost, trace
    from repro_torch.analysis.collectives import is_collective
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_production_mesh
    log = []
    orig = cost.CostRecorder._bill

    def site():
        for f in reversed(traceback.extract_stack()[:-3]):
            if "repro_torch" in f.filename and "analysis" not in f.filename:
                return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
        return "?"

    def bill(self, func, args, kwargs, o):
        if not (self._dtensors and trace.in_sharding_propagation()) \
                and self._kernel_depth == 0:
            name = str(func)
            if is_collective(func.namespace, name) or \
                    func._overloadpacket in cost._flop_registry():
                log.append([name, [list(a.shape) for a in args
                                   if isinstance(a, torch.Tensor)], site()])
        return orig(self, func, args, kwargs, o)

    # the recorder's stack walk (trace.in_sharding_propagation) stops at
    # the first frame outside torch and the recorders: pass as one of them
    bill.__code__ = bill.__code__.replace(co_filename=cost.__file__)
    cost.CostRecorder._bill = bill
    DR.fake_world(DR.WORLD[mesh_kind])
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type="cuda")
    step, make_args, _ = DR.lower_cell(get_arch(arch), shape, mesh)
    rec = DR.dry_record(step, make_args)
    with open(out, "w") as f:
        json.dump({"torch": torch.__version__, "record": rec, "ops": log}, f)
    print(torch.__version__, rec["flops"], rec["collective_count"], len(log))
    return rec


def diff(a: str, b: str) -> list:
    """(count in a, count in b, (op, shapes)) of each op whose counts
    differ, the calling lines ignored."""
    ca, cb = (collections.Counter((op, json.dumps(sh)) for op, sh, _ in
                                  json.load(open(p))["ops"]) for p in (a, b))
    rows = [(ca[k], cb[k], k) for k in sorted(set(ca) | set(cb))
            if ca[k] != cb[k]]
    for r in rows:
        print(*r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record")
    r.add_argument("arch")
    r.add_argument("shape")
    r.add_argument("out")
    r.add_argument("--mesh", choices=["single", "multi"], default="single")
    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "record":
        record(args.arch, args.shape, args.out, args.mesh)
        return 0
    return 1 if diff(args.a, args.b) else 0


if __name__ == "__main__":
    sys.exit(main())
