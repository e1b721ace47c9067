"""The reference's records of the 20 CTR and SchNet dry-run cells and the
checks that tests/test_torch_dryrun_ctr_single.py and _multi.py hold the
port's records to (one file a mesh, so that ``--dist loadfile`` runs the
two meshes' subprocesses on two workers).

The reference's per-device argument bytes come from ``python -m
repro.launch.dryrun --mesh {single,multi} --arch <arch>`` (jax 0.9.0, CPU).
``jax.jit`` drops an argument its step never reads (``keep_unused=False``),
so the CTR serve cells' reference figures lack the unused ``label``, which
the port's step is given and holds: rank 0's label bytes are added. The
reference computes the whole global batch on every device, so its FLOPs
and temporaries are not the port's; the port's records are held instead
to ``replication`` (FLOPs x world size over the same step's FLOPs on the
whole arguments on one device) within its bound by the specs, and to a
peak under one card's 80 GB.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

#: the reference's per-device argument bytes: (single, multi)
REF_ARGS = {
    "dlrm-mlperf/train_batch": (1_236_425_936, 1_236_098_256),
    "dlrm-mlperf/serve_p99": (417_850_756, 417_848_260),
    "dlrm-mlperf/serve_bulk": (418_005_508, 417_925_636),
    "dlrm-mlperf/retrieval_cand": (2_097_664, 2_097_664),
    "dien/train_batch": (15_931_252, 13_449_076),
    "dien/serve_p99": (8_271_688, 8_252_360),
    "dien/serve_bulk": (9_470_024, 8_851_528),
    "dien/retrieval_cand": (589_968, 589_968),
    "bst/train_batch": (23_758_576, 23_512_816),
    "bst/serve_p99": (19_811_716, 19_809_860),
    "bst/serve_bulk": (19_926_788, 19_867_396),
    "bst/retrieval_cand": (524_416, 524_416),
    "xdeepfm/train_batch": (64_266_596, 63_938_916),
    "xdeepfm/serve_p99": (22_001_736, 21_999_240),
    "xdeepfm/serve_bulk": (22_156_488, 22_076_616),
    "xdeepfm/retrieval_cand": (163_880, 163_880),
    "schnet/full_graph_sm": (18_670_876, 18_670_876),
    "schnet/minibatch_lg": (2_285_408, 1_479_336),
    "schnet/ogb_products": (7_333_336, 3_931_480),
    "schnet/molecule": (523_184, 522_928),
}
#: rank 0's unused label of a CTR serve cell: 32 / 16 rows (p99), 1,024 /
#: 512 rows (bulk) of fp32
LABEL_BYTES = {"serve_p99": (128, 64), "serve_bulk": (4096, 2048)}
MESHES = ("single", "multi")
WORLD = {"single": 256, "multi": 512}
CARD_BYTES = 80e9

ROOT = Path(__file__).resolve().parents[1]


def want_args(cell: str, mesh: str) -> int:
    shape = cell.split("/")[1]
    i = MESHES.index(mesh)
    label = LABEL_BYTES[shape][i] if shape in LABEL_BYTES else 0
    return REF_ARGS[cell][i] + label


def want_launches(cell: str) -> dict:
    arch, shape = cell.split("/")
    if shape == "retrieval_cand":
        return {"distance_topk": 1}
    if arch == "dien" and shape.startswith("serve"):
        return {"embedding_bag": 2}       # the item and category history
    return {}


def want_replication(cell: str, mesh: str) -> float:
    """What the specs imply: a CTR train_batch and serve_p99 cell's rows
    split over the data axes and whole over "model" (16 ranks do each
    row); serve_bulk and SchNet's split cells over every axis (1); the
    retrieval table split over ("data", "model") and whole over "pod" (1,
    2 on the multi mesh); full_graph_sm whole on every rank."""
    shape = cell.split("/")[1]
    if shape in ("train_batch", "serve_p99"):
        return 16.0
    if shape == "retrieval_cand":
        return 1.0 if mesh == "single" else 2.0
    if shape == "full_graph_sm":
        return float(WORLD[mesh])
    return 1.0


def records(tmp, mesh: str) -> dict:
    """The 20 cells' records of ``mesh`` from a subprocess of their own
    (``torch_dryrun_ranks.ctr_dryrun``: a process holds one process
    group); raises unless every call exited 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    call = f"import torch_dryrun_ranks as T; T.ctr_dryrun({str(tmp)!r}, " \
           f"{mesh!r})"
    proc = subprocess.run([sys.executable, "-c", call], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert json.loads((Path(tmp) / "ctr_rc.json").read_text()) == [0] * 5
    return json.loads((Path(tmp) / f"ctr_{mesh}.json").read_text())


def check(rec: dict, cell: str, mesh: str) -> None:
    """One record against the reference's argument bytes (plus the unused
    label), its launches, the card's memory and its replication bound."""
    assert rec["status"] == "ok", rec.get("error")
    assert rec["world_size"] == WORLD[mesh]
    assert rec["argument_bytes"] == want_args(cell, mesh)
    assert rec["argument_bytes_by_specs"] == rec["argument_bytes"]
    assert rec["launches"] == want_launches(cell)
    assert 0 < rec["peak_bytes"] < CARD_BYTES
    rep = want_replication(cell, mesh)
    assert 0.999 * rep <= rec["replication"] <= 1.02 * rep, (
        rec["replication"], rep)
    assert rec["global_flops"] > 0 and rec["collective_count"] > 0
