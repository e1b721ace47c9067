"""The reference's records of the dry run's 12 LM serve cells and the
checks that tests/test_torch_dryrun_lm_serve_*.py hold the port's records
to (the decode cells one file a mesh, the prefill cells a file of their
own, so that ``--dist loadfile`` spreads the subprocesses over workers).

The reference's per-device argument bytes of the three dense decode_32k
cells come from ``python -m repro.launch.dryrun --mesh {single,multi}
--arch <arch> --shape decode_32k`` (jax 0.9.0, CPU): params + the caches
over the world size + the rank's token and pos rows. Its other nine serve
cells do not record under jax 0.9.0; theirs are held to rank 0's shards
summed independently of the recorder (``torch_dryrun_ranks.
lm_serve_dryrun``). The reference computes the whole global batch on
every device and returns its caches as copies, so its FLOPs and
temporaries are not the port's: the port's records are held instead to
``replication`` (FLOPs x world size over the same step's FLOPs on the
whole arguments on one device), to temporaries below half the rank's
cache bytes for the dense decode cells (the caches written in place, the
embedding table never gathered whole) and to a peak under one card's 80
GB.

The decode and long_500k cells run at full size. The MoE prefill cells
run cut (their trace at full size takes minutes): the sequence to
``CUT_SEQ`` (above the MoE's ``ffn_chunk`` of tokens, so the per-row
dispatch in sequence chunks still runs) and the depth to ``CUT_LAYERS``;
the CLI records their full size (PERF.md).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

LMS = ("gemma-7b", "yi-6b", "qwen3-4b", "mixtral-8x7b",
       "llama4-maverick-400b-a17b")
DECODE_CELLS = tuple(f"{a}/decode_32k" for a in LMS) + (
    "mixtral-8x7b/long_500k", "llama4-maverick-400b-a17b/long_500k")
PREFILL_CELLS = tuple(f"{a}/prefill_32k" for a in LMS)
DENSE = ("gemma-7b", "yi-6b", "qwen3-4b")
#: the MoE prefill cells' cut: [32, CUT_SEQ] tokens, CUT_LAYERS layers
CUT_SEQ = 4096
CUT_LAYERS = {"mixtral-8x7b": 2, "llama4-maverick-400b-a17b": 4}
#: the reference's per-device argument bytes: (single, multi)
REF_ARGS = {
    "gemma-7b/decode_32k": (8_583_731_264, 4_825_634_848),
    "yi-6b/decode_32k": (1_831_870_528, 1_294_999_584),
    "qwen3-4b/decode_32k": (2_919_095_360, 1_711_135_776),
}
#: half of rank 0's cache bytes at decode_32k: (single, multi)
HALF_CACHE = {
    "gemma-7b/decode_32k": (3_758_096_384, 1_879_048_192),
    "yi-6b/decode_32k": (536_870_912, 268_435_456),
    "qwen3-4b/decode_32k": (1_207_959_552, 603_979_776),
}
MESHES = ("single", "multi")
WORLD = {"single": 256, "multi": 512}
CARD_BYTES = 80e9

ROOT = Path(__file__).resolve().parents[1]


def records(tmp, mesh: str, group: str) -> dict:
    """The records of ``group`` ("decode" or "prefill") on ``mesh`` from a
    subprocess of its own (``torch_dryrun_ranks.lm_serve_dryrun``: a
    process holds one process group) -> {"records", "want", "launches",
    "rcs"}; raises unless every CLI call exited 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    call = f"import torch_dryrun_ranks as T; T.lm_serve_dryrun(" \
           f"{str(tmp)!r}, {mesh!r}, {group!r})"
    proc = subprocess.run([sys.executable, "-c", call], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads((Path(tmp) / f"lm_{group}_{mesh}.json").read_text())
    assert all(rc == 0 for rc in out["rcs"]), out["rcs"]
    return out


def check(out: dict, cell: str, mesh: str) -> None:
    """One record against the reference's argument bytes (the dense
    decode cells) or the independent shard sum, its launches, host reads,
    the card's memory, its replication and, for the dense decode cells,
    its temporaries."""
    rec = out["records"][cell]
    arch, shape = cell.split("/")
    i = MESHES.index(mesh)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["world_size"] == WORLD[mesh]
    assert rec["argument_bytes"] == rec["argument_bytes_by_specs"] \
        == out["want"][cell]
    if cell in REF_ARGS:
        assert rec["argument_bytes"] == REF_ARGS[cell][i]
        assert rec["temp_bytes"] < HALF_CACHE[cell][i]
    want = out["launches"][cell]
    assert rec["launches"] == ({"flash_attention": want} if want else {})
    if arch in DENSE:
        assert rec["host_reads"] == {}
    else:
        assert set(rec["host_reads"]) <= {"core/topk.py:topk_stable"}
    assert 0 < rec["peak_bytes"] < CARD_BYTES
    assert rec["replication"] >= 0.999, rec["replication"]
    if arch in DENSE:
        assert rec["replication"] <= 1.10, rec["replication"]
    assert rec["global_flops"] > 0 and rec["collective_count"] > 0
