"""The harness is driven by its files: every configuration, cell and mix
parses and names what exists; a cell dropped into a copy is found and run
without a code edit; a run without the port or a card fails and prints no
result."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import tiny
from irli_bench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def json_files(sub: str) -> list:
    return sorted((BENCH / sub).glob("*.json"))


@pytest.mark.parametrize("sub", ["configs", "workloads", "traffic"])
def test_every_file_parses(sub):
    files = json_files(sub)
    assert files
    for f in files:
        assert isinstance(json.loads(f.read_text()), dict), f


def test_every_cell_names_what_exists():
    bench = harness.benchmark()
    assert [w["name"] for w in bench["workloads"]] == [
        "deep1b-batch", "sift1m-batch", "deep1b-served"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (BENCH / "traffic" / f"{cell['traffic']['generator']}.py"
                ).exists()
        assert set(cell["check"]) >= {"mismatch", "score_gap"}
        assert harness.metrics_for(w["name"], "end_to_end")
        assert harness.metrics_for(w["name"], "per_layer")
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for kind in harness.READERS:
        for m in bench[kind]:
            assert harness.reader(kind, m["name"]).exists(), m["name"]


def test_a_dropped_cell_is_found_without_a_code_edit(tmp_path):
    """A new cell is a workload file and a traffic file in a copy of the
    benchmark; the copy's harness finds, loads and runs it."""
    shutil.copytree(BENCH, tmp_path / "irli_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "irli_bench"
    (bench / "traffic" / "closed_q64.json").write_text(json.dumps(
        {"generator": "closed", "queries_per_call": 64, "warm_calls": 1,
         "trace_calls": 1, "check_calls": 1}))
    (bench / "workloads" / "sift1m-small.json").write_text(json.dumps(
        {"config": "irli-sift1m", "traffic": "closed_q64", "chips": 1,
         "check": {"mismatch": 0.0, "score_gap": 1e-5}}))
    cell = harness.load_cell("sift1m-small", bench=bench)
    assert cell["traffic"]["queries_per_call"] == 64
    cell["config"].update(tiny.CONFIG)
    cell["config"]["data"].update(n_queries=500, n_clusters=30)
    out = harness.generator(cell, bench=bench).run(
        cell, 2**31 + 9, 0.2, False, torch.device("cpu"),
        time.perf_counter())
    assert out["attempted"] >= 64 and out["numbers"]["mismatch"] == 0.0
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no-such-cell", bench=bench)


def run_cli(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "irli_bench/run.py", "--workload", "deep1b-batch",
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_a_run_without_a_card_fails():
    out = run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_a_run_without_the_port_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files."""
    shutil.copytree(BENCH, tmp_path / "irli_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "port" in out.stderr


@pytest.mark.parametrize("seed", [306, 308, 2**31 + 5])
def test_every_seed_gives_the_same_member_width(seed):
    """The hash partition redraws a rep whose fullest bucket would pass
    max_load, so no seed truncates a bucket or widens the stream's rows;
    the same seed draws the same partition."""
    from irli_bench import data
    L, B, R, ML = 200_000, 2_000, 32, 200
    a = data.hash_partition(seed, L, B, R, ML, "cpu")
    assert max(int(torch.bincount(r.long(), minlength=B).max())
               for r in a) <= ML
    assert torch.equal(a, data.hash_partition(seed, L, B, R, ML, "cpu"))


def test_end_to_end_metrics_are_read_from_the_run_s_readings():
    """Each end-to-end metric is its own reader over raw readings: all the
    work over all the time, and a tail over every request, a failed one
    beyond it."""
    closed = {"setup_s": 12.5, "completed": 8192, "window_s": 2.0}
    assert harness.read_metric("end_to_end", "search_qps", closed) == 4096
    assert harness.read_metric("end_to_end", "setup_s", closed) == 12.5
    assert harness.read_metric("end_to_end", "served_p95_ms", closed) is None
    lat = [0.001 * i for i in range(1, 101)]
    served = {"latency_s": lat, "window_s": 20.0, "late_s": 60.0}
    assert harness.read_metric("end_to_end", "served_p95_ms",
                               served) == pytest.approx(95.0)
    assert harness.read_metric("end_to_end", "search_qps", served) is None
    assert harness.reader("end_to_end", "search_qps.sift1m").name == \
        "search_qps.py"
    assert harness.reader("per_layer", "idle_share.served").name == \
        "idle_share.py"
    failed = dict(served, latency_s=lat[:90] + [float("inf")] * 10)
    assert harness.read_metric("end_to_end", "served_p95_ms",
                               failed) == pytest.approx(80e3)
