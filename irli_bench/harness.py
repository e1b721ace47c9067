"""Finding a cell's files by name, the run's guards and its result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``,
whose ``generator`` is ``traffic/<generator>.py``). ``BENCHMARK.json`` at the
checkout's root says which metrics the cell reports; each metric is read
from the run's readings by a file of its own (``e2e/<metric>.py``,
``layers/<metric>.py``). Adding a cell, a mix or a metric adds files; no
code here names one.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names the run must never hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CannotRun(RuntimeError):
    """No port to run, no CUDA card, or fewer cards than the cell asks
    for: the run fails."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (names may hold dots,
    as a metric's does)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    return load_json(path) if path.exists() else {}


def load_cell(name: str, bench: Path = BENCH) -> dict:
    """The cell ``name`` with its configuration and traffic mix, each read
    from its own file -> {"name", "chips", "config", "traffic", "check",
    ...}."""
    path = bench / "workloads" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no cell {name!r} ({path} is missing)")
    cell = load_json(path)
    cell["name"] = name
    cell["config_name"] = cell["config"]
    cell["traffic_name"] = cell["traffic"]
    cell["config"] = load_json(bench / "configs" / f"{cell['config']}.json")
    cell["traffic"] = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    for entry in benchmark(bench.parent).get("workloads", []):
        if entry["name"] == name and (
                entry["config"] != cell["config_name"]
                or entry["traffic"] != cell["traffic_name"]):
            raise ValueError(f"BENCHMARK.json and {path} disagree on "
                             f"{name}'s configuration or traffic")
    return cell


def generator(cell: dict, bench: Path = BENCH):
    """The traffic generator module of the cell's mix."""
    kind = cell["traffic"]["generator"]
    return load_module(bench / "traffic" / f"{kind}.py",
                       f"irli_bench_traffic_{kind}")


def metrics_for(cell_name: str, kind: str, root: Path = ROOT) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics (``kind``) that
    BENCHMARK.json gives the cell: those whose ``workloads`` list it, or
    that have no such list."""
    return [m for m in benchmark(root).get(kind, [])
            if cell_name in m.get("workloads", [cell_name])]


#: where each kind of metric's readers live
READERS = {"end_to_end": "e2e", "per_layer": "layers"}


def reader(kind: str, metric: str, bench: Path = BENCH) -> Path:
    """The file that reads ``metric``: ``e2e/<metric>.py`` (end-to-end) or
    ``layers/<metric>.py`` (per-layer); where a metric named for some cells
    (``<quantity>.<cells>``) has no file of its own, the file of the
    quantity, its name with the last dotted part taken off, reads it."""
    sub, name = READERS[kind], metric
    while not (bench / sub / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return bench / sub / f"{name}.py"


def read_metric(kind: str, metric: str, readings: dict, bench: Path = BENCH):
    """The ``end_to_end`` or ``per_layer`` metric ``metric`` from its
    reader over the run's readings; None when it found nothing to read."""
    mod = load_module(reader(kind, metric, bench),
                      f"irli_bench_{READERS[kind]}_"
                      + metric.replace(".", "_"))
    return mod.read(readings)


def require_port() -> None:
    """The port must be in the checkout: the benchmark measures it and
    nothing else."""
    import importlib.util
    if importlib.util.find_spec("repro_torch") is None:
        raise CannotRun("the port (src/repro_torch) is not in this checkout")


def require_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise CannotRun("no CUDA card is available: the benchmark measures the "
                     "card and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise CannotRun(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} are available")


def forbidden_loaded() -> list:
    """The forbidden modules this process holds, by top-level name compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def check_lines(check: dict) -> list:
    """Each compared number beside its limit, one line each."""
    return [f"check {name}: {v['value']!r} (limit {v['limit']!r})"
            for name, v in check.items()]
