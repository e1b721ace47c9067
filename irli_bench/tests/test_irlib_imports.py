"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, by top-level module name compared whole (``repro_torch`` is the
port and may load; ``repro`` may not)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from irli_bench import harness

BENCH = Path(__file__).resolve().parents[1]


def imported_roots(path: Path) -> set:
    """The top-level names a module imports, anywhere in its body."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(imported_roots(f)
                                             & set(harness.FORBIDDEN))
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_probe", object())
    assert "repro_torch_fake_probe" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.fake_probe", object())
    assert "repro" in harness.forbidden_loaded()


DRY_PASS = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import torch
import tiny
from irli_bench import harness, run
for name in tiny.TRAFFIC:
    run.execute(tiny.cell(name), 2**31 + 3, 0.3, False, torch.device("cpu"),
                time.perf_counter())
print(json.dumps(harness.forbidden_loaded()))
"""


def test_a_dry_pass_of_every_cell_loads_no_jax():
    """Each cell's set-up, window and check, run on the CPU at the tiny
    size in a fresh process, leave no JAX module in ``sys.modules``."""
    root = BENCH.parent
    code = DRY_PASS.format(root=str(root), src=str(root / "src"),
                           tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
