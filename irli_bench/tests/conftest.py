"""The benchmark's own CPU tests: ``python -m pytest -q irli_bench/tests``
from the checkout's root. The port (``src/``) and the benchmark import by
their top-level names."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
