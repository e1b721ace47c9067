"""Run one cell of the benchmark once and print its result line.

    python irli_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with a non-zero code, and prints no result, when the port
(``src/repro_torch``) is not in the checkout, when no CUDA card (or fewer
than the cell asks for) is present,
or when the process holds JAX or the JAX package once the window has
closed. The last line of standard output is the JSON result; the last
lines of standard error are the numbers that decided ``correct``, each
beside its limit.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(_BENCH.parent), str(_BENCH.parent / "src")]
# every build cache inside the checkout, at a fixed path, so that only a
# cell's first run in a checkout builds (the port's own nvcc builds go to
# build/kernels beside these)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(_BENCH.parent / "build" / _sub)

from irli_bench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            started: float) -> tuple[dict, list]:
    """Run the cell's traffic generator and read its metrics -> (result line,
    check lines)."""
    import torch

    from irli_bench import check

    out = harness.generator(cell).run(cell, seed, seconds, trace, device,
                                   started)
    correct, numbers = check.verdict(out["numbers"], cell["check"],
                                     out["missing"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_for(cell["name"], kind):
        v = harness.read_metric(kind, m["name"], out["readings"])
        if v is None and kind == "end_to_end":
            raise RuntimeError(f"{cell['name']} reports {m['name']}, and its "
                               f"reader found nothing to read")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.get("chips", 1),
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if trace and out["trace"] is not None:
        tr = out["trace"]
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["check"] = numbers
    split = ", ".join(f"{k} {v:.3f} s" for k, v in out["setup_split"].items())
    setup_s = out["readings"]["setup_s"]
    return result, [f"irli_bench: set-up {setup_s:.3f} s: {split}"] \
        + harness.check_lines(numbers)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown (nvidia-smi failed)"


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    try:
        harness.require_port()
        harness.require_card(cell.get("chips", 1))
    except harness.CannotRun as e:
        print(f"irli_bench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.cuda.set_device(0)
    print(f"irli_bench: {args.workload} seed {args.seed} on "
          f"{power_limit()}; peaks: fp32 67 TFLOP/s, HBM 3.35 TB/s",
          file=sys.stderr)
    result, lines = execute(cell, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            STARTED)
    held = harness.forbidden_loaded()
    if held:
        print(f"irli_bench: the process holds {held}: the benchmark runs "
              f"the port alone", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
