"""search_mfu: the whole search step's share of the fp32 peak over the
measured window: the operations the algorithm needs for every query the
window completed (cost/search_step.py) over the window's seconds at
67 TFLOP/s."""
from irli_bench.peaks import FP32_FLOPS


def read(readings: dict):
    if not readings.get("step_flops"):
        return None
    return 100.0 * readings["step_flops"] / (readings["window_s"] * FP32_FLOPS)
