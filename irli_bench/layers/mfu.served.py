"""mfu.served: the served search's operations a busy second, as a share of
the fp32 peak: the search step's operations for every request served in the
traced sub-window (cost/search_step.py) over the seconds the card was busy
there. The offered rate sets the work a second, so a share of the window
would bound nothing; a share of the busy time bounds the kernels'."""
from irli_bench.peaks import FP32_FLOPS


def read(readings: dict):
    tr = readings.get("trace")
    if not tr or not readings.get("traced_flops") or tr["busy_s"] <= 0:
        return None
    return 100.0 * readings["traced_flops"] / (tr["busy_s"] * FP32_FLOPS)
