"""freq_topc_roofline: FrequentOnes' share of its roofline in the traced
sub-window: the least time for the traced calls' launches (cost/
freq_topc.py: the [Q, R·m·ML] candidates read once, the [Q, topC] ids and
counts written once) over the kernel's traced seconds. Silent when the
kernel did not run one launch a traced call."""
from irli_bench.cost import freq_topc
from irli_bench.peaks import least_seconds


def read(readings: dict):
    tr, calls = readings.get("trace"), readings.get("traced_calls")
    k = (tr or {}).get("kernels", {}).get("freq_topc")
    if not k or not calls or k["launches"] != len(calls):
        return None
    cfg, s = readings["cfg"], readings["cfg"]["search"]
    L, B = cfg["n_labels"], cfg["n_buckets"]
    W = cfg["n_reps"] * s["m"] * int(cfg["max_load_slack"]
                                     * max(1, L // B))
    least = sum(least_seconds(0, freq_topc.cost(c["Q"], W, s["topC"])
                              ["bytes"]) for c in calls)
    return 100.0 * least / k["seconds"]
