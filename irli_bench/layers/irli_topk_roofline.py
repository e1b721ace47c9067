"""irli_topk_roofline: the scorer's output GEMM and top-m kernel's share of
its roofline in a closed loop's traced sub-window: the least time for the
traced calls' launches (cost/irli_topk.py at each call's rows) over the
kernel's traced seconds. Silent when the kernel did not run one launch a
traced call (the fused kernel served them)."""
from irli_bench.cost import irli_topk
from irli_bench.peaks import least_seconds


def read(readings: dict):
    tr, calls = readings.get("trace"), readings.get("traced_calls")
    k = (tr or {}).get("kernels", {}).get("irli_topk")
    if not k or not calls or k["launches"] != len(calls):
        return None
    cfg = readings["cfg"]
    least = sum(least_seconds(**dict(zip(("flops", "nbytes"), irli_topk.cost(
        cfg["n_reps"], c["Q"], cfg["d_hidden"], cfg["n_buckets"],
        cfg["search"]["m"]).values()))) for c in calls)
    return 100.0 * least / k["seconds"]
