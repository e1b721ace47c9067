"""irli_topk_roofline.served: the scorer GEMM + top-m kernel's share of its
roofline in the served cell's traced sub-window. Each batch launches it
twice on the batch's padded rows, once for the probe counter and once for
the compact path's top-m: the harness's span around ``IRLIIndex.search``
gives each batch's rows. The least time of those launches
(cost/irli_topk.py) over the kernel's traced seconds; where the traced
launches and the spans' differ by a batch across the window's edge, the
mean least time a span's launch stands for each traced one. Silent past
``trace_launch_slack``."""
from irli_bench.cost import irli_topk
from irli_bench.peaks import least_seconds


def read(readings: dict):
    tr, rows = readings.get("trace"), readings.get("served_calls")
    k = (tr or {}).get("kernels", {}).get("irli_topk")
    if not k or not rows:
        return None
    if abs(2 * len(rows) - k["launches"]) > \
            readings["traffic"]["trace_launch_slack"]:
        return None
    cfg = readings["cfg"]
    least = [least_seconds(**dict(zip(("flops", "nbytes"), irli_topk.cost(
        cfg["n_reps"], n, cfg["d_hidden"], cfg["n_buckets"],
        cfg["search"]["m"]).values()))) for n in rows]
    return 100.0 * sum(least) / len(least) * k["launches"] / k["seconds"]
