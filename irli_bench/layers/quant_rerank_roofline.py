"""quant_rerank_roofline: the coarse int8 rerank's share of its roofline in
the traced sub-window: the least time for the traced calls' launches
(cost/quant_rerank.py with the valid slots and the distinct rows they name,
as the reference counts them) over the kernel's traced seconds. Silent
when the kernel did not run one launch a traced call."""
from irli_bench.cost import quant_rerank
from irli_bench.cost.search_step import refine_depth
from irli_bench.peaks import least_seconds


def read(readings: dict):
    tr, calls = readings.get("trace"), readings.get("traced_calls")
    k = (tr or {}).get("kernels", {}).get("quant_rerank")
    if not k or not calls or k["launches"] != len(calls):
        return None
    cfg, s = readings["cfg"], readings["cfg"]["search"]
    D, blk = cfg["d"], cfg["store_block"]
    kp = refine_depth(s["k"], s["topC"], s.get("refine_k", 0))
    least = 0.0
    for c in calls:
        w = quant_rerank.cost(c["Q"], s["topC"], D, kp, cfg["n_labels"],
                              n_blocks=D // blk, valid=c["valid"],
                              rows=c["rows"])
        least += least_seconds(w["flops"], w["bytes"])
    return 100.0 * least / k["seconds"]
