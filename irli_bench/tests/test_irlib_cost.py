"""The frozen work counts of ``irli_bench/cost``: the deep1b fused search's
bound, and agreement with the port's own ``ops.cost()`` at each cell's
shapes (the frozen copies must start equal; the port may move later)."""
import pytest

from irli_bench import harness
from irli_bench.cost import freq_topc, irli_topk, mega_query, quant_rerank
from irli_bench.cost import search_step
from irli_bench.peaks import least_seconds

CELLS = ["deep1b-batch", "sift1m-batch", "deep1b-served"]


def shapes(name: str) -> dict:
    """The cell's widths and the batch a search call runs."""
    c = harness.load_cell(name)
    cfg, mix = c["config"], c["traffic"]
    L, B = cfg["n_labels"], cfg["n_buckets"]
    ML = int(cfg["max_load_slack"] * max(1, L // B))
    Q = mix.get("queries_per_call", mix.get("max_batch"))
    return dict(cfg=cfg, s=cfg["search"], R=cfg["n_reps"], d=cfg["d"],
                H=cfg["d_hidden"], B=B, L=L, ML=ML, Q=Q)


def test_mega_query_bound_at_deep1b_widths():
    """1.349e12 operations at Q = 1024 over 67 TFLOP/s: 20.13 ms,
    bound by operations."""
    w = mega_query.cost(32, 1024, 96, 1024, 20000, 200, 2_000_000, m=5,
                        topC=1024, refine_k=0, k=10)
    ms = 1e3 * least_seconds(w["flops"], w["bytes"])
    assert ms == pytest.approx(20.13, abs=0.005)
    assert w["flops"] / 67e12 > w["bytes"] / 3.35e12


@pytest.mark.parametrize("name", CELLS)
def test_mega_query_matches_the_port(name):
    from repro_torch.kernels.mega_query import ops
    x = shapes(name)
    s = x["s"]
    for kw in ({}, dict(valid=12345, refine=678, buckets=910,
                        code_rows=1112, refine_rows=1314)):
        args = (x["R"], x["Q"], x["d"], x["H"], x["B"], x["ML"], x["L"])
        opts = dict(m=s["m"], topC=s["topC"], refine_k=s["refine_k"],
                    k=s["k"], block=x["cfg"]["store_block"], **kw)
        assert mega_query.cost(*args, **opts) == ops.cost(*args, **opts)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("lse", [False, True])
def test_irli_topk_matches_the_port(name, lse):
    from repro_torch.kernels.irli_topk import ops
    x = shapes(name)
    for Q, m in ((x["Q"], x["s"]["m"]), (1, 10), (8, x["s"]["m"])):
        args = (x["R"], Q, x["H"], x["B"], m)
        assert irli_topk.cost(*args, lse=lse) == ops.cost(*args, lse=lse)


@pytest.mark.parametrize("name", CELLS)
def test_freq_topc_matches_the_port(name):
    from repro_torch.kernels.freq_topc import ops
    x = shapes(name)
    C0 = x["R"] * x["s"]["m"] * x["ML"]
    assert freq_topc.cost(x["Q"], C0, x["s"]["topC"]) == ops.cost(
        x["Q"], C0, x["s"]["topC"])


@pytest.mark.parametrize("name", CELLS)
def test_quant_rerank_matches_the_port(name):
    from repro_torch.kernels.quant_rerank import ops
    x = shapes(name)
    s = x["s"]
    kp = search_step.refine_depth(s["k"], s["topC"], s["refine_k"])
    nb = x["d"] // x["cfg"]["store_block"]
    for kw in ({}, dict(valid=4321, rows=1234)):
        args = (x["Q"], s["topC"], x["d"], kp, x["L"])
        assert quant_rerank.cost(*args, n_blocks=nb, **kw) == ops.cost(
            *args, n_blocks=nb, **kw)


def test_search_step_is_the_fused_kernels_operations():
    """The whole step's operations equal the fused kernel's at the same
    valid and refined counts: they count the same algorithm."""
    cfg = shapes("deep1b-batch")["cfg"]
    step = search_step.flops(cfg, 4096, m=5, valid=3_000_000,
                             refined=150_000)
    fused = mega_query.cost(32, 4096, 96, 1024, 20000, 200, 2_000_000, m=5,
                            topC=1024, refine_k=0, k=10, valid=3_000_000,
                            refine=150_000)
    assert step == fused["flops"]


def test_refined_counts_min_of_depth_and_candidates():
    assert search_step.refine_depth(10, 1024) == 40
    assert search_step.refine_depth(10, 20, 0) == 20
    assert search_step.refined([0, 5, 40, 1000], 10, 1024) == 0 + 5 + 40 + 40
