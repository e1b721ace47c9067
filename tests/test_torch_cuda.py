"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a card, as CUDA kernels have no
CPU mode. This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.freq_topc import ops as fops  # noqa: E402
from repro_torch.kernels.freq_topc.ref import freq_topc_ref  # noqa: E402
from repro_torch.kernels.irli_topk import ops as iops  # noqa: E402
from repro_torch.kernels.irli_topk.ref import (  # noqa: E402
    irli_topk_ref, near, same_topm)
from repro_torch.kernels.mega_query import ops as mops  # noqa: E402
from repro_torch.kernels.mega_query.ref import mega_search_ref  # noqa: E402
from repro_torch.kernels.quant_rerank import ops as qops  # noqa: E402
from repro_torch.kernels.quant_rerank.ref import (  # noqa: E402
    quant_rerank_ref, same_topk)
from repro_torch.store.quantized import encode  # noqa: E402

pytestmark = pytest.mark.cuda

FREQ_CASES = [
    (8, 96, 40, 16),      # fewer values than slots: heavy duplication
    (7, 120, 500, 64),    # mostly-distinct
    (4, 100, 30, 160),    # C > C0: output right-padded
]
QUANT_CASES = [
    (8, 200, 32, 24, 8, 16),
    (7, 500, 48, 40, 12, 16),
    (4, 100, 16, 12, 20, 8),      # k > C: clamped to C
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cands(Q, C0, V):
    rng = np.random.default_rng(Q + C0)
    cands = rng.integers(-1, V, (Q, C0)).astype(np.int32)
    cands[0, : C0 // 2] = -1                     # heavily padded row
    cands[-1] = -1                               # zero-candidate row
    return cands


def _quant_inputs(Q, L, D, C, blk, dtype, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(L, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    cid = rng.integers(-1, L, (Q, C)).astype(np.int32)
    cnt = rng.integers(0, 4, (Q, C)).astype(np.float32)
    cid[-1] = -1                                  # an all-invalid row
    return queries, cid, cnt, encode(torch.from_numpy(base), dtype, blk)


@pytest.mark.parametrize("Q,C0,V,C", FREQ_CASES + [
    (3, 32000, 20000, 1024),    # the main path's row width
    (2, 1000, 1, 8),            # one id repeated: a single run
    (2, 777, 5000, 1024),       # C > distinct ids; width not a power of two
])
def test_freq_topc_kernel_matches_plain_exactly(card, Q, C0, V, C):
    cands = torch.from_numpy(_cands(Q, C0, V)).to(card)
    reset_launches()
    ids, cnt = fops.frequent_topc(cands, C=C)
    torch.cuda.synchronize()
    assert LAUNCHES["freq_topc"] == 1
    rids, rcnt = freq_topc_ref(cands, C=C)
    assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)


def test_freq_topc_raises_on_rows_wider_than_the_kernel(card):
    """A row past MAX_WIDTH raises on the card: no plain version there."""
    cands = torch.zeros((1, fops.MAX_WIDTH + 1), dtype=torch.int32,
                        device=card)
    reset_launches()
    with pytest.raises(ValueError, match="wide-row"):
        fops.frequent_topc(cands, C=8)
    assert LAUNCHES["freq_topc"] == 0


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["angular", "l2"])
@pytest.mark.parametrize("Q,L,D,C,k,blk", QUANT_CASES + [
    (16, 5000, 96, 1024, 40, 32)])               # the main path's shape
def test_quant_rerank_kernel_matches_plain(card, Q, L, D, C, k, blk, metric,
                                           dtype):
    """Scores to 1e-5 position by position; the same ids as the plain
    version except where its k'-th and (k'+1)-th scores lie within that
    tolerance (ref.same_topk: the fp32 sums run in another order)."""
    queries, cid, cnt, tstore = _quant_inputs(Q, L, D, C, blk, dtype, 1)
    args = [torch.from_numpy(a).to(card) for a in (queries, cid, cnt)]
    codes = tstore.codes.to(card)
    scales = None if tstore.scales is None else tstore.scales.to(card)
    reset_launches()
    ids, vals = qops.quant_coarse_topk(args[0], codes, scales, args[1],
                                       args[2], tau=2, k=k, metric=metric)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_rerank"] == 1
    kp = min(k, C)
    rids, rvals = quant_rerank_ref(args[0], codes, scales, args[1], args[2],
                                   tau=2, k=kp, metric=metric)
    _, wide = quant_rerank_ref(args[0], codes, scales, args[1], args[2],
                               tau=2, k=min(kp + 1, C), metric=metric)
    flagged = same_topk(ids, rids, vals, rvals, wide)
    assert flagged <= max(1, Q // 8)


def test_quant_rerank_raises_past_shared_memory(card):
    """topC = 16385 needs 32768 int64 sort keys, past one block's shared
    memory: the wrapper raises before the launch."""
    queries, cid, cnt, tstore = _quant_inputs(2, 100, 96, 16385, 32, "int8",
                                              2)
    args = [torch.from_numpy(a).to(card) for a in (queries, cid, cnt)]
    with pytest.raises(ValueError, match="topC=16385"):
        qops.quant_coarse_topk(args[0], tstore.codes.to(card),
                               tstore.scales.to(card), args[1], args[2],
                               tau=1, k=40)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,Q,H,B,m", [
    (1, 64, 64, 512, 5),
    (3, 130, 96, 1000, 10),      # ragged Q and B: a partial tile of each
    (2, 7, 33, 129, 3),          # H not a multiple of the slice depth
    (1, 5, 16, 64, 64),          # m = B = the lists' width
])
def test_irli_topk_kernel_matches_plain(card, G, Q, H, B, m, dtype):
    """Values and lse to 1e-5; ids equal outside near ties at the m cut
    (ref.same_topm: the fp32 sums run in another order)."""
    rng = np.random.default_rng(G + Q + B)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        card, getattr(torch, dtype)) for s in ((G, Q, H), (G, H, B), (G, B))]
    reset_launches()
    vals, idx, lse = iops.scorer_topk(*args, m=m, lse=True)
    torch.cuda.synchronize()
    assert LAUNCHES["irli_topk"] == 1
    wide_v, wide_i, ref_lse = irli_topk_ref(*args, m=min(m + 1, B), lse=True)
    cut, _ = same_topm(vals, idx, wide_v, wide_i)
    assert cut <= max(1, G * Q // 16)
    assert bool(near(lse, ref_lse, 1e-5).all())
    v1, i1 = iops.scorer_topk(args[0][0], args[1][0], args[2][0], m=m)
    assert torch.equal(v1, vals[0]) and torch.equal(i1, idx[0])


def _mega_inputs(card, dtype, *, exact, Q=70, L=3000, D=32, R=3, B=48,
                 H=80, seed=0):
    """A random index: members from a random assignment, max_load 2L/B."""
    from repro_torch.core.partition import build_inverted_index
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(card)
    params = {"w1": t(rng.normal(size=(R, D, H)) / D ** 0.5),
              "b1": t(rng.normal(size=(R, H)) * 0.1),
              "w2": t(rng.normal(size=(R, H, B)) / H ** 0.5),
              "b2": t(rng.normal(size=(R, B)) * 0.1)}
    assign = torch.from_numpy(rng.integers(0, B, (R, L)).astype(np.int32))
    members = build_inverted_index(assign, B, 2 * L // B).members.to(card)
    base = t(rng.normal(size=(L, D)))
    queries = base[torch.from_numpy(rng.integers(0, L, Q)).to(card)]
    queries = queries + 0.1 * t(rng.normal(size=(Q, D)))
    store = base if dtype == "fp32" else encode(base, dtype, 8,
                                                keep_exact=exact)
    return params, members, store, queries


@pytest.mark.parametrize("dtype,metric,adaptive,exact", [
    ("fp32", "angular", False, False),
    ("fp32", "l2", True, False),
    ("int8", "angular", False, True),
    ("int8", "l2", True, False),
    ("bf16", "angular", True, False),
    ("bf16", "l2", False, True),
])
def test_mega_kernel_matches_plain(card, dtype, metric, adaptive, exact):
    """One launch and no other kernel of the port; ids and n_candidates
    equal the plain compact sequence's outside near ties, scores to 1e-5.
    topC = 64 < W cuts the FrequentOnes top-C, k = 80 > C pads."""
    from repro_torch.core.query import QueryPipeline
    params, members, store, queries = _mega_inputs(card, dtype, exact=exact)
    kw = dict(m=4, tau=1, topC=64, k=10, metric=metric, adaptive_m=adaptive,
              probe_mass=0.7 if adaptive else 1.0,
              refine_k=0 if dtype == "fp32" else 16)
    for k in (10, 80):
        pipe = QueryPipeline(mode="mega", store_dtype=dtype,
                             **dict(kw, k=k))
        reset_launches()
        ids, scores, nc = pipe.search(params, members, store, queries)
        torch.cuda.synchronize()
        assert {n for n, c in LAUNCHES.items() if c} == {"mega_query"}
        assert LAUNCHES["mega_query"] == 1
        rids, rscores, rnc = mega_search_ref(params, members, store, queries,
                                             **dict(kw, k=k))
        assert ids.shape == (queries.shape[0], k)
        # the plain fp32 rerank stops at C = 64 columns; the kernel pads
        assert bool((ids[:, rids.shape[1]:] == -1).all())
        assert bool((scores[:, rids.shape[1]:] == -torch.inf).all())
        ids, scores = ids[:, :rids.shape[1]], scores[:, :rids.shape[1]]
        agree = (ids == rids).all(dim=1) & (nc == rnc)
        assert int((~agree).sum()) <= max(1, queries.shape[0] // 20)
        torch.testing.assert_close(scores[agree], rscores[agree], rtol=1e-5,
                                   atol=1e-5)


def test_mega_falls_back_to_compact_on_streaming_state(card):
    """Delta/tombstone state is served by the compact pipeline's kernels,
    decided before any launch."""
    from repro_torch.core.query import QueryPipeline
    params, members, store, queries = _mega_inputs(card, "int8", exact=True)
    tomb = torch.zeros(store.n_rows, dtype=torch.bool, device=card)
    tomb[::7] = True
    pipe = QueryPipeline(mode="mega", m=4, tau=1, topC=64, k=10,
                         store_dtype="int8", refine_k=16)
    reset_launches()
    ids, _, _ = pipe.search(params, members, store, queries, tombstone=tomb)
    torch.cuda.synchronize()
    assert LAUNCHES["mega_query"] == 0
    assert LAUNCHES["irli_topk"] == LAUNCHES["freq_topc"] == 1
    assert not bool(tomb[ids.clamp_min(0).long()][ids >= 0].any())


def test_mega_query_raises_past_its_footprint(card):
    params, members, store, queries = _mega_inputs(card, "int8", exact=True)
    with pytest.raises(ValueError, match="mega_fits"):
        mops.mega_query(params, members, store.codes, store.scales,
                        store.exact, queries, m=40, tau=1, topC=64, k=10)
