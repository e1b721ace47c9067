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
