"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a card, as CUDA kernels have no
CPU mode. This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import dataclasses

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
from torch_freq_cases import (  # noqa: E402
    FREQ_CASES, FREQ_ROW_NAMES, freq_rows)
from torch_freq_cases import random_rows as _cands  # noqa: E402
from torch_kchoice_cases import candidate_lists  # noqa: E402

pytestmark = pytest.mark.cuda

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


def test_freq_topc_matches_plain_on_rows_wider_than_a_block(card):
    """Rows past one block's 32,768 ids take a thread block cluster of one
    block a 32,768-id chunk: 40,000- and 70,000-wide rows (clusters of 2
    and 3) equal freq_topc_ref bit for bit, one launch each."""
    for C0, V, C in ((40_000, 30_000, 1024), (70_000, 500, 4096)):
        cands = torch.from_numpy(_cands(3, C0, V)).to(card)
        reset_launches()
        ids, cnt = fops.frequent_topc(cands, C=C)
        torch.cuda.synchronize()
        assert LAUNCHES["freq_topc"] == 1
        rids, rcnt = freq_topc_ref(cands, C=C)
        assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)


def _freq_exact(cands, C):
    reset_launches()
    ids, cnt = fops.frequent_topc(cands, C=C)
    torch.cuda.synchronize()
    assert LAUNCHES["freq_topc"] == 1
    rids, rcnt = freq_topc_ref(cands, C=C)
    assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)
    return ids, cnt


@pytest.mark.parametrize("name", FREQ_ROW_NAMES)
def test_freq_topc_kernel_matches_plain_on_every_row(card, name):
    """The widths at the edges of a warp, a block and a cluster, the stream
    cell's 65,280, and the adversarial rows (tests/torch_freq_cases.py):
    bit for bit, one launch each."""
    rows, C = freq_rows()[name]
    _freq_exact(torch.from_numpy(rows).to(card), C)


@pytest.mark.parametrize("C0", [262_144, 262_145, 300_000])
def test_freq_topc_kernel_past_eight_chunks(card, C0):
    """A cluster of 8 blocks holds 262,144 ids; one more takes the wide
    kernel (chunks of 16,384 through global scratch)."""
    rng = np.random.default_rng(C0)
    rows = rng.integers(-1, C0 // 3, (2, C0)).astype(np.int32)
    rows[1, ::5] = 77
    assert fops.radix_plan(C0, C0)["wide"] == int(C0 > 262_144)
    _freq_exact(torch.from_numpy(rows).to(card), 1024)


def test_freq_topc_kernel_reads_an_unaligned_row(card):
    """A row whose start is not 16-byte aligned (a view one int into its
    storage) takes scalar loads; widths not a multiple of 4 do too."""
    rows = _cands(4, 32_000, 9000)
    flat = torch.zeros(rows.size + 1, dtype=torch.int32, device=card)
    flat[1:] = torch.from_numpy(rows.ravel()).to(card)
    cands = flat[1:].view(rows.shape)
    assert cands.is_contiguous() and cands.data_ptr() % 16 != 0
    _freq_exact(cands, 1024)
    _freq_exact(torch.from_numpy(_cands(3, 32_001, 9000)).to(card), 64)


@pytest.mark.parametrize("Q,C0", [(64, 32_000), (16, 65_280),
                                  (2, 300_000)])
def test_freq_topc_two_launches_are_bit_equal(card, Q, C0):
    g = torch.Generator(device=card).manual_seed(C0)
    cands = torch.randint(-1, 2_000_000, (Q, C0), generator=g, device=card,
                          dtype=torch.int32)
    a = fops.freq_topc(cands, C=1024)
    b = fops.freq_topc(cands, C=1024)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_freq_topc_kernels_do_not_spill(card):
    """0 spill bytes in both kernels (the row kernel at 512 threads and 128
    registers, the wide one at 256 and 255), and the shared memory the C
    side reports is radix_plan's."""
    a = fops.kernel_attrs()
    assert a["spill_bytes"] == 0 and a["wide_spill_bytes"] == 0, a
    assert a["smem_bytes"] == fops.radix_plan(32_768, 0)["smem_bytes"]
    assert a["wide_smem_bytes"] == fops.radix_plan(300_000, 0)["smem_bytes"]


@pytest.mark.parametrize("C0", [1, 31, 777, 2049, 32_000, 32_768, 32_769,
                                65_280, 70_000, 262_144, 262_145, 2 ** 30])
def test_freq_topc_radix_plan_is_the_c_sides(card, C0):
    for max_id in (-1, 0, 62, 63, 1_999_999, 2 ** 27 - 2, 2 ** 31 - 1):
        assert fops.plan_export(C0, max_id) == fops.radix_plan(C0, max_id)


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


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("C,k", [(20_000, 40), (16_385, 40),
                                 (40_000, 20_000)])
def test_quant_rerank_raises_past_shared_memory(card, C, k, dtype):
    """topC past one block's shared memory (16385 slots need 32768 sort
    keys) runs in passes of 16384 slots merged into a running top-k' (k' up
    to 20,000, in scratch). Held against the plain version by
    ref.same_topk."""
    queries, cid, cnt, tstore = _quant_inputs(4, 3000, 96, C, 32, dtype, 2)
    args = [torch.from_numpy(a).to(card) for a in (queries, cid, cnt)]
    codes = tstore.codes.to(card)
    scales = None if tstore.scales is None else tstore.scales.to(card)
    reset_launches()
    ids, vals = qops.quant_coarse_topk(args[0], codes, scales, args[1],
                                       args[2], tau=1, k=k)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_rerank"] == 1
    assert qops.smem_bytes(C, 96) > qops.SMEM_BYTES
    assert qops.pass_slots(C, 96) == 16384
    rids, rvals = quant_rerank_ref(args[0], codes, scales, args[1], args[2],
                                   tau=1, k=k)
    _, wide = quant_rerank_ref(args[0], codes, scales, args[1], args[2],
                               tau=1, k=k + 1)
    assert same_topk(ids, rids, vals, rvals, wide) <= 1


def _quant_valid_rows(Q, L, D, C, n_valid, dtype, seed, blk=32):
    """Rows with exactly n_valid[q] valid slots (count 3 >= tau = 2) at
    random positions; the others an id of -1 or a count below tau."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(L, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    cid = rng.integers(0, L, (Q, C)).astype(np.int32)
    cnt = np.zeros((Q, C), np.float32)
    for q, n in enumerate(n_valid):
        cnt[q, rng.permutation(C)[:n]] = 3.0
        off = cnt[q] == 0
        cid[q, off & (rng.random(C) < 0.5)] = -1
        cnt[q, off & (cid[q] >= 0)] = 1.0
    return queries, cid, cnt, encode(torch.from_numpy(base), dtype, blk)


def _quant_hold(card, queries, cid, cnt, tstore, k, metric="angular",
                tau=2):
    """One launch, held against the plain version by ref.same_topk ->
    (ids, vals, plain ids, plain vals, flagged rows)."""
    args = [torch.from_numpy(a).to(card) for a in (queries, cid, cnt)]
    codes = tstore.codes.to(card)
    scales = None if tstore.scales is None else tstore.scales.to(card)
    reset_launches()
    ids, vals = qops.quant_coarse_topk(args[0], codes, scales, args[1],
                                       args[2], tau=tau, k=k, metric=metric)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_rerank"] == 1
    kp = min(k, cid.shape[1])
    rids, rvals = quant_rerank_ref(args[0], codes, scales, args[1], args[2],
                                   tau=tau, k=kp, metric=metric)
    _, wide = quant_rerank_ref(args[0], codes, scales, args[1], args[2],
                               tau=tau, k=min(kp + 1, cid.shape[1]),
                               metric=metric)
    flagged = same_topk(ids, rids, vals, rvals, wide)
    return ids, vals, rids, rvals, flagged


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("C,k", [(1024, 40), (300, 100), (1023, 40)])
def test_quant_rerank_kernel_at_every_valid_count(card, C, k, dtype):
    """Rows with 0, k'-1, k', 64, 65 and C valid slots: the warp sort
    (<= 64 keys), the radix select past it, k' > 64 (a block sort of the
    selected keys), C not a multiple of 4 (scalar id loads)."""
    counts = [0, k - 1, k, 64, 65, C, 1, 63]
    queries, cid, cnt, tstore = _quant_valid_rows(len(counts), 4000, 96, C,
                                                  counts, dtype, C + k)
    ids, vals, rids, _, flagged = _quant_hold(card, queries, cid, cnt,
                                              tstore, k)
    assert flagged <= 1
    got_valid = torch.isfinite(vals).sum(1).cpu().tolist()
    assert got_valid == [min(n, k) for n in counts]
    assert (ids[~torch.isfinite(vals)] == -1).all()


@pytest.mark.parametrize("metric", ["angular", "l2"])
@pytest.mark.parametrize("C,k", [(1024, 40), (200, 100)])
def test_quant_rerank_kernel_ties_go_to_the_smaller_position(card, C, k,
                                                            metric):
    """Every slot's row equal (distinct ids over one repeated row): every
    score ties, and the kernel keeps the first k' valid positions in
    position order, id for id as the plain version."""
    rng = np.random.default_rng(5)
    L, D = 3000, 96
    base = np.repeat(rng.normal(size=(1, D)).astype(np.float32), L, 0)
    tstore = encode(torch.from_numpy(base), "int8", 32)
    queries = rng.normal(size=(6, D)).astype(np.float32)
    cid = np.stack([rng.permutation(L)[:C] for _ in range(6)]
                   ).astype(np.int32)
    cnt = (rng.random((6, C)) < 0.3).astype(np.float32) * 3
    cnt[0] = 3.0                                  # every slot valid
    ids, vals, rids, rvals, _ = _quant_hold(card, queries, cid, cnt, tstore,
                                            k, metric)
    assert torch.equal(ids, rids)
    torch.testing.assert_close(vals, rvals, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("D,blk", [(100, 4), (100, 25), (36, 12), (8, 8)])
def test_quant_rerank_kernel_rows_not_16_byte_aligned(card, D, blk, dtype):
    """D = 100 int8 rows are 100 B (4-byte vectors), a scale block of 25
    crosses them (a scale an element); bf16 rows of 200 B take 4-byte
    vectors too."""
    queries, cid, cnt, tstore = _quant_inputs(9, 2000, D, 1000, blk, dtype,
                                              7)
    assert _quant_hold(card, queries, cid, cnt, tstore, 40)[4] <= 1


def test_quant_rerank_kernel_does_not_spill(card):
    a = qops.kernel_attrs()
    assert a["spill_bytes"] == 0, a
    assert a["fixed_smem_bytes"] == qops.FIXED_INTS * 4


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


@pytest.mark.parametrize("m", [65, 128, 1000, 3000])
def test_irli_topk_kernel_matches_plain_past_64(card, m):
    """m > 64 runs the radix-select variant (one [128, B] slab of logits a
    block): values and lse to 1e-5, ids equal outside near ties, m = B
    included; G·Q spans several tiles a block."""
    G, Q, H, B = 3, 300, 96, 3000
    rng = np.random.default_rng(m)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(card)
            for s in ((G, Q, H), (G, H, B), (G, B))]
    reset_launches()
    vals, idx, lse = iops.scorer_topk(*args, m=m, lse=True)
    torch.cuda.synchronize()
    assert LAUNCHES["irli_topk"] == 1
    wide_v, wide_i, ref_lse = irli_topk_ref(*args, m=min(m + 1, B), lse=True)
    cut, _ = same_topm(vals, idx, wide_v, wide_i)
    assert cut <= max(1, G * Q // 16)
    assert bool(near(lse, ref_lse, 1e-5).all())
    # without lse: the same values and ids
    v2, i2 = iops.scorer_topk(*args, m=m)
    assert torch.equal(v2, vals) and torch.equal(i2, idx)


def test_irli_topk_wide_bf16_and_ragged(card):
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        card, torch.bfloat16) for s in ((2, 130, 33), (2, 33, 777), (2, 777))]
    vals, idx = iops.scorer_topk(*args, m=777)
    wide_v, wide_i = irli_topk_ref(*args, m=777)
    same_topm(vals, idx, wide_v, wide_i)


@pytest.mark.parametrize("rows,B,weighted", [
    (64, 512, False), (96, 1001, True), (4 * 128, 20000, True)])
def test_bce_logits_kernel_matches_plain(card, rows, B, weighted):
    """Loss to 1e-6 relative, gradient to 1e-6: the kernel sums in double
    and computes σ with expf, the plain version in fp32 torch. Unit weights
    and scale 1/N give the reference's fused_bce; the weighted form has
    zero-weight rows (the tail batch's padding)."""
    from repro_torch.kernels.bce_logits import ops as bops
    from repro_torch.kernels.bce_logits.ref import weighted_bce_ref
    rng = np.random.default_rng(rows + B)
    x = torch.from_numpy(rng.normal(size=(rows, B)).astype(np.float32) * 4
                         ).to(card)
    y = torch.from_numpy((rng.random((rows, B)) > 0.9).astype(np.float32)
                         ).to(card)
    n = rows // 4
    w = None
    scale = 1.0 / rows
    if weighted:
        w = torch.from_numpy(rng.random(n).astype(np.float32)).to(card)
        w[-3:] = 0.0
        scale = 1.0 / (4 * max(float(w.sum()), 1.0))
    reset_launches()
    loss, grad = bops.weighted_bce(x, y, w, scale=scale)
    torch.cuda.synchronize()
    assert LAUNCHES["bce_logits"] == 1
    rloss, rgrad = weighted_bce_ref(x, y, w, scale)
    assert abs(float(loss) - float(rloss)) <= 1e-6 * abs(float(rloss))
    torch.testing.assert_close(grad, rgrad, rtol=1e-6, atol=1e-6)
    again, _ = bops.weighted_bce(x, y, w, scale=scale)
    assert float(again) == float(loss)        # no atomics: run to run


def test_sigmoid_bce_autograd_on_the_card(card):
    """scorer_loss_parts(sigmoid_bce) through the kernel: loss and all four
    parameter gradients equal the plain version's (CPU) to 1e-5."""
    from repro_torch.core import network as TN
    cfg = TN.ScorerConfig(d_in=16, d_hidden=64, n_buckets=300, n_reps=3,
                          loss="sigmoid_bce")
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in (
        ("w1", (3, 16, 64)), ("b1", (3, 64)), ("w2", (3, 64, 300)),
        ("b2", (3, 300)))}
    x = rng.normal(size=(40, 16)).astype(np.float32)
    y = (rng.random((3, 40, 300)) > 0.95).astype(np.float32)
    w = np.ones(40, np.float32)
    w[-5:] = 0
    out = []
    for dev in ("cpu", card):
        p = {k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in params.items()}
        s, _ = TN.scorer_loss_parts(p, cfg, torch.tensor(x, device=dev),
                                    torch.tensor(y, device=dev),
                                    torch.tensor(w, device=dev), scale=0.01)
        g = torch.autograd.grad(s, [p[k] for k in sorted(p)])
        out.append([s.detach().cpu()] + [t.cpu() for t in g])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _kchoice_inputs(kind, G, L, K, B, weighted, seed):
    """numpy inputs of one kchoice case: candidates [G, L, K] of the kind
    (candidate_lists: "uniform", "same", "zipf"), orders [G, L], load0
    [G, B] (near 2^23: the tie rule; "negzero": -0.0 and +0.0 mixed),
    weights [L] or None ("zero_weights": a quarter are 0, as the insert's
    padding rows)."""
    rng = np.random.default_rng(seed)
    topk = candidate_lists(rng, kind, G, L, K, B)
    order = np.stack([rng.permutation(L) for _ in range(G)])
    if kind == "negzero":
        load0 = np.where(rng.random((G, B)) < 0.5, -0.0, 0.0)
    else:
        load0 = rng.integers(0, 3, (G, B)) + 2.0 ** 23
    w = rng.random(L) if weighted else None
    if kind == "zero_weights":
        w = np.where(rng.random(L) < 0.25, 0.0, 1.0)
    return (topk, order.astype(np.int32), load0.astype(np.float32),
            None if w is None else w.astype(np.float32))


@pytest.mark.parametrize("G,L,K,B,weighted,kind", [
    (3, 5000, 10, 700, False, "uniform"), (2, 3000, 40, 129, True, "uniform"),
    (1, 16384, 10, 20000, False, "uniform"),
    (2, 4096, 10, 20000, False, "same"), (2, 5000, 10, 2000, True, "zipf"),
    (2, 777, 1, 50, False, "uniform"), (2, 1000, 32, 300, True, "uniform"),
    (2, 1000, 10, 64, False, "negzero"),
    (2, 4100, 10, 20000, False, "zero_weights")])
def test_kchoice_kernel_matches_plain_bit_for_bit(card, G, L, K, B,
                                                  weighted, kind):
    """One launch for all reps, bit-identical to the plain loop: the same
    float32 adds in the same order; large load0 exercises the tie rule.
    A second launch gives the same, and its count of rounds (windows and
    in-register steps) is the plain schedule's (ref.kchoice_windows): L
    when every label of a rep shares one K-list."""
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.kchoice.ref import kchoice_ref, kchoice_windows
    topk, order, load0, w = _kchoice_inputs(kind, G, L, K, B, weighted,
                                            L + K)
    t = lambda a: None if a is None else torch.from_numpy(a).to(card)
    reset_launches()
    got = kops.kchoice_assign(t(topk), t(order), t(load0), t(w), B=B)
    torch.cuda.synchronize()
    assert LAUNCHES["kchoice"] == 1
    want = kchoice_ref(t(topk), t(order), t(load0), t(w), B=B)
    assert torch.equal(got, want)
    rounds = torch.zeros(G, dtype=torch.int32, device=card)
    again = kops.kchoice(t(topk), t(order), t(load0), t(w), B=B,
                         rounds=rounds)
    plain, plain_rounds = kchoice_windows(t(topk), t(order), t(load0),
                                          t(w), B=B)
    assert torch.equal(again, got) and torch.equal(plain, want)
    assert rounds.tolist() == plain_rounds.tolist()
    if kind == "same":
        assert rounds.tolist() == [L] * G


@pytest.mark.parametrize("walk_below", [0, 32])
@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_kchoice_kernel_follows_the_walk_policy(card, monkeypatch, kind,
                                                walk_below):
    """The walk's policy has one owner, ref.WALK_BELOW, which each launch
    passes to the kernel: at 0 (never walk: windows only) and at 32 (walk
    every window past its first dirty lane) the kernel stays bit-equal to
    the plain loop and its rounds are the plain schedule's under the same
    policy."""
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.kchoice import ref as kref
    monkeypatch.setattr(kref, "WALK_BELOW", walk_below)
    G, L, K, B = 2, 5000, 10, 2000
    topk, order, load0, w = _kchoice_inputs(kind, G, L, K, B, True, 7)
    t = lambda a: torch.from_numpy(a).to(card)
    rounds = torch.zeros(G, dtype=torch.int32, device=card)
    got = kops.kchoice(t(topk), t(order), t(load0), t(w), B=B, rounds=rounds)
    plain, plain_rounds = kref.kchoice_windows(t(topk), t(order), t(load0),
                                               t(w), B=B)
    assert torch.equal(got, kref.kchoice_ref(t(topk), t(order), t(load0),
                                             t(w), B=B))
    assert torch.equal(plain, got)
    assert rounds.tolist() == plain_rounds.tolist()


def test_kchoice_c_entry_refuses_a_walk_policy_it_cannot_hold(card):
    """A window has 32 lanes and a lane holds at most 16 candidates: the C
    entry refuses walk_below past 32 and walk_max_k past 16, and slots
    outside [1, K], and launches nothing."""
    from repro_torch.kernels.kchoice import ops as kops
    topk = torch.zeros((1, 64, 4), dtype=torch.int32, device=card)
    order = torch.arange(64, dtype=torch.int32, device=card)[None]
    out = torch.full((1, 64), -1, dtype=torch.int32, device=card)
    for below, max_k, slots in ((33, 16, 1), (8, 17, 1), (-1, 16, 1),
                                (8, 16, 0), (8, 16, 5)):
        err = kops._launcher()(topk.data_ptr(), order.data_ptr(), None, 0,
                               None, 1, 64, 4, 8, slots, below, max_k,
                               out.data_ptr(), None,
                               torch.cuda.current_stream(card).cuda_stream)
        assert err != 0, (below, max_k, slots)
    torch.cuda.synchronize(card)
    assert out.eq(-1).all()


def test_kchoice_step_cycles_are_latencies(card):
    """The latency behind kchoice's bound: the cheapest link of a
    dependence chain, a min and an add in registers, a few to a few hundred
    SM clocks; launching the probe counts no kchoice launch."""
    from repro_torch.kernels.kchoice import ops as kops
    reset_launches()
    link = kops.step_cycles(card)
    assert 4 <= link <= 500, link
    assert LAUNCHES["kchoice"] == 0


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


# -------------------------------------------------------- distance_topk ----
def _dist_card(card, Q, L, d, seed, shared):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(Q, d)).astype(np.float32)).to(card)
    base = torch.from_numpy(rng.normal(size=(L, d)).astype(np.float32))
    base = base.to(card)
    if shared:            # the oracle's stride-0 view of ~tombstone
        live = torch.from_numpy(rng.uniform(size=L) > 0.3).to(card)
        mask = live[None, :].expand(Q, L)
    else:
        mask = torch.from_numpy(rng.uniform(size=(Q, L)) > 0.5).to(card)
    return q, base, mask


def _dist_agree(vals, ids, q, base, mask, k, metric):
    """Kernel vs plain: the plain top-(k+1) gives the near-tie rows
    (ref.same_topm); -1 where the score is not finite, in both."""
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    kk = min(k + 1, base.shape[0])
    rv, ri = distance_topk_ref(q, base, mask, k=kk, metric=metric)
    ri = torch.where(torch.isfinite(rv), ri, torch.full_like(ri, -1))
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    fin = torch.isfinite(rv[:, :k])
    assert torch.equal(torch.isfinite(vals), fin)
    rv = torch.where(torch.isfinite(rv), rv, torch.zeros_like(rv))
    same_topm(torch.where(fin, vals, torch.zeros_like(vals)), ids, rv, ri)


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("Q,L,d,k,shared", [
    (1, 1, 8, 1, False),
    (7, 1000, 96, 10, True),
    (130, 5000, 96, 10, False),       # ragged query tiles
    (20, 4000, 96, 31, False),
    (20, 4000, 96, 32, True),
    (64, 70_000, 96, 100, True),      # many splits, lists in shared memory
    (33, 3000, 96, 109, False),       # k > 108: lists in device memory
    (33, 3000, 40, 200, False),
    (5, 300, 17, 300, True),          # k = L
    (40, 3000, 768, 10, True),        # d > 288: the query tile streamed
    (70, 5000, 320, 92, False),       # streamed, the widest smem lists
    (20, 2000, 960, 100, True),       # streamed, lists in device memory
])
def test_distance_topk_kernel_matches_plain(card, Q, L, d, k, shared,
                                            metric):
    from repro_torch.kernels.distance_topk import ops as dops
    q, base, mask = _dist_card(card, Q, L, d, Q + L + k, shared)
    reset_launches()
    vals, ids = dops.distance_topk(q, base, mask, k=k, metric=metric)
    torch.cuda.synchronize()
    assert LAUNCHES["distance_topk"] == 1
    assert vals.shape == ids.shape == (Q, k) and ids.dtype == torch.int32
    _dist_agree(vals, ids, q, base, mask, k, metric)


def test_distance_topk_ties_and_signed_zeros(card):
    """Equal values go to the smaller column across every split, and -0.0
    sorts below +0.0 (jax.lax.top_k's total order): a zero query's l2
    similarity to a zero row is -0.0, its dot similarity to any row +0.0."""
    from repro_torch.kernels.distance_topk import ops as dops
    L, d = 50_000, 32
    base = torch.ones((L, d), device=card)
    zeros = torch.tensor([7, 19_000, 49_999], device=card)
    base[zeros] = 0.0
    q = torch.zeros((3, d), device=card)
    q[1] = 1.0                             # all rows but the zeros tie at d
    mask = torch.ones((1, L), dtype=torch.bool, device=card).expand(3, L)
    assert dops.splits(3, L, 12, card) > 1
    vals, ids = dops.distance_topk(q, base, mask, k=12, metric="dot")
    assert torch.equal(ids[0].cpu(), torch.arange(12, dtype=torch.int32))
    assert not torch.signbit(vals[0]).any()
    assert torch.equal(ids[1].cpu(), torch.tensor(
        [i for i in range(13) if i != 7], dtype=torch.int32))
    vals, ids = dops.distance_topk(q, base, mask, k=4, metric="l2")
    assert torch.equal(ids[0, :3], zeros.int())
    assert torch.signbit(vals[0, :3]).all() and (vals[0, :3] == 0).all()
    assert vals[0, 3] == -float(d)


def test_exact_topk_and_dense_search_launch_the_kernel(card):
    """core.query.exact_topk and dense mode's rerank each launch
    distance_topk once and hold no [Q, L] fp32 table."""
    from repro_torch.core.query import QueryPipeline, exact_topk
    from repro_torch.kernels.distance_topk import ops as dops
    params, members, base, queries = _mega_inputs(card, "fp32", exact=False)
    tomb = torch.zeros(base.shape[0], dtype=torch.bool, device=card)
    tomb[::3] = True
    reset_launches()
    ids = exact_topk(queries, base, tomb, k=10)
    torch.cuda.synchronize()
    assert LAUNCHES["distance_topk"] == 1
    assert not bool(tomb[ids.clamp_min(0).long()].any())
    vals, kids = dops.distance_topk(
        queries, base, (~tomb)[None, :].expand(len(queries), -1), k=10)
    assert torch.equal(torch.where(torch.isfinite(vals), kids, -1), ids)
    _dist_agree(vals, kids, queries, base, (~tomb)[None, :], 10, "dot")
    reset_launches()
    pipe = QueryPipeline(mode="dense", m=4, tau=1, k=10)
    ids, scores, nc = pipe.search(params, members, base, queries)
    torch.cuda.synchronize()
    assert {n for n, c in LAUNCHES.items() if c} == {"irli_topk",
                                                      "distance_topk"}
    assert ids.shape == (len(queries), 10) and bool((nc > 0).all())


def test_streaming_sequence_on_the_card(card):
    """A small MutableIRLIIndex on the card: each insert batch is one
    irli_topk and one kchoice launch, the search equals the plain search,
    compaction keeps it bit for bit, and the oracle is one distance_topk
    launch equal to the plain oracle; no deleted id is returned."""
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.search_api import PipelineCache, SearchParams
    from repro_torch.stream import MutableIRLIIndex
    cfg = IRLIConfig(d=32, n_labels=4000, n_buckets=64, n_reps=4,
                     d_hidden=64, K=6)
    idx = IRLIIndex(cfg, device=card)
    idx.build_index()
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    base = t(rng.normal(size=(4000, 32)))
    mi = MutableIRLIIndex(idx, base, store_dtype="int8")
    new = t(rng.normal(size=(1000, 32)))
    for s in range(0, 1000, 250):
        reset_launches()
        ids = mi.insert(new[s:s + 250])
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == {"irli_topk": 1,
                                                             "kchoice": 1}
        assert ids.device.type == "cuda"
    dead = np.r_[np.arange(0, 4000, 9), 4000 + np.arange(0, 1000, 11)]
    assert mi.delete(dead) == len(dead)
    sp = SearchParams(m=4, tau=2, k=10, store_dtype="int8")
    cache = PipelineCache()
    pre = mi.search(new[:200], sp, cache=cache)
    s = mi.snapshot
    plain = mega_search_ref(
        s.params, s.members, dataclasses.replace(s.store, exact=s.vecs),
        new[:200],
        s.delta.members, s.tombstone, m=4, tau=2, topC=1024, k=10)
    agree = (pre.ids == plain[0]).all(dim=1)
    assert int((~agree).sum()) <= 10
    mi.compact()
    post = mi.search(new[:200], sp, cache=cache)
    assert torch.equal(pre.ids, post.ids)
    assert torch.equal(pre.scores, post.scores)
    dead_t = torch.from_numpy(dead).to(card)
    assert not torch.isin(post.ids, dead_t).any()
    reset_launches()
    got = mi.exact_oracle(10)(new[:64])
    assert LAUNCHES["distance_topk"] == 1
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    n = mi.n_total
    rv, ri = distance_topk_ref(new[:64], s.vecs[:n], ~s.tombstone[None, :n],
                               k=10)
    assert (got == ri.cpu().numpy()).all(axis=1).mean() >= 0.95
    assert not np.isin(got, dead).any()


# ------------------------------------------------------ the tile GEMM ----
def _fmaf_chain(a, b):
    """Σ_k a[:, k] · b[k, :] as the tile computes it: one fmaf a sum, k
    ascending, from +0.0. The product of two fp32 is exact in float64, so
    each step rounds twice (to float64, then to float32), which differs
    from one fmaf's single rounding about once in 2^29 steps."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64)
               + a64[:, k, None] * b64[None, k, :]).astype(np.float32)
    return acc


def _top(x, m):
    """jax.lax.top_k of each row of a float32 array: (values, columns)."""
    b = x.view(np.int32)
    key = np.where(b < 0, b ^ 0x7fffffff, b).astype(np.int64)
    cols = np.broadcast_to(np.arange(x.shape[1]), x.shape)
    order = np.lexsort((cols, -key), axis=1)[:, :m]
    return np.take_along_axis(x, order, 1), order.astype(np.int32)


@pytest.mark.parametrize("kernel", ["irli_topk", "distance_topk",
                                    "distance_topk_streamed"])
def test_tile_sums_follow_the_fmaf_chain(card, kernel):
    """Every similarity or logit is one fmaf chain over k ascending: the
    kernels' top values equal a float64 emulation of that chain bit for
    bit, at a depth that is not a multiple of the slice (K = 100; 300 with
    distance_topk's query tile streamed)."""
    rng = np.random.default_rng(19)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(card)
    if kernel == "irli_topk":
        h, w2, b2 = f32(2, 70, 100), f32(2, 100, 300), f32(2, 300)
        vals, idx = iops.irli_topk(t(h), t(w2), t(b2), m=5)
        for g in range(2):
            want_v, want_i = _top(_fmaf_chain(h[g], w2[g]) + b2[g], 5)
            got = vals[g].cpu().numpy()
            assert np.array_equal(got.view(np.int32), want_v.view(np.int32))
            assert np.array_equal(idx[g].cpu().numpy(), want_i)
    else:
        from repro_torch.kernels.distance_topk import ops as dops
        d = 100 if kernel == "distance_topk" else 300
        assert dops.query_resident(d) == (d == 100)
        q, base = f32(70, d), f32(700, d)
        mask = torch.ones((1, 700), dtype=torch.bool, device=card)
        vals, ids = dops.distance_topk(t(q), t(base), mask.expand(70, -1),
                                       k=10)
        want_v, want_i = _top(_fmaf_chain(q, base.T), 10)
        got = vals.cpu().numpy()
        assert np.array_equal(got.view(np.int32), want_v.view(np.int32))
        assert np.array_equal(ids.cpu().numpy(), want_i)


@pytest.mark.parametrize("G,Q,H,B,m,dtype", [
    (2, 129, 50, 20_000, 5, "float32"),   # B = 156·128 + 32, K = 50
    (1, 64, 96, 20_000, 5, "bfloat16"),   # K = 96: one and a half bf16 slices
    (3, 200, 1024, 517, 10, "float32"),   # 32 slices a tile, ragged N
    (1, 1, 1, 1, 1, "float32"),
])
def test_tile_ragged_edges(card, G, Q, H, B, m, dtype):
    """Rows past Q, columns past B and depths past H arrive as zeros from
    the tensor maps: values and lse to 1e-5, ids outside near ties."""
    rng = np.random.default_rng(G * Q + H + B)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        card, getattr(torch, dtype)) for s in ((G, Q, H), (G, H, B), (G, B))]
    vals, idx, lse = iops.irli_topk(*args, m=m, lse=True)
    wide_v, wide_i, ref_lse = irli_topk_ref(*args, m=min(m + 1, B), lse=True)
    cut, _ = same_topm(vals, idx, wide_v, wide_i)
    assert cut <= max(1, G * Q // 16)
    assert bool(near(lse, ref_lse, 1e-5).all())


@pytest.mark.parametrize("d,metric", [(96, "dot"), (100, "l2"), (33, "dot"),
                                      (768, "l2")])
def test_tile_ring_wraps_over_corpus_tiles(card, d, metric):
    """One block walks many corpus tiles (at least 3 a split), so the ring
    of 3 stages wraps over tile boundaries; d = 100 and 33 end on a part
    slice, the transposed corpus rows zero-filled past d; at d = 768 the
    query tile's slices come through the ring too."""
    from repro_torch.kernels.distance_topk import ops as dops
    Q, L, k = 64, 100_000, 10
    tiles = -(-L // 128)
    assert -(-tiles // dops.splits(Q, L, k, card, d)) >= 3
    q, base, mask = _dist_card(card, Q, L, d, d, True)
    vals, ids = dops.distance_topk(q, base, mask, k=k, metric=metric)
    _dist_agree(vals, ids, q, base, mask, k, metric)


@pytest.mark.parametrize("kernel", ["irli_topk", "mega_query",
                                    "distance_topk"])
def test_tile_footprints_match_the_c_side(card, kernel):
    """The Python footprint models (ops.smem_bytes and friends, which the
    CPU tests pin) equal the C side's own export; irli_topk and
    distance_topk keep their registers (0 spill bytes)."""
    from repro_torch.kernels.distance_topk import ops as dops
    if kernel == "irli_topk":
        for dtype in (torch.float32, torch.bfloat16):
            for m in (1, 5, 64):
                a = iops.kernel_attrs(dtype, m)
                assert (a["stages"], a["slice_depth"], a["stage_bytes"]) == (
                    iops.STAGES, iops.SLICE_DEPTH[dtype], iops.STAGE_BYTES)
                assert a["smem_bytes"] == iops.smem_bytes(m)
                assert a["wide_smem_bytes"] == 1024 + iops.STAGES * \
                    iops.STAGE_BYTES
                assert a["spill_bytes"] == a["wide_spill_bytes"] == 0, a
    elif kernel == "mega_query":
        # its phases share 128 registers a thread; the kernel spilled 56 to
        # 64 bytes a thread before the tile was redesigned, and no more now
        for rows in (torch.float32, torch.int8, torch.bfloat16):
            for m in (1, 5, 8):
                a = mops.kernel_attrs(rows, m)
                assert a["tiles_smem_bytes"] == 1024 + 2 * \
                    iops.tile_smem_bytes(m)
                assert (a["stages"], a["slice_depth"]) == (
                    iops.STAGES, iops.SLICE_DEPTH[torch.float32])
                assert a["spill_bytes"] <= 64, a
    else:
        for d, k in ((96, 10), (96, 100), (96, 108), (96, 109), (100, 10),
                     (17, 300), (8, 1), (288, 10), (289, 10), (768, 92),
                     (768, 93), (960, 100)):
            a = dops.kernel_attrs(d, k)
            assert a["smem_bytes"] == dops.smem_bytes(d, k)
            assert a["lists_in_smem"] == dops.lists_in_smem(d, k)
            assert a["query_resident"] == dops.query_resident(d)
            assert a["blocks_per_sm"] == dops.blocks_per_sm(d, k), (d, k, a)
            assert (a["stages"], a["slice_depth"]) == (dops.STAGES,
                                                       dops.SLICE)
            assert a["spill_bytes"] == a["l2_spill_bytes"] == 0, a
            assert a["stream_spill_bytes"] == a["stream_l2_spill_bytes"] \
                == 0, a


# ------------------------------------------------------- flash attention --
def _flash_inputs(card, B, H, Hkv, S, D, dtype, layout="bhsd"):
    """q [B, H, S, D], k, v [B, Hkv, S, D] on the card from a seed; with
    layout "bshd" each is the transpose(1, 2) view of a [B, S, H, D]
    tensor (attend_train's layout); with "skew" a contiguous view whose
    base is one element past a 16-byte boundary (the wrapper copies it)."""
    rng = np.random.default_rng(B * S + H * D + Hkv)
    dt = getattr(torch, dtype)

    def make(h):
        a = torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(
            np.float32)).to(card, dt)
        if layout == "bshd":
            return a.transpose(1, 2)
        a = a.transpose(1, 2).contiguous()
        if layout == "skew":
            flat = torch.empty(a.numel() + 1, device=card, dtype=dt)
            flat[1:] = a.reshape(-1)
            a = flat[1:].view(a.shape)
            assert a.data_ptr() % 16
        return a
    return make(H), make(Hkv), make(Hkv)


def _flash_check(o, q, k, v, dtype):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    ref = flash_attention_ref(q, k, v)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert torch.isfinite(o.float()).all()
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(o.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,layout", [
    (2, 3, 3, 128, 16, "bhsd"),
    (1, 4, 4, 200, 64, "bhsd"),     # ragged S: a part tile of queries, keys
    (2, 4, 2, 77, 128, "bhsd"),     # GQA, ragged
    (1, 2, 2, 300, 256, "bhsd"),    # gemma's head_dim, ragged
    (1, 8, 1, 64, 32, "bhsd"),      # MQA
    (2, 2, 2, 130, 48, "bhsd"),     # D padded to 64 in shared memory
    (1, 2, 2, 90, 80, "bhsd"),      # ... to 128
    (1, 2, 1, 33, 192, "bhsd"),     # ... to 256
    (1, 1, 1, 1, 64, "bhsd"),       # one position
    # the edges of the 128-row query tile and the 64- or 128-key tiles,
    # and a ring of two stages that wraps many times (S = 1000)
    (1, 2, 2, 63, 256, "bhsd"),
    (1, 2, 1, 64, 256, "bhsd"),
    (2, 2, 2, 65, 256, "bhsd"),
    (1, 2, 2, 127, 128, "bhsd"),
    (1, 2, 2, 128, 128, "bhsd"),
    (1, 2, 2, 129, 64, "bhsd"),
    (1, 2, 1, 1000, 256, "bhsd"),
    (1, 2, 2, 1000, 128, "bhsd"),
    (1, 2, 2, 1000, 64, "bhsd"),
    # qwen3's 32 query heads over 8 KV heads, in attend_train's layout
    (1, 8, 2, 300, 256, "bshd"),
    (1, 8, 2, 300, 128, "bshd"),
    # a base off the 16-byte grain: the wrapper's copy
    (1, 2, 2, 150, 128, "skew"),
])
def test_flash_attention_kernel_matches_plain(card, B, H, Hkv, S, D, layout,
                                              dtype):
    from repro_torch.kernels.flash_attention import ops as faops
    q, k, v = _flash_inputs(card, B, H, Hkv, S, D, dtype, layout)
    reset_launches()
    o = faops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    _flash_check(o, q.contiguous(), k.contiguous(), v.contiguous(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,D", [(200, 256), (300, 128), (130, 64),
                                 (100, 80), (70, 48)])
def test_flash_attention_kernel_running_mean_of_structured_v(card, S, D,
                                                             dtype):
    """q = 0 makes every score 0, so output row s is the mean of v over
    keys 0..s. With v[s, d] = (s + d / 1000) · (1 + KV head), a permuted,
    transposed or mis-swizzled tile of V, a key tile out of place or a
    wrong KV head shows at once."""
    from repro_torch.kernels.flash_attention import ops as faops
    dt = getattr(torch, dtype)
    B, H, Hkv = 2, 4, 2
    gen = torch.Generator(card).manual_seed(S * D)
    q = torch.zeros(B, H, S, D, device=card, dtype=dt)
    k = torch.randn(B, Hkv, S, D, device=card, generator=gen).to(dt)
    pos = torch.arange(S, device=card, dtype=torch.float64)
    col = torch.arange(D, device=card, dtype=torch.float64)
    head = torch.arange(1, Hkv + 1, device=card, dtype=torch.float64)
    v = ((pos[:, None] + col[None, :] / 1000) * head[:, None, None]) \
        .expand(B, Hkv, S, D).to(dt).contiguous()
    o = faops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    mean = v.double().cumsum(2) / (pos + 1)[:, None]
    want = mean.repeat_interleave(H // Hkv, dim=1)
    # P is exactly 1 and l the key count: the only rounding left is the
    # output's own (bf16: 2^-9 relative)
    tol = 4e-3 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(o.double(), want, rtol=tol, atol=1e-6)
    _flash_check(o, q, k, v, dtype)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_kernel_is_deterministic(card, D):
    """Two launches on the same inputs give the same bits: no atomics, the
    same summation order every run."""
    from repro_torch.kernels.flash_attention import ops as faops
    q, k, v = _flash_inputs(card, 2, 4, 2, 1000, D, "bfloat16", "bshd")
    a = faops.flash_attention(q, k, v)
    b = faops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_attention_bf16_kernels_do_not_spill(card):
    """cudaFuncGetAttributes: no local (spill) memory at any DT, the
    plan's shared memory within the card's 227 KB."""
    from repro_torch.kernels.flash_attention import ops as faops
    attrs = faops.kernel_attrs()
    assert sorted(attrs) == [64, 128, 256]
    for dt, a in attrs.items():
        assert a["spill_bytes"] == 0, (dt, a)
        assert 0 < a["registers"] <= 255, (dt, a)
        plan = faops.flash_plan(1, 1, 1, 128, dt, torch.bfloat16)
        assert a["smem_bytes"] == plan.smem <= faops.SMEM_LIMIT, (dt, a)


def test_flash_attention_c_entry_refuses_a_plan_it_was_not_built_for(card):
    """The C entry checks the Python plan against its own constants and
    the call's shapes before it launches."""
    import ctypes

    from repro_torch.kernels.flash_attention import ops as faops
    q, k, v = _flash_inputs(card, 1, 2, 2, 200, 128, "bfloat16")
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    good = faops.flash_plan(1, 2, 2, 200, 128, torch.bfloat16).as_array()
    for i, bad in ((2, 64), (5, good[5] - 1024), (6, good[6] + 1),
                   (7 + 8, 64), (7 + 11 + 4, 2), (7 + 33 + 8, 128)):
        arr = list(good)
        arr[i] = bad
        err = faops._lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 1, 2,
            2, 200, 128, strides, (ctypes.c_longlong * faops.PLAN_LEN)(*arr),
            torch.cuda.current_stream().cuda_stream)
        assert err != 0, (i, bad)
    err = faops._lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 1, 2, 2,
        200, 128, strides, (ctypes.c_longlong * faops.PLAN_LEN)(*good),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    _flash_check(o, q, k, v, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_reads_the_bshd_layout_in_place(card, dtype):
    """attend_train's [B, S, H, D] tensors go in as transpose(1, 2) views:
    no copy, and the output comes back in the same layout."""
    from repro_torch.kernels.flash_attention import ops as faops
    q, k, v = _flash_inputs(card, 2, 8, 2, 333, 128, dtype, layout="bshd")
    assert not q.is_contiguous()
    reset_launches()
    o = faops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert o.stride() == q.stride()
    _flash_check(o, q.contiguous(), k.contiguous(), v.contiguous(), dtype)


def test_flash_attention_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention import ops as faops
    q, k, v = _flash_inputs(card, 1, 2, 2, 32, 64, "bfloat16")
    with pytest.raises(ValueError, match="head_dim"):
        faops.flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError, match="one dtype"):
        faops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="KV heads"):
        faops.flash_attention(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError, match="no backward"):
        faops.flash_attention(q.requires_grad_(), k, v)


def test_prefill_on_the_card_launches_the_kernel_once_a_layer(card):
    """A small bf16 LM's prefill on the card: one flash_attention launch a
    layer and no other kernel; the hidden state within bf16 rounding of
    the same prefill with the plain attention."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.steps import build_lm_prefill
    from repro_torch.models import attention as PA
    from repro_torch.models.transformer import LMConfig, lm_init
    cfg = LMConfig(name="tiny", n_layers=3, d_model=256, n_heads=4,
                   n_kv_heads=2, head_dim=64, d_ff=512, vocab=1000,
                   qk_norm=True)
    model = lm_init(cfg, seed=0, device=card)
    tokens = torch.randint(0, 1000, (2, 300), device=card,
                           generator=torch.Generator(card).manual_seed(0))
    step = build_lm_prefill(cfg)
    reset_launches()
    out = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"flash_attention": 3}
    kernel_attn = PA.causal_attention
    PA.causal_attention = flash_attention_ref
    try:
        plain = step(model, {"tokens": tokens})
    finally:
        PA.causal_attention = kernel_attn
    h, ph = out["hidden"].float(), plain["hidden"].float()
    assert float((h - ph).norm() / ph.norm()) <= 2e-2


# ---------------------------------------------------------- embedding_bag --
def _bag_inputs(card, N, P, V, D, dtype, seed, lo=-1):
    g = torch.Generator(card).manual_seed(seed)
    ids = torch.randint(lo, V, (N, P), generator=g, device=card,
                        dtype=torch.int32)
    w = torch.rand((N, P), generator=g, device=card)
    if N >= 3 and P >= 2:
        ids[0] = -1                     # an all-pad bag
        w[1, : P // 2] = 0.0            # zero weights on real rows
    tbl = torch.randn((V, D), generator=g, device=card).to(dtype)
    return ids, w, tbl


def _bag_check(out, ids, w, tbl):
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    want = embedding_bag_ref(ids, w, tbl)
    assert out.dtype == tbl.dtype and out.shape == want.shape
    tol = (dict(rtol=1e-5, atol=1e-5) if tbl.dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))   # one bf16 rounding apart
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1, 100])
@pytest.mark.parametrize("D", [1, 18, 32, 64, 128, 200])
def test_embedding_bag_kernel_matches_plain(card, D, P, dtype):
    from repro_torch.kernels.embedding_bag import ops as eops
    ids, w, tbl = _bag_inputs(card, 333, P, 5000, D, getattr(torch, dtype),
                              seed=D + P)
    reset_launches()
    out = eops.embedding_bag(ids, w, tbl)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_bag"] == 1
    _bag_check(out, ids, w, tbl)
    if P == 100:
        assert (out[0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_kernel_empty_and_far_ids(card, dtype):
    """N = 0 and P = 0 give zeros; ids near V = 2^20 (DIEN's item table)
    read the right rows."""
    from repro_torch.kernels.embedding_bag import ops as eops
    dt = getattr(torch, dtype)
    for N, P in ((0, 100), (37, 0)):
        ids, w, tbl = _bag_inputs(card, N, P, 50, 18, dt, seed=1)
        out = eops.embedding_bag(ids, w, tbl)
        assert out.shape == (N, 18) and out.dtype == dt
        assert (out == 0).all()
    V = 1 << 20
    ids, w, tbl = _bag_inputs(card, 1025, 100, V, 18, dt, seed=2,
                              lo=V - 1000)
    out = eops.embedding_bag(ids, w, tbl)
    torch.cuda.synchronize()
    _bag_check(out, ids, w, tbl)


def test_embedding_bag_kernel_reads_non_contiguous_inputs(card):
    from repro_torch.kernels.embedding_bag import ops as eops
    ids, w, tbl = _bag_inputs(card, 200, 64, 3000, 40, torch.float32, seed=3)
    sub_ids, sub_w = ids[::2, ::2], w[::2, ::2]        # strided views
    sub_tbl = tbl[:, 3:21]                              # a column slice
    assert not (sub_ids.is_contiguous() or sub_tbl.is_contiguous())
    out = eops.embedding_bag(sub_ids, sub_w, sub_tbl)
    torch.cuda.synchronize()
    _bag_check(out, sub_ids, sub_w, sub_tbl)


def test_embedding_bag_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.embedding_bag import ops as eops
    ids, w, tbl = _bag_inputs(card, 8, 4, 50, 18, torch.float32, seed=4)
    with pytest.raises(ValueError, match="int32"):
        eops.embedding_bag(ids.long(), w, tbl)
    with pytest.raises(ValueError, match="weights"):
        eops.embedding_bag(ids, w.double(), tbl)
    with pytest.raises(ValueError, match="table"):
        eops.embedding_bag(ids, w, tbl.half())
    with pytest.raises(ValueError, match="CUDA tensors"):
        eops.embedding_bag(ids.cpu(), w.cpu(), tbl.cpu())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1, 3, 99, 100, 101])
@pytest.mark.parametrize("D", [1, 17, 18, 19, 36, 64, 65, 128, 200])
def test_embedding_bag_kernel_lanes_over_slots_and_columns(card, D, P,
                                                           dtype):
    """Every plan the kernel takes (a group of lanes a slot, several
    groups a warp, columns past 32 vectors in chunks) at bag widths whose
    offsets are not 16-byte aligned (P = 1, 3, 99, 101: scalar id loads)."""
    from repro_torch.kernels.embedding_bag import ops as eops
    ids, w, tbl = _bag_inputs(card, 203, P, 3000, D, getattr(torch, dtype),
                              seed=7 * D + P)
    reset_launches()
    out = eops.embedding_bag(ids, w, tbl)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_bag"] == 1
    _bag_check(out, ids, w, tbl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_kernel_bag_of_one_id(card, dtype):
    """Bags whose slots all hold one id (a hot Zipf row), with weights
    that differ: the sum in the kernel's fixed order against the plain
    one; two launches bit-equal."""
    from repro_torch.kernels.embedding_bag import ops as eops
    ids, w, tbl = _bag_inputs(card, 64, 100, 500, 18, getattr(torch, dtype),
                              seed=11)
    ids[:] = ids[:, :1]                  # each bag: its first id, 100 times
    ids[5] = 7
    out = eops.embedding_bag(ids, w, tbl)
    again = eops.embedding_bag(ids, w, tbl)
    torch.cuda.synchronize()
    _bag_check(out, ids, w, tbl)
    assert torch.equal(out, again)


def test_embedding_bag_kernel_reads_an_unaligned_table(card):
    """A table view 4 bytes off a 16-byte boundary: the C side narrows the
    row vectors (float2 to float) and the sum is the same."""
    from repro_torch.kernels.embedding_bag import ops as eops
    ids, w, _ = _bag_inputs(card, 100, 100, 400, 18, torch.float32, seed=12)
    flat = torch.randn(400 * 18 + 1, device=card)
    tbl = flat[1:].view(400, 18)
    assert tbl.is_contiguous() and tbl.data_ptr() % 16 == 4
    out = eops.embedding_bag(ids, w, tbl)
    torch.cuda.synchronize()
    _bag_check(out, ids, w, tbl)


def test_embedding_bag_kernel_empty_table(card):
    """V = 0: every slot adds nothing (the kernel has no row 0 to read in
    a pad's place), the output is zeros."""
    from repro_torch.kernels.embedding_bag import ops as eops
    ids = torch.full((9, 7), -1, dtype=torch.int32, device=card)
    ids[0, 0] = 3                                  # past the empty table
    w = torch.ones((9, 7), device=card)
    out = eops.embedding_bag(ids, w, torch.zeros((0, 18), device=card))
    torch.cuda.synchronize()
    assert out.shape == (9, 18) and (out == 0).all()


@pytest.mark.parametrize("D", [1, 2, 17, 18, 19, 36, 64, 65, 128, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_plan_is_the_c_sides(card, D, dtype):
    from repro_torch.kernels.embedding_bag import ops as eops
    dt = getattr(torch, dtype)
    assert eops.plan_export(D, dt) == eops.bag_plan(D, dt)


def test_embedding_bag_kernel_does_not_spill(card):
    from repro_torch.kernels.embedding_bag import ops as eops
    a = eops.kernel_attrs()
    assert a["spill_bytes"] == 0, a


def test_dien_serve_on_the_card_launches_two_bags(card):
    """A DIEN forward at a small batch on the card: two embedding_bag
    launches and no other kernel; prob equal to the same forward with the
    plain bag_lookup_reduce patched in, to 1e-5."""
    from repro_torch.configs import dien as PD
    from repro_torch.data.synthetic import behavior_stream
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.steps import build_ctr_serve
    from repro_torch.models import recsys as PR
    cfg = dataclasses.replace(PD.CONFIG, item_vocab=50_000, cate_vocab=1000)
    params = PR.dien_init(cfg, seed=0, device=card)
    batch = next(behavior_stream(64, cfg.seq_len, cfg.item_vocab,
                                 cfg.cate_vocab, seed=0))
    batch["hist_mask"][3] = 0.0
    step = build_ctr_serve(lambda p, b: PR.dien_apply(
        p, cfg, b["hist_items"], b["hist_cates"], b["target_item"],
        b["target_cate"], b["hist_mask"]))
    reset_launches()
    prob = step(params, batch)["prob"]
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"embedding_bag": 2}
    kernel_bag = PR.bag_lookup_reduce
    PR.bag_lookup_reduce = embedding_bag_ref
    try:
        plain = step(params, batch)["prob"]
    finally:
        PR.bag_lookup_reduce = kernel_bag
    assert prob.shape == (64,) and torch.isfinite(prob).all()
    torch.testing.assert_close(prob, plain, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the distributed merge --
@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_world_size_one_production_search_is_the_compact_search(
        card, tmp_path, store_dtype):
    """One rank over NCCL: make_production_search and build_irli_serve on
    the card (irli_topk, freq_topc, quant_rerank for int8) are bit-equal to
    the compact search (ids, scores, n_candidates)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.distributed import make_production_search
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.search_api import SearchParams
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_irli_serve

    rng = np.random.default_rng(4)
    L, D = 20_000, 32
    base = torch.from_numpy(rng.normal(size=(L, D)).astype(np.float32)).to(
        card)
    q = torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32)).to(
        card)
    idx = IRLIIndex(IRLIConfig(d=D, n_labels=L, n_buckets=200, n_reps=4,
                               d_hidden=64), device=card)
    idx.build_index()
    payload = base if store_dtype == "fp32" else encode(base, "int8", 8)
    sp = SearchParams(m=4, tau=1, k=10, topC=512, mode="compact",
                      store_dtype=store_dtype)
    want = idx.search(q, payload, sp)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        reset_launches()
        got = make_production_search(mesh, sp)(idx.params, idx.index.members,
                                               payload, q)
        torch.cuda.synchronize()
        assert LAUNCHES["irli_topk"] == 1 and LAUNCHES["freq_topc"] == 1
        assert LAUNCHES["quant_rerank"] == (store_dtype == "int8")
        params = {"scorer": idx.params, "members": idx.index.members}
        if store_dtype == "fp32":
            params["base"] = base
        else:
            params.update(base_codes=payload.codes,
                          base_scales=payload.scales)
        out = build_irli_serve(mesh, 4, 1, 10, store_dtype=store_dtype,
                               store_block=8)(params, {"queries": q})
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.n_candidates, want.n_candidates)
    want = idx.search(q, payload, sp.replace(topC=1024))
    assert torch.equal(out["ids"], want.ids)
    assert torch.equal(out["scores"], want.scores)


# ------------------------------------------------- the static contracts --
def test_registry_audited_on_the_card(card):
    """Every registered contract at the reference's fixture sizes on the
    card (the mesh contracts in a spawned world of 4 gloo ranks on it),
    every control tripped, the card-side sightings held by a kernel that
    launched in the call."""
    from repro_torch.analysis import REGISTRY, load_all
    from repro_torch.launch.audit import audit_ids
    held = {}
    for r in audit_ids(load_all(), device=card):
        assert r.passed and not r.skipped, r.to_dict()
        assert r.control_ok is not False, r.to_dict()
        if any(c.negative for c in REGISTRY.get(r.contract_id).checks):
            assert r.control_ok is True, r.to_dict()
        held.update({r.contract_id: c.held_by for c in r.checks
                     if c.held_by})
    assert held == {
        "fit.round_no_dense_affinity": "irli_topk",
        "online.refit_round_no_dense_affinity": "irli_topk",
        "kernels.irli_topk.no_onehot_select": "irli_topk",
        "kernels.quant_rerank.coarse_dequant_bounded": "quant_rerank",
        "query.mega_single_dispatch": "mega_query"}


def test_mega_fixture_is_one_kernel_and_its_control_many(card):
    """query.mega_single_dispatch at the reference's toy geometry: one
    CUDA kernel, mega_query, and no memcpy; the staged split of the same
    search dispatches irli_topk, freq_topc and quant_rerank among many
    kernels."""
    from repro_torch.analysis import fixtures as FX
    from repro_torch.analysis.contracts import on_device
    from repro_torch.analysis.contracts import max_dispatches
    with on_device(card):
        fx, ctl = FX.mega_store_search(), FX.mega_split_control()
        assert max_dispatches(1).run(fx).passed
        assert not max_dispatches(1).run(ctl).passed
        mega, split = fx.trace(), ctl.trace()
    assert len(mega.kernels) == 1 and "mega_query" in mega.kernels[0]
    assert mega.copies == [] and mega.launches == {"mega_query": 1}
    assert not mega.unseen() and not split.unseen()
    assert mega.sites == ["mega_query.mega_search"]
    assert len(split.kernels) > 1
    assert split.launches == {"irli_topk": 1, "freq_topc": 1,
                              "quant_rerank": 1}


def test_a_blind_profiler_fails_the_single_launch_proof(card, monkeypatch):
    """With no lead-in kernel seen, the prefix the profiler drops from a
    window may hold kernels of the call: max_dispatches calls that record
    blind and fails it, though mega_query itself was seen."""
    from repro_torch.analysis import fixtures as FX
    from repro_torch.analysis import trace as TR
    from repro_torch.analysis.contracts import max_dispatches, on_device
    monkeypatch.setattr(TR, "LEAD_IN", 0)
    with on_device(card):
        fx = FX.mega_store_search()
        r = max_dispatches(1).run(fx)
    assert fx.trace().lead_in == 0
    assert not r.passed and "BLIND" in r.detail, r.detail


def test_seeded_split_dispatch_detected_on_the_card(card):
    from repro_torch.launch.audit import audit_seeded
    r = audit_seeded("split_dispatch", device=card)
    assert not r.passed
    assert "CUDA kernel" in r.checks[0].detail


def test_backward_and_collectives_recorded_on_the_card(card, tmp_path):
    """The autograd engine's device thread runs the backward under the
    caller's dispatch mode; gloo's collectives on CUDA tensors appear as
    c10d ops."""
    import datetime

    import torch.distributed as dist

    from repro_torch.analysis import trace as TR
    from repro_torch.analysis.collectives import CollectiveRecorder
    w = torch.randn(16, 40, device=card, requires_grad=True)
    x = torch.randn(6, 16, device=card)

    def step(ww):
        (x @ ww).relu().sum().backward()
        return ww.grad
    ops = {r.op for r in TR.record_call(step, (w,), device=card).ops}
    assert "aten.threshold_backward.default" in ops
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        t = torch.arange(6, dtype=torch.float32, device=card)
        with CollectiveRecorder() as rec:
            parts = [torch.empty_like(t)]
            dist.all_gather(parts, t)
            dist.all_reduce(t)
    finally:
        dist.destroy_process_group()
    assert rec.calls == [("all_gather", 24), ("all_reduce", 24)]


# ------------------------------------------------ a launch from a new thread --
def _tma_case(card, kernel):
    """(fn, args) of one TMA kernel's toy call: the analysis fixtures for
    mega_query (R = 2, Q = 6), irli_topk and distance_topk; a bf16
    flash_attention at [1, 2, 256, 64]."""
    from repro_torch.analysis import fixtures as FX
    from repro_torch.analysis.contracts import on_device
    from repro_torch.kernels.flash_attention import ops as faops
    with on_device(card):
        if kernel == "mega_query":
            fx = FX.mega_store_search()
        elif kernel == "irli_topk":
            fx = FX.irli_topk_fixture()
        elif kernel == "distance_topk":
            fx = FX.distance_topk_fixture()
        else:
            g = torch.Generator(device=card).manual_seed(0)
            qkv = [torch.randn(1, 2, 256, 64, device=card, generator=g)
                   .bfloat16() for _ in range(3)]
            return faops.flash_attention, tuple(qkv)
    return fx.fn, fx.args


def _flat(r):
    return [r] if isinstance(r, torch.Tensor) else [t for x in r
                                                    for t in _flat(x)]


@pytest.mark.parametrize("kernel", ["mega_query", "irli_topk",
                                    "distance_topk", "flash_attention"])
def test_tma_kernel_launches_from_a_thread_that_set_no_device(card, kernel):
    """The main thread makes 300 launches of the kernel and 1,000 of
    irli_topk; then a new thread that never sets a device, whose first CUDA
    call is the kernel's launch (its outputs come from the caching
    allocator), runs the same call 20 times: every result bit-equal to the
    main thread's. Such a thread has no current context until the runtime
    binds one, and the driver refuses to encode a tensor map without one
    (cudaError 1 from mega_query and irli_topk, 801 from flash_attention,
    before kernels/tma.cuh's bind_context)."""
    fn, args = _tma_case(card, kernel)
    irli_fn, irli_args = _tma_case(card, "irli_topk")
    want = _flat(fn(*args))
    for _ in range(300):
        fn(*args)
    for _ in range(1000):
        irli_fn(*irli_args)
    torch.cuda.synchronize()
    reset_launches()
    out = {}

    def worker():
        try:
            out["got"] = [_flat(fn(*args)) for _ in range(20)]
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (raised below, in pytest)
            out["err"] = e

    import threading
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "err" in out:
        raise out["err"]
    assert LAUNCHES[kernel] == 20
    for got in out["got"]:
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ the Trainer --
def test_trainer_crash_resume_is_bit_identical_on_the_card(card, tmp_path):
    """The Trainer over build_irli_fit_parts on the card (sigmoid_bce, ANN,
    the kernels on the fit's path): 3 rounds uninterrupted, then crashed
    before round 2 and resumed from round 1's checkpoint; assign, params,
    the generator state and round 2's loss bit-equal. Per round one
    bce_logits launch a train step, one irli_topk an affinity chunk, one
    kchoice."""
    from repro_torch.core.index import IRLIConfig
    from repro_torch.fit.engine import FitEngine
    from repro_torch.launch.steps import build_irli_fit_parts
    from repro_torch.train.trainer import (SimulatedFailure, Trainer,
                                           TrainerConfig)
    cfg = IRLIConfig(d=32, n_labels=2000, n_buckets=64, n_reps=4,
                     d_hidden=64, K=4, rounds=3, epochs_per_round=2,
                     batch_size=256, lr=2e-3, loss="sigmoid_bce",
                     affinity_chunk=512, seed=0)
    rng = np.random.default_rng(0)
    base = rng.normal(size=(2000, 32)).astype(np.float32)
    labels = rng.integers(0, 2000, (2000, 8)).astype(np.int32)

    def trainer(name, fail_at=None):
        parts = build_irli_fit_parts(cfg, base, labels, label_vecs=base,
                                     device=card)
        return Trainer(TrainerConfig(total_steps=3, checkpoint_every=2,
                                     fail_at_step=fail_at), *parts,
                       str(tmp_path / name), device=card)

    reset_launches()
    ref = trainer("ref")
    out = ref.run()
    steps = FitEngine(cfg, None).batch_plan(2000)[0]
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "bce_logits": 3 * steps, "irli_topk": 3 * 4, "kchoice": 3}
    with pytest.raises(SimulatedFailure):
        trainer("crash", fail_at=2).run()
    res = trainer("crash")
    assert res.resumed and res.start_step == 2
    assert res.state["assign"].is_cuda and res.state["rng"].device.type \
        == "cpu"
    rout = res.run()
    assert torch.equal(ref.state["assign"], res.state["assign"])
    assert torch.equal(ref.state["rng"], res.state["rng"])
    for k, v in ref.state["params"].items():
        assert torch.equal(v, res.state["params"][k]), k
    assert out["metrics"][2]["loss"] == rout["metrics"][0]["loss"]


# ---------------------------------------------- the LM's serving path ----
def _router_lists(kind, G, T, E, K, seed):
    """The MoE router's candidates: each token's top-K experts of softmax
    logits [G, T, E] (stable: a tie to the smaller id), int32 [G, T, K],
    on the CPU. "equal": every logit 0, so every token's list is 0..K-1
    and every pick a tie of loads."""
    from repro_torch.core.topk import topk_stable
    rng = np.random.default_rng(seed)
    lg = (np.zeros((G, T, E)) if kind == "equal"
          else rng.normal(size=(G, T, E))).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(lg), dim=-1)
    return topk_stable(probs, K)[1].to(torch.int32)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("T", [1, 33, 4096])
@pytest.mark.parametrize("E", [8, 128])
@pytest.mark.parametrize("slots", [1, 2])
def test_kchoice_slots_match_plain_on_router_lists(card, slots, E, T, K, G):
    """The MoE router's walk (tokens in order, ``slots`` distinct picks a
    token, each the least-loaded of its K not yet taken): one launch,
    bit-equal to kchoice_ref with the same slots, its rounds the plain
    schedule's."""
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.kchoice.ref import kchoice_ref, kchoice_windows
    topi = _router_lists("random", G, T, E, K, T + E + K)
    order = torch.arange(T, dtype=torch.int32).expand(G, T).contiguous()
    rounds = torch.zeros(G, dtype=torch.int32, device=card)
    reset_launches()
    got = kops.kchoice(topi.to(card), order.to(card), B=E, slots=slots,
                       rounds=rounds)
    torch.cuda.synchronize()
    assert LAUNCHES["kchoice"] == 1
    want = kchoice_ref(topi, order, B=E, slots=slots)
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    _, plain_rounds = kchoice_windows(topi, order, B=E, slots=slots)
    assert rounds.tolist() == plain_rounds.tolist()


@pytest.mark.parametrize("E", [8, 128])
@pytest.mark.parametrize("slots", [1, 2])
def test_kchoice_slots_at_all_equal_logits(card, slots, E):
    """Every token's candidates are experts 0..3 and every pick a tie of
    loads: the first in choice order wins each, bit-equal to the plain
    walk (which round-robins the four experts)."""
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.kchoice.ref import kchoice_ref
    G, T = 3, 1000
    topi = _router_lists("equal", G, T, E, 4, 0)
    order = torch.arange(T, dtype=torch.int32).expand(G, T).contiguous()
    got = kops.kchoice(topi.to(card), order.to(card), B=E, slots=slots)
    want = kchoice_ref(topi, order, B=E, slots=slots)
    assert torch.equal(got.cpu(), want)
    assert set(want.flatten().tolist()) == {0, 1, 2, 3}


def test_kchoice_refuses_slots_it_cannot_walk(card):
    from repro_torch.kernels.kchoice import ops as kops
    topi = torch.zeros((1, 8, 4), dtype=torch.int32, device=card)
    order = torch.arange(8, dtype=torch.int32, device=card)[None]
    for bad in (0, 5):
        with pytest.raises(ValueError, match="slots"):
            kops.kchoice(topi, order, B=8, slots=bad)


def test_vocab_head_probe_is_one_irli_topk_launch(card):
    """The vocabulary head's probe on the card is one irli_topk launch,
    equal to the plain top-m of the probabilities (core/query.top_buckets)
    outside near ties at the m cut; the candidate ids equal the same
    gather of the plain probe's buckets, the logits the CPU's to 1e-5."""
    from repro_torch.core import partition as PTN
    from repro_torch.core import query as TQ
    from repro_torch.core import vocab_head as PV
    from repro_torch.core.network import scorer_logits
    V, d, B, R, Bq, m = 4096, 64, 64, 4, 8, 8
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn((V, d), generator=gen).to(torch.bfloat16)
    sp = {"w1": torch.randn((R, d, 96), generator=gen) / d ** 0.5,
          "b1": torch.zeros((R, 96)),
          "w2": torch.randn((R, 96, B), generator=gen) / 96 ** 0.5,
          "b2": torch.zeros((R, B))}
    index = PTN.build_inverted_index(PTN.hash_init(V, B, R, 0), B,
                                     max_load=2 * V // B)
    h = torch.randn((Bq, d), generator=gen).to(torch.bfloat16)
    on = lambda t: t.to(card)
    csp = {k: on(v) for k, v in sp.items()}
    cindex = PTN.InvertedIndex(on(index.members), on(index.load),
                               index.max_load)
    reset_launches()
    bidx = PV.probe_buckets(csp, on(h), m)
    torch.cuda.synchronize()
    assert LAUNCHES["irli_topk"] == 1
    pv, pi = TQ.top_buckets(sp, h, m + 1)
    logits = scorer_logits(sp, h)
    kv = logits.gather(-1, bidx.long().cpu())
    same_topm(kv, bidx.cpu(), logits.gather(-1, pi), pi)
    cands, cl = PV.candidate_token_logits(csp, cindex, on(embed), on(h), m=m)
    want = TQ.gather_members(index.members, bidx.cpu())
    assert torch.equal(cands.cpu(), want)
    rows = embed[want.clamp(min=0).long()].float()
    ref = torch.einsum("bcd,bd->bc", rows, h.float())
    ref = ref.masked_fill(want < 0, float("-inf"))
    torch.testing.assert_close(cl.cpu(), ref, rtol=1e-5, atol=1e-5)
    tok = PV.greedy_token(csp, cindex, on(embed), on(h), m=m)
    assert torch.equal(tok.cpu(), want.gather(1, ref.argmax(1)[:, None])[:, 0])


@pytest.mark.parametrize("router", ["topk", "irli_kchoice"])
def test_lm_decode_step_on_the_card_equals_the_cpu(card, router):
    """A small fp32 mixtral-shaped model (SWA ring of 8, 4 experts top-2)
    decoded 12 steps on the card and on the CPU from the same weights:
    logits and caches to 1e-4 (fp32 GEMMs in another order), next tokens
    equal; under irli_kchoice one kchoice launch a layer a step."""
    from repro_torch.launch.steps import build_lm_decode
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import LMConfig, init_cache, lm_init
    cfg = LMConfig(name="mixtral-tiny", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                   attn_pattern=("swa",), window=8, tie_embeddings=False,
                   param_dtype="float32",
                   moe=MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                                 router=router))
    cpu = lm_init(cfg, seed=0, device="cpu")
    gpu = lm_init(cfg, seed=0, device="cpu").to(card)
    B, ctx = 3, 16
    cc, gc = (init_cache(cfg, B, ctx, device="cpu"),
              init_cache(cfg, B, ctx, device=card))
    step = build_lm_decode(cfg, ctx)
    toks = torch.randint(0, 512, (12, B), generator=torch.Generator()
                         .manual_seed(1))
    for s in range(12):
        pos = torch.tensor([s, s + 2, s + 5])
        reset_launches()
        g = step(gpu, {"token": toks[s], "pos": pos, "caches": gc})
        torch.cuda.synchronize()
        assert LAUNCHES["kchoice"] == (2 if router == "irli_kchoice" else 0)
        c = step(cpu, {"token": toks[s], "pos": pos, "caches": cc})
        torch.testing.assert_close(g["logits"].cpu(), c["logits"],
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(g["next_token"].cpu(), c["next_token"])
    for a, b in zip(gc, cc):
        torch.testing.assert_close(a["k"].cpu(), b["k"], rtol=1e-4,
                                   atol=1e-4)


def test_moe_tokens_bf16_on_the_card_accumulates_in_fp32(card):
    """_moe_tokens at bf16 on the card (the experts' products summed in
    fp32, one bf16 matmul with an fp32 output) against the same block on
    the CPU (fp32 matmuls of the upcast operands): within bf16 rounding of
    the output (2e-2), the same routing."""
    from repro_torch.models import moe as PMOE
    cfg = PMOE.MoEConfig(d_model=256, d_ff=512, n_experts=8, top_k=2,
                         router="irli_kchoice")
    gen = torch.Generator().manual_seed(0)
    p = PMOE.moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn((200, 256), generator=gen).to(torch.bfloat16)
    y, _ = PMOE._moe_tokens(p, cfg, x)
    gp = {k: ({n: v.to(card) for n, v in t.items()}) for k, t in p.items()}
    reset_launches()
    gy, _ = PMOE._moe_tokens(gp, cfg, x.to(card))
    torch.cuda.synchronize()
    assert LAUNCHES["kchoice"] == 1
    torch.testing.assert_close(gy.cpu().float(), y.float(), rtol=2e-2,
                               atol=2e-2)


# ------------------------------------------- train paths under a gradient --
def _tiny_dien():
    from repro_torch.models import recsys as PR
    cfg = PR.DIENConfig(embed_dim=8, seq_len=12, gru_dim=16, mlp=(16, 8),
                        item_vocab=200, cate_vocab=50)
    rng = np.random.default_rng(0)
    B = 16
    batch = {"hist_items": rng.integers(0, 200, (B, 12)).astype(np.int32),
             "hist_cates": rng.integers(0, 50, (B, 12)).astype(np.int32),
             "target_item": rng.integers(0, 200, B).astype(np.int32),
             "target_cate": rng.integers(0, 50, B).astype(np.int32),
             "hist_mask": (rng.random((B, 12)) < 0.8).astype(np.float32),
             "label": rng.integers(0, 2, B).astype(np.float32)}
    return cfg, batch


def _dien_table_grad(params, cfg, batch, dev):
    from repro_torch.models import recsys as PR
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    table = params["item_emb"]["table"]
    table.requires_grad_(True)
    logit = PR.dien_apply(params, cfg, b["hist_items"], b["hist_cates"],
                          b["target_item"], b["target_cate"],
                          b["hist_mask"])
    (g,) = torch.autograd.grad(logit.sum(), table)
    table.requires_grad_(False)
    return g


def test_dien_table_gradient_on_the_card_equals_the_cpu(card):
    """Plain autograd over dien_apply: the item table's gradient on the
    card equals the CPU's, history rows included. A kernel launched
    through ctypes has no grad_fn: had the history sum gone through
    embedding_bag under the gradient, the history rows' share of it would
    be missing on the card."""
    import copy

    from repro_torch.models import recsys as PR
    cfg, batch = _tiny_dien()
    cpu = PR.dien_init(cfg, seed=0, device="cpu")
    dev = copy.deepcopy(cpu).to(card)
    reset_launches()
    g_card = _dien_table_grad(dev, cfg, batch, card)
    launched = LAUNCHES["embedding_bag"]
    g_cpu = _dien_table_grad(cpu, cfg, batch, "cpu")
    scale = float(g_cpu.abs().max())
    assert float((g_card.cpu() - g_cpu).abs().max()) <= 1e-5 * scale
    assert launched == 0


def test_kernel_entries_refuse_or_are_not_reached_under_a_gradient(card):
    """The gradient table of the train paths: flash_attention and
    embedding_bag raise under a gradient; attend_train (a full-attention
    config the kernel takes) and dien_apply under a gradient launch no
    kernel, and the serve forms still launch theirs."""
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.models import attention as PA
    from repro_torch.models import recsys as PR
    from repro_torch.models.module import tensor_tree
    ids = torch.zeros((4, 3), dtype=torch.int32, device=card)
    w = torch.ones((4, 3), device=card)
    table = torch.randn(10, 8, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        eops.embedding_bag(ids, w, table)
    with torch.no_grad():
        eops.embedding_bag(ids, w, table)
    cfg = PA.AttnConfig(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                        q_chunk=16)
    gen = torch.Generator(device=card).manual_seed(0)
    p = PA.attn_init(gen, cfg)
    x = torch.randn(2, 64, 64, device=card, generator=gen)
    reset_launches()
    with torch.no_grad():
        PA.attend_train(p, cfg, x)
    assert LAUNCHES["flash_attention"] == 1
    reset_launches()
    y = PA.attend_train(p, cfg, x.requires_grad_(True))
    y.sum().backward()
    assert LAUNCHES["flash_attention"] == 0 and x.grad is not None
    dcfg, batch = _tiny_dien()
    params = tensor_tree(PR.dien_init(dcfg, seed=0, device=card))
    b = {k: torch.as_tensor(v, device=card) for k, v in batch.items()}
    args = (b["hist_items"], b["hist_cates"], b["target_item"],
            b["target_cate"], b["hist_mask"])
    reset_launches()
    with torch.no_grad():
        PR.dien_apply(params, dcfg, *args)
    assert LAUNCHES["embedding_bag"] == 2
    reset_launches()
    _dien_table_grad(params, dcfg, batch, card)
    assert LAUNCHES["embedding_bag"] == 0


def test_f32_bmm_gradient_against_the_fp32_upcast_product(card):
    """bf16 operands, fp32 output: the forward within fp32 rounding of the
    upcast product, and both input gradients (bf16 products with an fp32
    output, cast to bf16) within bf16 rounding of the upcast product's."""
    from repro_torch.models.moe import _f32_bmm
    gen = torch.Generator(device=card).manual_seed(1)
    a = torch.randn(4, 96, 128, device=card, generator=gen).bfloat16()
    b = torch.randn(4, 128, 80, device=card, generator=gen).bfloat16()
    g = torch.randn(4, 96, 80, device=card, generator=gen)
    a.requires_grad_(True)
    b.requires_grad_(True)
    y = _f32_bmm(a, b)
    assert y.dtype == torch.float32
    ga, gb = torch.autograd.grad(y, (a, b), g)
    af, bf = a.detach().float().requires_grad_(), b.detach().float(
        ).requires_grad_()
    yf = torch.bmm(af, bf)
    ra, rb = torch.autograd.grad(yf, (af, bf), g)
    assert float((y - yf).detach().abs().max()) \
        <= 1e-5 * float(yf.detach().abs().max())
    assert ga.dtype == gb.dtype == torch.bfloat16
    for got, want in ((ga, ra), (gb, rb)):
        err = float((got.float() - want).abs().max())
        assert err <= 1e-2 * float(want.abs().max()), err


@pytest.mark.parametrize("name", ["gemma-7b", "mixtral-8x7b kchoice",
                                  "dlrm"],
                         ids=["gemma-7b", "mixtral-8x7b", "dlrm"])
def test_train_step_on_the_card_equals_the_cpu(card, name):
    """One train step on the card and on the CPU from the same state and
    batch (fp32, TF32 off): loss to 1e-4 relative, the gradient (AdamW's
    first moment) leaf by leaf to 1e-4 of the leaf's largest |g|. The only
    kernel a train step launches is kchoice, mixtral's k-choice router:
    one a layer a microbatch forward and one a recompute."""
    from repro_torch.checkpoint.checkpointer import flatten_with_paths
    from repro_torch.launch.step_cases import step_cases
    from repro_torch.models.module import tree_to
    init, (step, opt), batch = step_cases(0)[name]
    p_cpu = init("cpu")
    p_card = tree_to(p_cpu, card)
    reset_launches()
    new_card, m_card = step({"params": p_card, "opt": opt.init(p_card)},
                            batch)
    torch.cuda.synchronize()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    want = {"kchoice": 2 * 2 * 2} if name == "mixtral-8x7b kchoice" \
        else {}
    assert launched == want
    new_cpu, m_cpu = step({"params": p_cpu, "opt": opt.init(p_cpu)}, batch)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
        <= 1e-4 * abs(float(m_cpu["loss"]))
    for (path, a), (_, b) in zip(flatten_with_paths(new_card["opt"]["m"]),
                                 flatten_with_paths(new_cpu["opt"]["m"])):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1e-30), (path, err)


# ------------------------------------------------- the LM on a mesh --------
@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A (data 1, model 1) DeviceMesh over an NCCL group of world size 1 in
    this process (a FileStore rendezvous in tmp_path)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "nccl_store"), 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["gemma-7b", "mixtral-8x7b"])
def test_one_rank_dtensor_lm_step_equals_the_meshless_step(nccl_mesh, name):
    """build_lm_train_step(mesh=) on the card at world size 1: two steps
    from the same state equal the meshless steps (loss, grad_norm, every
    state leaf), and every DTensor leaf keeps its placements."""
    from repro_torch.configs.lm_common import lm_rules
    from repro_torch.launch import steps as PS
    from repro_torch.launch.train import LM_VARIANTS
    from repro_torch.models.module import (flatten_with_paths,
                                           tensor_tree, tree_to)
    from repro_torch.models.transformer import lm_init
    cfg = LM_VARIANTS[name]
    dev = torch.device("cuda", 0)
    params = tensor_tree(lm_init(cfg, seed=0, device=dev))
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    step, opt = PS.build_lm_train_step(cfg, "adamw", n_micro=2, lr=1e-3)
    mstep, _ = PS.build_lm_train_step(cfg, "adamw", n_micro=2, lr=1e-3,
                                      mesh=nccl_mesh)
    state = {"params": tree_to(params, dev), "opt": opt.init(params)}
    specs = lm_rules(cfg).specs(params)
    placed = PS.place_train_state(
        {"params": params, "opt": opt.init(params)}, specs,
        PS.opt_state_specs("adamw", params, specs, nccl_mesh), nccl_mesh)
    before = {p: tuple(t.placements) for p, t in flatten_with_paths(placed)
              if hasattr(t, "placements")}
    for b in batches:
        state, m = step(state, b)
        placed, mm = mstep(placed, b)
        assert float(mm["loss"]) == float(m["loss"])
        assert float(mm["grad_norm"]) == float(m["grad_norm"])
    for (p, a), (_, c) in zip(flatten_with_paths(state),
                              flatten_with_paths(placed)):
        got = c.to_local() if hasattr(c, "to_local") else c
        assert torch.equal(got.to(a.device), a), p
    assert {p: tuple(t.placements) for p, t in flatten_with_paths(placed)
            if hasattr(t, "placements")} == before


def test_kchoice_kernel_routes_a_dtensor_moe_block(nccl_mesh):
    """The k-choice router on DTensors: the routing runs on the whole
    token block's local tensors (models.module.on_whole), one kchoice
    launch, the block's output equal to the meshless block's."""
    from repro_torch.configs.lm_common import lm_rules
    from repro_torch.launch.train import LM_VARIANTS
    from repro_torch.models import moe as MO
    from repro_torch.models.module import place, place_tree
    cfg = MO.MoEConfig(d_model=64, d_ff=128, n_experts=8, top_k=2,
                       router="irli_kchoice")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = MO.moe_init(gen, cfg)
    x = torch.randn((2, 64, 64), generator=gen, device=dev)
    rules = lm_rules(dataclasses.replace(LM_VARIANTS["mixtral-8x7b"],
                                         moe=cfg))
    placed = place_tree(p, rules.specs({"moe": p})["moe"], nccl_mesh)
    xd = place(x, (("data",), None, None), nccl_mesh)
    with torch.no_grad():
        want, _ = MO.moe_apply(p, cfg, x)
        reset_launches()
        got, _ = MO.moe_apply(placed, cfg, xd)
        torch.cuda.synchronize()
    assert LAUNCHES["kchoice"] == 1
    assert torch.equal(got.full_tensor(), want)


def test_kchoice_kernel_routes_a_dtensor_moe_block_by_rows(nccl_mesh):
    """The per-row dispatch (ffn_chunk below the block's tokens: 2
    sequence chunks) on DTensors: each chunk's routing runs on the data
    rank's own rows (models.module.on_rows), one kchoice launch a chunk,
    the output split over "data" and equal to the meshless block's."""
    from torch.distributed.tensor import Shard

    from repro_torch.configs.lm_common import lm_rules
    from repro_torch.launch.train import LM_VARIANTS
    from repro_torch.models import moe as MO
    from repro_torch.models.module import place, place_tree
    cfg = MO.MoEConfig(d_model=64, d_ff=128, n_experts=8, top_k=2,
                       router="irli_kchoice", ffn_chunk=64)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = MO.moe_init(gen, cfg)
    x = torch.randn((2, 64, 64), generator=gen, device=dev)
    rules = lm_rules(dataclasses.replace(LM_VARIANTS["mixtral-8x7b"],
                                         moe=cfg))
    placed = place_tree(p, rules.specs({"moe": p})["moe"], nccl_mesh)
    xd = place(x, (("data",), None, None), nccl_mesh)
    with torch.no_grad():
        want, _ = MO.moe_apply(p, cfg, x)
        reset_launches()
        got, _ = MO.moe_apply(placed, cfg, xd)
        torch.cuda.synchronize()
    assert LAUNCHES["kchoice"] == 2
    assert got.placements[0] == Shard(0)
    assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_on_cuda_tensors_equals_the_cpu(nccl_mesh, kind):
    """compress_grads on the card = on the CPU with the same noise (int8
    codes and top-k carriers exactly, scales and residuals to 1e-6), and
    compressed_psum over a one-rank "data" axis = the decompressed
    payload."""
    from repro_torch.models.module import flatten_with_paths
    from repro_torch.optim import compression as C
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((33, 17)).astype(np.float32),
         "b": np.round(rng.standard_normal((64,)), 1).astype(np.float32)}
    u = [rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
         for _, v in sorted(g.items())]
    cfg = C.CompressionConfig(kind=kind, topk_frac=0.1)
    out = {}
    for dev in ("cpu", "cuda"):
        gt = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
        noise = [torch.from_numpy(x).to(dev) for x in u]
        payload, dec, ef = C.compress_grads(cfg, gt, C.ef_init(gt), noise)
        out[dev] = (payload, dec(payload), ef)
        if dev == "cuda":
            summed, ef2 = C.compressed_psum(cfg, gt, C.ef_init(gt), noise,
                                            "data", mesh=nccl_mesh)
            for (_, a), (_, b) in zip(flatten_with_paths(summed),
                                      flatten_with_paths(dec(payload))):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        if kind == "int8":
            assert torch.equal(a[0], b[0].cpu())
            torch.testing.assert_close(a[1], b[1].cpu(), rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b.cpu())
    for (_, a), (_, b) in zip(flatten_with_paths(out["cpu"][2]),
                              flatten_with_paths(out["cuda"][2])):
        torch.testing.assert_close(a, b.cpu(), rtol=1e-6, atol=1e-6)
