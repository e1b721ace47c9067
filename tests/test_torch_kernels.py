"""The port's kernels' plain versions against the JAX package's oracles on
the CPU: integers bit-exact, floats to 1e-5. The CUDA kernels against these
plain versions, on the card, are in test_torch_cuda.py. Also the kernel
build's content hash (no nvcc needed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.query import sorted_frequency_topC  # noqa: E402
from repro.core import network as JN  # noqa: E402
from repro.kernels.bce_logits.bce_logits import bce_logits as j_bce  # noqa: E402,E501
from repro.kernels.bce_logits.ref import bce_logits_ref as j_bce_ref  # noqa: E402,E501
from repro.kernels.freq_topc.ref import freq_topc_ref as j_freq  # noqa: E402
from repro.kernels.irli_topk.irli_topk import irli_topk as j_irli  # noqa: E402
from repro.kernels.irli_topk.ref import irli_topk_ref as j_irli_ref  # noqa: E402,E501
from repro.kernels.quant_rerank.ops import _coarse_chunked  # noqa: E402
from repro.kernels.quant_rerank.ref import quant_rerank_ref as j_quant  # noqa: E402,E501
from repro.store.quantized import encode as jencode  # noqa: E402
from repro_torch.kernels import LAUNCHES, on_card, reset_launches  # noqa: E402
from repro_torch.kernels.bce_logits import ops as bops  # noqa: E402
from repro_torch.kernels.bce_logits.ref import (  # noqa: E402
    bce_logits_ref, weighted_bce_ref)
from repro_torch.kernels.kchoice import ops as kops  # noqa: E402
from repro_torch.kernels.kchoice.ref import (  # noqa: E402
    dependence_depth, kchoice_ref, kchoice_windows)
from repro_torch.kernels.freq_topc import ops as fops  # noqa: E402
from repro_torch.kernels.freq_topc.ref import (  # noqa: E402
    freq_topc_radix, freq_topc_ref)
from repro_torch.kernels.irli_topk import ops as iops  # noqa: E402
from repro_torch.kernels.irli_topk.ref import (  # noqa: E402
    irli_topk_ref, same_topm)
from repro_torch.kernels.quant_rerank import ops as qops  # noqa: E402
from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref  # noqa: E402
from repro_torch.store.quantized import encode  # noqa: E402
from torch_freq_cases import (  # noqa: E402
    FREQ_CASES, FREQ_ROW_NAMES, runs_row, freq_rows)
from torch_freq_cases import random_rows as _cands  # noqa: E402


# ------------------------------------------------------------ freq_topc ----


@pytest.mark.parametrize("Q,C0,V,C", FREQ_CASES)
def test_freq_topc_plain_matches_reference_exactly(Q, C0, V, C):
    cands = _cands(Q, C0, V)
    ids, cnt = freq_topc_ref(torch.from_numpy(cands), C=C)
    rids, rcnt = j_freq(jnp.asarray(cands), C=C)
    assert ids.dtype == torch.int32 and cnt.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
    sids, scnt = sorted_frequency_topC(jnp.asarray(cands), C)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(sids))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(scnt))
    assert (ids.numpy()[-1] == -1).all()


def test_freq_topc_dispatch_on_cpu_takes_the_plain_version():
    cands = torch.from_numpy(_cands(6, 160, 60))
    reset_launches()
    ids, cnt = fops.frequent_topc(cands, C=32)
    ref_ids, ref_cnt = freq_topc_ref(cands, C=32)
    assert torch.equal(ids, ref_ids) and torch.equal(cnt, ref_cnt)
    assert all(v == 0 for v in LAUNCHES.values())
    assert [fops.sort_width(c) for c in (1, 32, 33, 32000, 32768)] == [
        32, 32, 64, 32768, 32768]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fops.freq_topc(cands, C=32)
    with pytest.raises(ValueError, match="all on cpu"):
        on_card(cands, torch.empty(1, device="meta"))


def _same_as_references(ids, cnt, cands, C):
    """ids, cnt equal, bit for bit, to the port's plain version, the JAX
    package's oracle and its sorted_frequency_topC."""
    rids, rcnt = freq_topc_ref(torch.from_numpy(cands), C=C)
    assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)
    for jids, jcnt in (j_freq(jnp.asarray(cands), C=C),
                       sorted_frequency_topC(jnp.asarray(cands), C)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("name", FREQ_ROW_NAMES)
def test_freq_topc_radix_schedule_matches_the_references(name):
    """The kernel's schedule (freq_topc_radix: pad key, radix passes in
    chunks, run ends, count windows) on every width and adversarial row the
    card tests run."""
    cands, C = freq_rows()[name]
    ids, cnt = freq_topc_radix(torch.from_numpy(cands), C=C)
    _same_as_references(ids, cnt, cands, C)


@pytest.mark.parametrize("chunk,digit_bits", [(64, 1), (64, 3), (256, 5),
                                              (1024, 2), (32_768, 8)])
@pytest.mark.parametrize("case", ["random", "few ids", "spread counts"])
def test_freq_topc_radix_schedule_in_small_chunks_and_digits(case, chunk,
                                                             digit_bits):
    """Small chunks and digits run the wide kernel's chunked bookkeeping,
    many passes and many count windows on rows the CPU takes in seconds."""
    rng = np.random.default_rng(digit_bits)
    if case == "random":
        cands, C = _cands(3, 777, 300, seed=chunk), 64
    elif case == "few ids":
        cands, C = _cands(4, 1500, 6, seed=chunk), 3
    else:
        cands = np.stack([runs_row(rng, [1, 9, 17, 25, 40, 70], 400),
                          runs_row(rng, [3] * 20 + [50, 90], 400, 5)])
        C = 30
    ids, cnt = freq_topc_radix(torch.from_numpy(cands), C=C, chunk=chunk,
                               digit_bits=digit_bits)
    _same_as_references(ids, cnt, cands, C)


@pytest.mark.parametrize("C0,wide,cluster,threads,slots", [
    (1, 0, 1, 32, 2048), (31, 0, 1, 32, 2048), (777, 0, 1, 32, 2048),
    (2049, 0, 1, 64, 4096), (32_000, 0, 1, 512, 32_768),
    (32_768, 0, 1, 512, 32_768), (32_769, 0, 2, 512, 65_536),
    (65_280, 0, 2, 512, 65_536), (70_000, 0, 3, 512, 98_304),
    (262_144, 0, 8, 512, 262_144), (262_145, 1, 1, 256, 278_528),
    (2 ** 30, 1, 1, 256, 2 ** 30)])
def test_freq_topc_radix_plan_shapes(C0, wide, cluster, threads, slots):
    """The launch plan: one block of up to 512 threads (64 ids a thread)
    holds rows up to 32,768; rows up to 8 chunks of 32,768 take a cluster
    of a block a chunk; wider rows go, in chunks of 256 x 64, through two
    global scratch rows and a [64, chunks] table; shared memory fits one
    block's 232,448 bytes."""
    p = fops.radix_plan(C0, 1_999_999)
    assert (p["wide"], p["cluster"], p["threads"], p["slots"]) == (
        wide, cluster, threads, slots)
    assert p["chunks"] == -(-C0 // (64 * threads)) if wide else (
        p["chunks"] == -(-C0 // 32_768))
    assert p["slots"] >= C0 and p["threads"] % 32 == 0
    assert p["smem_bytes"] <= 232_448
    # a padded row (a pad word every 64), the 16-bit counters (64 digits x
    # threads, a pad word every 16), reduction scratch; the row kernel the
    # cluster's exchange area (3 x 64 + 3 ints, and 8 blocks' 64 + 2), the
    # wide kernel 64 + 64 ints of digit starts and bases, 2 scratch rows
    # and a [64, chunks] table
    rows = min(slots, 64 * threads)
    assert p["smem_bytes"] == (rows + rows // 64 + 34 * threads + 64
                               + (128 if wide else 195 + 8 * 66)) * 4
    assert p["scratch_ints"] == (2 * slots + 64 * p["chunks"]) * wide


@pytest.mark.parametrize("max_id,passes,bits", [
    (-1, 0, 0),                     # no real id: nothing to sort
    (0, 1, 1), (62, 1, 6), (63, 2, 4),
    (1_999_999, 4, 6),              # the deep1b cell's ids: 21 bits
    (2 ** 27 - 2, 5, 6),            # a full deep1b shard: 27 bits
    (2 ** 31 - 2, 6, 6),            # pad 2^31 - 1 still an int32
    (2 ** 31 - 1, 6, 6),            # pad 2^31: 32 bits, unsigned keys
])
def test_freq_topc_radix_plan_passes(max_id, passes, bits):
    """The id sort's passes: b = bit_length(max_id + 1) bits in ceil(b / 6)
    passes of equal width."""
    p = fops.radix_plan(100, max_id)
    assert (p["passes"], p["digit_bits"]) == (passes, bits)


# ----------------------------------------------------------- quant_rerank ---
QUANT_CASES = [
    (8, 200, 32, 24, 8, 16),
    (7, 500, 48, 40, 12, 16),
    (4, 100, 16, 12, 20, 8),      # k > C: clamped to C
]


def _quant_inputs(Q, L, D, C, blk, dtype, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(L, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    cid = rng.integers(-1, L, (Q, C)).astype(np.int32)
    cnt = rng.integers(0, 4, (Q, C)).astype(np.float32)
    cid[-1] = -1                                  # an all-invalid row
    jstore = jencode(jnp.asarray(base), dtype, blk)
    tstore = encode(torch.from_numpy(base), dtype, blk)
    return queries, cid, cnt, jstore, tstore


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("metric", ["angular", "l2"])
@pytest.mark.parametrize("Q,L,D,C,k,blk", QUANT_CASES)
def test_quant_rerank_plain_matches_reference(Q, L, D, C, k, blk, metric,
                                              dtype):
    """The plain version against the reference's full-width oracle and its
    chunked CPU path: ids exact, coarse scores to 1e-5."""
    queries, cid, cnt, jstore, tstore = _quant_inputs(Q, L, D, C, blk, dtype,
                                                      Q + L)
    got = quant_rerank_ref(torch.from_numpy(queries), tstore.codes,
                           tstore.scales, torch.from_numpy(cid),
                           torch.from_numpy(cnt), tau=2, k=k, metric=metric)
    args = (jnp.asarray(queries), jstore.codes, jstore.scales,
            jnp.asarray(cid), jnp.asarray(cnt))
    for ref in (j_quant(*args, tau=2, k=k, metric=metric),
                _coarse_chunked(*args, tau=2, k=min(k, C), metric=metric,
                                chunk=5)):
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5, atol=1e-5)
    assert (got[0].numpy()[-1] == -1).all()


def test_quant_rerank_dispatch_on_cpu_takes_the_plain_version():
    queries, cid, cnt, _, tstore = _quant_inputs(4, 50, 16, 10, 8, "int8",
                                                 0)
    reset_launches()
    got = qops.quant_coarse_topk(torch.from_numpy(queries), tstore.codes,
                                 tstore.scales, torch.from_numpy(cid),
                                 torch.from_numpy(cnt), tau=1, k=4)
    ref = quant_rerank_ref(torch.from_numpy(queries), tstore.codes,
                           tstore.scales, torch.from_numpy(cid),
                           torch.from_numpy(cnt), tau=1, k=4)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert LAUNCHES["quant_rerank"] == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        qops.quant_rerank(torch.from_numpy(queries), tstore.codes,
                          tstore.scales, torch.from_numpy(cid),
                          torch.from_numpy(cnt), tau=1, k=4)


def test_quant_rerank_shared_memory_limit():
    """A pass keeps its valid slots' keys in one block's shared memory
    (room padded to a power of two) beside a tile's ids and positions, the
    select's bins and scratch, and the query: topC 16384 fits up to D =
    22972, one slot more does not. ``pass_slots`` takes all C slots in one
    pass where they fit, else the largest power of two that does (the
    passes then merge in scratch)."""
    fixed = (2 * 1024 + 256 + 64 + 4) * 4
    assert qops.FIXED_INTS * 4 == fixed
    assert qops.smem_bytes(1024, 96) == 1024 * 8 + fixed + 96 * 4
    assert qops.smem_bytes(777, 96) == 1024 * 8 + fixed + 96 * 4
    assert qops.smem_bytes(16384, 22972) <= qops.SMEM_BYTES
    assert qops.smem_bytes(16384, 22973) > qops.SMEM_BYTES
    assert qops.smem_bytes(16385, 1) > qops.SMEM_BYTES
    assert qops.pass_slots(1024, 96) == 1024
    assert qops.pass_slots(777, 96) == 1024
    assert qops.pass_slots(16384, 96) == 16384
    assert qops.pass_slots(20000, 96) == qops.pass_slots(20000, 22972) \
        == 16384
    assert qops.pass_slots(16384, 22973) == 8192
    assert qops.smem_bytes(qops.pass_slots(20000, 40000), 40000) <= \
        qops.SMEM_BYTES
    with pytest.raises(ValueError, match="no room"):
        qops.pass_slots(1024, 60000)


def test_same_topk_rule():
    """The kernel-vs-plain rule: another order among equal-enough scores
    passes, other ids outside a near tie at the cut fail, k' = C has no
    cut."""
    from repro_torch.kernels.quant_rerank.ref import near_tie_rows, same_topk
    wide = torch.tensor([[3.0, 2.0, 1.0], [3.0, 2.0, 2.0 - 1e-6],
                         [3.0, 3.0, 1.0]])
    assert near_tie_rows(wide, 2).tolist() == [False, True, False]
    assert not near_tie_rows(wide[:, :2], 2).any()
    ids = torch.tensor([[4, 5], [6, 7], [8, 9]], dtype=torch.int32)
    vals = wide[:, :2]
    assert same_topk(ids, ids, vals, vals, wide) == 1
    assert same_topk(ids, ids[:, [1, 0]], vals, vals, wide) == 1
    other = ids.clone()
    other[1, 1] = 1                        # the flagged row may differ
    assert same_topk(ids, other, vals, vals, wide) == 1
    other[0, 1] = 1
    with pytest.raises(AssertionError, match="other ids"):
        same_topk(ids, other, vals, vals, wide)


# ------------------------------------------------------------ irli_topk ----
IRLI_CASES = [                  # the cases of test_kernels.py's irli_topk
    (64, 64, 512, 5, 32, 128),
    (128, 128, 1024, 10, 128, 256),
    (32, 96, 640, 3, 32, 320),
]


def _irli_inputs(Q, H, B, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((Q, H), (H, B), (B,))]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Q,H,B,m,tq,tb", IRLI_CASES)
def test_irli_topk_plain_matches_reference(Q, H, B, m, tq, tb, dtype):
    """scorer_topk on the CPU against the JAX kernel (interpret mode) and
    its oracle: values to 1e-5 (bf16 inputs are widened and summed in fp32
    in all three, so the bf16 cases hold to it too, inside the reference
    test's 2e-2); ids equal outside rows whose m-th and (m+1)-th logits
    lie within 1e-5 (ref.same_topm). The lse against JAX's logsumexp."""
    jargs, targs = _irli_inputs(Q, H, B, dtype, Q + B)
    vals, idx, lse = iops.scorer_topk(*targs, m=m, lse=True)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert tuple(vals.shape) == (Q, m) and tuple(lse.shape) == (Q,)
    wide_v, wide_i = (np.asarray(a) for a in j_irli_ref(*jargs, m=m + 1))
    for rv, ri in (j_irli(*jargs, m=m, tq=tq, tb=tb, interpret=True),
                   j_irli_ref(*jargs, m=m)):
        ref_v = np.concatenate([np.asarray(rv), wide_v[:, m:]], axis=1)
        ref_i = np.concatenate([np.asarray(ri), wide_i[:, m:]], axis=1)
        cut, _ = same_topm(vals, idx, torch.from_numpy(ref_v),
                           torch.from_numpy(ref_i), 1e-5)
        assert cut <= 1
    logits = jnp.einsum("qh,hb->qb", *jargs[:2],
                        preferred_element_type=jnp.float32)
    jlse = jax.nn.logsumexp(logits + jargs[2].astype(jnp.float32), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)


def test_irli_topk_batched_reps_and_dispatch_on_cpu():
    """The [G, Q, H] form equals G single-rep calls; a CPU tensor takes the
    plain version (no launch), the kernel wrapper refuses it."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(3, 9, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 16, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    reset_launches()
    vals, idx, lse = iops.scorer_topk(h, w, b, m=4, lse=True)
    assert LAUNCHES["irli_topk"] == 0
    for g in range(3):
        v, i, s = irli_topk_ref(h[g], w[g], b[g], m=4, lse=True)
        assert torch.equal(vals[g], v) and torch.equal(idx[g], i)
        torch.testing.assert_close(lse[g], s, rtol=1e-6, atol=1e-6)
    logits = torch.matmul(h, w) + b[:, None, :]
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        iops.irli_topk(h, w, b, m=4)


def test_same_topm_rule():
    """Another id at a near-tie cut passes, another order among near values
    passes if the set agrees, any other difference fails."""
    ref_v = torch.tensor([[5.0, 4.0, 3.0], [5.0, 4.0, 4.0 - 1e-6],
                          [5.0, 5.0 - 1e-6, 1.0]])
    ref_i = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    vals = ref_v[:, :2].clone()
    assert same_topm(vals, ref_i[:, :2], ref_v, ref_i) == (1, 0)
    idx = ref_i[:, :2].clone()
    idx[1, 1] = 5                       # the near tie at the cut
    idx[2] = torch.tensor([7, 6])       # near values in another order
    assert same_topm(vals, idx, ref_v, ref_i) == (1, 1)
    idx[0, 1] = 2
    with pytest.raises(AssertionError, match="other ids"):
        same_topm(vals, idx, ref_v, ref_i)
    with pytest.raises(AssertionError, match="values"):
        same_topm(vals + 1e-3, ref_i[:, :2], ref_v, ref_i)


# --------------------------------------------------------- the build hash ---
def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its .cu and every header it includes
    (through other headers): editing a shared header renames the library
    of every kernel that includes it, and only those."""
    import shutil

    from repro_torch.kernels import _build
    shutil.copytree(_build.KERNELS_DIR, tmp_path / "kernels",
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path / "kernels")
    names = ("freq_topc", "quant_rerank", "irli_topk", "mega_query")
    before = {n: _build.library_path(n) for n in names}
    assert {p.name for p in _build.sources("mega_query")} == {
        "mega_query.cu", "irli_topk.cuh", "quant_rerank.cuh",
        "freq_topc.cuh", "tma.cuh"}
    assert {p.name for p in _build.sources("freq_topc")} == {
        "freq_topc.cu", "freq_topc.cuh"}
    header = tmp_path / "kernels" / "quant_rerank" / "quant_rerank.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["freq_topc"] == before["freq_topc"]
    for n in ("quant_rerank", "irli_topk", "mega_query"):
        assert after[n] != before[n], n
    (tmp_path / "kernels" / "freq_topc" / "notes.txt").write_text("x")
    assert _build.library_path("freq_topc") == before["freq_topc"]


# ------------------------------------------------------------- bce_logits --
@pytest.mark.parametrize("N,B,tn,tb", [(128, 512, 64, 256),
                                       (64, 1024, 32, 512)])
def test_bce_logits_plain_matches_reference_and_pallas(N, B, tn, tb):
    """The plain version against the reference's oracle and its Pallas
    kernel in interpret mode (as tests/test_kernels.py runs it): loss to
    1e-6 relative, gradient to 1e-6."""
    lg = np.asarray(jax.random.normal(jax.random.PRNGKey(N + B), (N, B))) * 4
    tg = (np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (N, B)))
          > 0.9).astype(np.float32)
    loss, grad = bce_logits_ref(torch.from_numpy(lg), torch.from_numpy(tg))
    reset_launches()
    floss, fgrad = bops.fused_bce(torch.from_numpy(lg), torch.from_numpy(tg))
    assert LAUNCHES["bce_logits"] == 0          # the CPU launches nothing
    assert torch.equal(floss, loss) and torch.equal(fgrad, grad)
    for ref in (j_bce_ref(jnp.asarray(lg), jnp.asarray(tg)),
                j_bce(jnp.asarray(lg), jnp.asarray(tg), tn=tn, tb=tb,
                      interpret=True)):
        np.testing.assert_allclose(float(loss), float(ref[0]), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-6)


def test_weighted_bce_matches_loss_parts_and_jax_grad():
    """The fit's form — [R·N, B] rows, weight w[row mod N], scale 1/(R·Σw)
    — against the reference's scorer_loss_parts(sigmoid_bce) / denom and
    its jax.grad with respect to the logits."""
    R, N, B = 3, 10, 64
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(R, N, B)).astype(np.float32) * 3
    tg = (rng.random((R, N, B)) > 0.85).astype(np.float32)
    w = np.ones(N, np.float32)
    w[-3:] = 0.0
    denom = R * max(float(w.sum()), 1.0)

    def ref_loss(logits):
        per = (jnp.maximum(logits, 0) - logits * tg
               + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        return jnp.sum(jnp.sum(per, -1) * w[None]) / denom

    jl, jg = jax.value_and_grad(ref_loss)(jnp.asarray(lg))
    loss, grad = bops.weighted_bce(torch.from_numpy(lg.reshape(R * N, B)),
                                   torch.from_numpy(tg.reshape(R * N, B)),
                                   torch.from_numpy(w), scale=1.0 / denom)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy().reshape(R, N, B), np.asarray(jg),
                               rtol=1e-6, atol=1e-7)
    assert not grad.reshape(R, N, B)[:, -3:].any()      # padding rows
    # the same through the reference's scorer loss, params fixed at random
    scfg = JN.ScorerConfig(d_in=4, d_hidden=8, n_buckets=B, n_reps=R,
                           loss="sigmoid_bce")
    params = JN.scorer_init(jax.random.PRNGKey(1), scfg)
    x = rng.normal(size=(N, 4)).astype(np.float32)
    s, _ = JN.scorer_loss_parts(params, scfg, jnp.asarray(x),
                                jnp.asarray(tg), jnp.asarray(w))
    logits = np.asarray(JN.scorer_logits(params, jnp.asarray(x)))
    loss2, _ = weighted_bce_ref(torch.from_numpy(logits.reshape(R * N, B)),
                                torch.from_numpy(tg.reshape(R * N, B)),
                                torch.from_numpy(w), 1.0 / denom)
    np.testing.assert_allclose(float(loss2), float(s) / denom, rtol=1e-6)


def test_bce_logits_weights_must_tile_the_rows():
    x = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="multiple"):
        weighted_bce_ref(x, x, torch.ones(4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bops.bce_logits(x, x, scale=1.0)


# ---------------------------------------------------------------- kchoice --
def test_kchoice_dispatch_on_cpu_takes_the_plain_version():
    """The CPU takes the plain loop and launches nothing; the kernel's
    entry refuses CPU tensors and its shared-memory model bounds B."""
    rng = np.random.default_rng(0)
    G, L, K, B = 2, 60, 3, 9
    topk = torch.from_numpy(np.stack([[rng.choice(B, K, replace=False)
                                       for _ in range(L)]
                                      for _ in range(G)]).astype(np.int32))
    order = torch.from_numpy(np.stack([rng.permutation(L)
                                       for _ in range(G)]).astype(np.int32))
    reset_launches()
    got = kops.kchoice_assign(topk, order, B=B)
    assert LAUNCHES["kchoice"] == 0
    assert torch.equal(got, kchoice_ref(topk, order, B=B))
    assert got.dtype == torch.int32 and got.shape == (G, L)
    # a per-rep load0 row and one row for every rep
    l0 = torch.arange(B, dtype=torch.float32)
    assert torch.equal(kops.kchoice_assign(topk, order, l0, B=B),
                       kops.kchoice_assign(topk, order, l0.expand(G, B),
                                           B=B))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kops.kchoice(topk, order, B=B)
    assert kops.smem_bytes(20000, 10) <= kops.SMEM_BYTES
    assert kops.smem_bytes(60000, 10) > kops.SMEM_BYTES


@pytest.mark.parametrize("case", ["disjoint", "one_bucket", "one_list"])
def test_dependence_depth_on_hand_made_cases(case):
    """Disjoint candidates give every label depth 1 and the schedule one
    round a window of 32; one bucket shared by every label (K = 1), or one
    K-list shared by every label, chains all L, and the schedule then takes
    L rounds (a window's first label, then one in-register step a label)."""
    G, L, K = 2, 40, 3
    if case == "disjoint":
        topk = torch.arange(L * K, dtype=torch.int32).reshape(1, L, K)
    elif case == "one_bucket":
        topk = torch.zeros((1, L, 1), dtype=torch.int32)
    else:
        topk = torch.tensor([5, 2, 7], dtype=torch.int32).expand(1, L, K)
    topk = topk.expand(G, -1, -1).contiguous()
    B = L * K
    order = torch.stack([torch.randperm(L, generator=torch.Generator()
                                        .manual_seed(g)) for g in range(G)])
    assign, rounds = kchoice_windows(topk, order, B=B)
    assert torch.equal(assign, kchoice_ref(topk, order, B=B))
    depth = dependence_depth(topk, order, assign, B=B)
    if case == "disjoint":
        assert depth.tolist() == [1] * G
        assert rounds.tolist() == [-(-L // 32)] * G
    else:
        assert depth.tolist() == rounds.tolist() == [L] * G


def test_irli_topk_plain_serves_any_m():
    """m past the kernel's 64-entry lists: the plain version (and so the
    CPU dispatch) answers every 1 <= m <= B, as the reference's
    scorer_topk does."""
    rng = np.random.default_rng(3)
    h, w2, b2 = (rng.normal(size=s).astype(np.float32)
                 for s in ((2, 9, 16), (2, 16, 200), (2, 200)))
    for m in (65, 128, 200):
        v, i = iops.scorer_topk(*(torch.from_numpy(a) for a in (h, w2, b2)),
                                m=m)
        for g in range(2):
            rv, ri = j_irli_ref(jnp.asarray(h[g]), jnp.asarray(w2[g]),
                                jnp.asarray(b2[g]), m=m)
            np.testing.assert_allclose(v[g].numpy(), np.asarray(rv),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(i[g].numpy(), np.asarray(ri))


# -------------------------------------------------------- distance_topk ----
from repro.kernels.distance_topk.distance_topk import (  # noqa: E402
    distance_topk as j_dist)
from repro.kernels.distance_topk.ops import rerank_topk as j_rerank  # noqa: E402,E501
from repro.kernels.distance_topk.ref import (  # noqa: E402
    distance_topk_ref as j_dist_ref)
from repro_torch.kernels.distance_topk import ops as dops  # noqa: E402
from repro_torch.kernels.distance_topk.ref import distance_topk_ref  # noqa: E402,E501


def _dist_inputs(Q, L, d, seed):
    """Queries, corpus and a float mask from a seed. The corpus repeats a
    row (exact ties, broken toward the smaller id) and holds two zero rows;
    query 0 is zero, so its dot similarities are all +0.0 (one long tie)
    and its l2 similarity to a zero row is -0.0 (-((0 - 0) + 0))."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Q, d)).astype(np.float32)
    q[0] = 0.0
    base = rng.normal(size=(L, d)).astype(np.float32)
    base[L // 2: L // 2 + 4] = base[1]            # duplicate rows
    base[3] = base[L - 2] = 0.0                   # zero rows
    mask = (rng.uniform(size=(Q, L)) < 0.6).astype(np.float32)
    mask[:, 1] = mask[:, L // 2] = 1.0            # the tied rows survive
    return q, base, mask


def _same_dist(vals, ids, rvals, rids):
    vals, ids = np.asarray(vals), np.asarray(ids)
    rvals, rids = np.asarray(rvals), np.asarray(rids)
    fin = np.isfinite(rvals)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    np.testing.assert_allclose(vals[fin], rvals[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids[fin], rids[fin])


DIST_CASES = [(8, 64, 16, 5), (13, 300, 24, 10),    # ragged Q and L
              (5, 97, 8, 40), (3, 130, 96, 100)]


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("Q,L,d,k", DIST_CASES)
def test_distance_topk_plain_matches_reference(Q, L, d, k, metric):
    """distance_topk_ref against the JAX oracle, and rerank_topk (the CPU
    dispatch) against the JAX rerank_topk: scores to 1e-5, ids equal, and
    the ±0.0 similarities keep their sign."""
    q, base, mask = _dist_inputs(Q, L, d, Q * L)
    v, i = distance_topk_ref(torch.from_numpy(q), torch.from_numpy(base),
                             torch.from_numpy(mask), k=k, metric=metric)
    rv, ri = j_dist_ref(jnp.asarray(q), jnp.asarray(base), jnp.asarray(mask),
                        k=k, metric=metric)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    _same_dist(v, i, rv, ri)
    zero = np.asarray(rv) == 0
    np.testing.assert_array_equal(np.signbit(v.numpy()[zero]),
                                  np.signbit(np.asarray(rv)[zero]))
    reset_launches()
    sv, si = dops.rerank_topk(torch.from_numpy(q), torch.from_numpy(base),
                              torch.from_numpy(mask), k=k, metric=metric)
    assert LAUNCHES["distance_topk"] == 0
    jv, ji = j_rerank(jnp.asarray(q), jnp.asarray(base), jnp.asarray(mask),
                      k=k, metric=metric)
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    np.testing.assert_allclose(sv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("Q,L,d,k,tq,tl", [(32, 512, 16, 8, 16, 128),
                                           (64, 1024, 32, 10, 32, 256)])
def test_distance_topk_plain_matches_pallas_interpret(Q, L, d, k, tq, tl,
                                                      metric):
    """The port's plain version against the Pallas kernel in interpret mode
    (as tests/test_kernels.py runs it), at shapes its tiles divide. The
    kernel's l2 is 2·q·b - |q|² - |b|², another order than pairwise_sim's:
    values within 1e-5 + 1e-5·|v|, ids equal."""
    q, base, mask = _dist_inputs(Q, L, d, Q + L)
    v, i = distance_topk_ref(torch.from_numpy(q), torch.from_numpy(base),
                             torch.from_numpy(mask), k=k, metric=metric)
    pv, pi = j_dist(jnp.asarray(q), jnp.asarray(base), jnp.asarray(mask),
                    k=k, tq=tq, tl=tl, metric=metric, interpret=True)
    _same_dist(v, i, pv, pi)


def test_rerank_topk_pads_past_the_survivors():
    """k above the survivors: -1 ids and -inf scores in the slots past
    them, as the reference's rerank_topk; a row with no survivor is all
    padding."""
    q, base, mask = _dist_inputs(6, 50, 8, 7)
    mask[:] = 0.0
    mask[0, [4, 9, 33]] = 1.0
    mask[1, 17] = 2.0
    mask[2, 5] = -1.0                     # not > 0: dropped, as in JAX
    v, i = dops.rerank_topk(torch.from_numpy(q), torch.from_numpy(base),
                            torch.from_numpy(mask), k=5)
    jv, ji = j_rerank(jnp.asarray(q), jnp.asarray(base), jnp.asarray(mask),
                      k=5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert sorted(i[0, :3].tolist()) == [4, 9, 33]
    assert (i[0, 3:] == -1).all() and torch.isinf(v[0, 3:]).all()
    assert i[1, 0] == 17 and (i[1, 1:] == -1).all()
    assert (i[2:] == -1).all()


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_rerank_topk_takes_a_stride0_tombstone_mask(metric):
    """The exact oracle's mask: one live row seen by every query, a stride-0
    view of ~tombstone. It gives what the full [Q, L] mask gives, and
    mask_rows keeps it one row."""
    q, base, _ = _dist_inputs(9, 200, 16, 3)
    tomb = np.zeros(200, bool)
    tomb[np.random.default_rng(0).choice(200, 60, replace=False)] = True
    live = torch.from_numpy(~tomb)[None, :].expand(9, -1)
    assert live.stride(0) == 0
    v, i = dops.rerank_topk(torch.from_numpy(q), torch.from_numpy(base),
                            live, k=10, metric=metric)
    jv, ji = j_rerank(jnp.asarray(q), jnp.asarray(base),
                      jnp.asarray(~tomb[None, :]), k=10, metric=metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    assert not np.isin(i.numpy(), np.flatnonzero(tomb)).any()
    rows, ld = dops.mask_rows(live, 9, 200)
    assert rows.shape == (1, 200) and ld == 0 and rows.dtype == torch.uint8
    full, ld = dops.mask_rows(live.contiguous().float(), 9, 200)
    assert full.shape == (9, 200) and ld == 200
    with pytest.raises(ValueError, match="broadcast"):
        dops.mask_rows(live[:, :10], 9, 200)


def test_distance_topk_kernel_refuses_cpu_tensors():
    q, base, mask = _dist_inputs(4, 32, 8, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dops.distance_topk(torch.from_numpy(q), torch.from_numpy(base),
                           torch.from_numpy(mask), k=3)
