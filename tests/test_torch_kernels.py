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
from repro_torch.kernels.kchoice.ref import kchoice_ref  # noqa: E402
from repro_torch.kernels.freq_topc import ops as fops  # noqa: E402
from repro_torch.kernels.freq_topc.ref import freq_topc_ref  # noqa: E402
from repro_torch.kernels.irli_topk import ops as iops  # noqa: E402
from repro_torch.kernels.irli_topk.ref import (  # noqa: E402
    irli_topk_ref, same_topm)
from repro_torch.kernels.quant_rerank import ops as qops  # noqa: E402
from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref  # noqa: E402
from repro_torch.store.quantized import encode  # noqa: E402


# ------------------------------------------------------------ freq_topc ----
FREQ_CASES = [                  # the cases of test_kernels.py's freq_topc
    (8, 96, 40, 16),      # fewer values than slots: heavy duplication
    (7, 120, 500, 64),    # mostly-distinct
    (4, 100, 30, 160),    # C > C0: output right-padded
]


def _cands(Q, C0, V, seed=None):
    rng = np.random.default_rng(Q + C0 if seed is None else seed)
    cands = rng.integers(-1, V, (Q, C0)).astype(np.int32)
    cands[0, : C0 // 2] = -1                     # heavily padded row
    cands[-1] = -1                               # zero-candidate row
    return cands


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
    """A pass sorts its slots' keys in one block's shared memory: topC 16384
    fits up to D = 8960, one slot more does not. ``pass_slots`` takes all C
    slots in one pass where they fit, else the largest power of two that
    does (the passes then merge in scratch)."""
    assert qops.smem_bytes(1024, 96) == 1024 * 8 + (1024 + 96) * 4
    assert qops.smem_bytes(777, 96) == 1024 * 8 + (777 + 96) * 4
    assert qops.smem_bytes(16384, 8960) <= qops.SMEM_BYTES
    assert qops.smem_bytes(16384, 8961) > qops.SMEM_BYTES
    assert qops.smem_bytes(16385, 1) > qops.SMEM_BYTES
    assert qops.pass_slots(1024, 96) == 1024
    assert qops.pass_slots(777, 96) == 1024
    assert qops.pass_slots(16384, 96) == 16384
    assert qops.pass_slots(20000, 96) == qops.pass_slots(20000, 8960) == 16384
    assert qops.pass_slots(16384, 8961) == 8192
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
        "freq_topc.cuh"}
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
