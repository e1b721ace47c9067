"""The port's partition baselines, ``zipf_xml`` and the IRLI vocabulary
head against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``repro.core.baselines`` /
``repro.data.synthetic`` / ``repro.core.vocab_head`` and their
counterparts in ``repro_torch``. Tolerances: the random and LSH
partitions, both query -> bucket rules, the candidate mask and recall
exact; k-means and balanced k-means on ``clustered_ann`` data (seed 3)
exact assignments except rows whose two best distances to the final
centres lie within 1e-5 (relative) of each other (counted; none on this
data), centres to 1e-5; ``zipf_xml`` equal arrays; the vocabulary head's
candidate ids exact and logits to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as JB  # noqa: E402
from repro.core.network import ScorerConfig, scorer_init  # noqa: E402
from repro.core.partition import build_inverted_index, hash_init  # noqa: E402
from repro.core.vocab_head import (  # noqa: E402
    candidate_token_logits as j_cand_logits, greedy_token as j_greedy)
from repro.data.synthetic import clustered_ann as j_clustered_ann  # noqa: E402
from repro.data.synthetic import zipf_xml as j_zipf_xml  # noqa: E402
from repro_torch.core import baselines as PB  # noqa: E402
from repro_torch.core import vocab_head as PV  # noqa: E402
from repro_torch.core.partition import InvertedIndex  # noqa: E402
from repro_torch.data.synthetic import zipf_xml  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402

jax.config.update("jax_platforms", "cpu")

SEED = 3
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(n=1500, d=16, seed=SEED):
    return j_clustered_ann(n_base=n, n_queries=64, d=d, k_gt=10, k_train=1,
                           seed=seed)


@pytest.mark.parametrize("L,B,seed", [(1000, 16, 0), (777, 100, 5),
                                      (50, 7, 2)])
def test_random_partition_is_the_reference_draw(L, B, seed):
    got = PB.random_partition(L, B, seed, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), JB.random_partition(L, B,
                                                                   seed))


@pytest.mark.parametrize("B,m", [(16, 1), (16, 4), (100, 16), (20000, 4)])
def test_lsh_partition_and_multiprobe_match_exactly(B, m):
    """The planes are the reference's draw; the assignment and the m
    probed codes (m past the bit count wraps the flipped bit) equal."""
    data = _data()
    assign, planes = JB.lsh_partition(data.base, B, seed=1)
    got, gplanes = PB.lsh_partition(_t(data.base), B, seed=1)
    np.testing.assert_array_equal(gplanes.numpy(), planes)
    np.testing.assert_array_equal(got.numpy(), assign)
    want = JB.lsh_top_buckets(data.queries, planes, B, m)
    tb = PB.lsh_top_buckets(_t(data.queries), gplanes, B, m)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), want)
    mask = PB.candidates_from_partition(got, tb, data.base.shape[0])
    jmask = JB.candidates_from_partition(assign, want, data.base.shape[0])
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert PB.recall_of_mask(mask, _t(data.gt)) == \
        JB.recall_of_mask(jmask, data.gt)


def _near_tie_rows(base, centers, assign):
    """Rows whose two best squared distances to centers lie within TOL of
    each other (relative)."""
    d2 = ((base[:, None, :].astype(np.float64) - centers[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return np.nonzero(two[:, 1] - two[:, 0] <= TOL * np.abs(two[:, 1]))[0]


def _hold_kmeans(got, want, base):
    (ga, gc), (wa, wc) = got, want
    assert ga.dtype == torch.int32
    near = _near_tie_rows(base, wc, wa)
    differ = np.nonzero(ga.numpy() != wa)[0]
    assert set(differ) <= set(near), (differ, near)
    assert len(near) == 0, f"{len(near)} near-tie rows on this data"
    np.testing.assert_allclose(gc.numpy(), wc, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,B,d,iters", [(1500, 32, 16, 25),
                                         (12000, 176, 96, 4)])
def test_kmeans_matches_reference(n, B, d, iters):
    """The direct distance form (L·B·d < 2e8) and the blocked one in 4096
    rows (12,000 x 176 x 96 = 2.03e8): the same first centres (the
    reference's rng.choice), the same assignments and centres."""
    data = _data(n, d)
    assert (n * B * d < 2e8) == (n < 12000)
    want = JB.kmeans_partition(data.base, B, iters=iters, seed=SEED)
    got = PB.kmeans_partition(_t(data.base), B, iters=iters, seed=SEED)
    _hold_kmeans(got, want, data.base)


def test_balanced_kmeans_matches_reference():
    data = _data(600, 16)
    want = JB.balanced_kmeans_partition(data.base, 8, iters=6, seed=SEED)
    got = PB.balanced_kmeans_partition(_t(data.base), 8, iters=6, seed=SEED)
    _hold_kmeans(got, want, data.base)
    assert np.bincount(got[0].numpy(), minlength=8).max() <= 75


@pytest.mark.parametrize("metric", ["angular", "l2"])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_centroid_buckets_candidates_and_recall_match_exactly(metric, m):
    """On the reference's own k-means centres and assignment: the top-m
    centres a query, the [Q, L] candidate mask and recall@10."""
    data = _data()
    assign, centers = JB.kmeans_partition(data.base, 32, iters=5, seed=0)
    want = JB.centroid_top_buckets(data.queries, centers, m, metric)
    got = PB.centroid_top_buckets(_t(data.queries), _t(centers), m, metric)
    np.testing.assert_array_equal(got.numpy(), want)
    L = data.base.shape[0]
    mask = PB.candidates_from_partition(_t(assign), got, L)
    jmask = JB.candidates_from_partition(assign, want, L)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert PB.recall_of_mask(mask, _t(data.gt)) == \
        JB.recall_of_mask(jmask, data.gt)


def test_zipf_xml_is_the_reference_draw():
    kw = dict(n_train=300, n_test=50, d=12, n_labels=400,
              labels_per_point=3, seed=7)
    got, want = zipf_xml(**kw), j_zipf_xml(**kw)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for name in ("x_train", "x_test", "label_freq"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.n_labels == want.n_labels
    for ys, yw in ((got.y_train, want.y_train), (got.y_test, want.y_test)):
        assert len(ys) == len(yw)
        for a, b in zip(ys, yw):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _head_case(V, d, B, R, n_q):
    """The reference test's head (tests/test_query_and_serving.py): a
    random JAX scorer and embedding, the hash partition with max_load
    2V/B, and h; the port's copies on the CPU."""
    embed = jax.random.normal(jax.random.PRNGKey(0), (V, d))
    sp = scorer_init(jax.random.PRNGKey(1), ScorerConfig(
        d_in=d, d_hidden=32, n_buckets=B, n_reps=R))
    index = build_inverted_index(hash_init(V, B, R, 0), B,
                                 max_load=2 * V // B)
    h = jax.random.normal(jax.random.PRNGKey(2), (n_q, d))
    pindex = InvertedIndex(members=_t(np.asarray(index.members)),
                           load=_t(np.asarray(index.load)),
                           max_load=index.max_load)
    psp = {k: _t(np.asarray(v)) for k, v in sp.items()}
    return ((sp, index, embed, h),
            (psp, pindex, _t(np.asarray(embed)), _t(np.asarray(h))))


@pytest.mark.parametrize("V,d,B,R,n_q,m", [(256, 16, 16, 4, 8, 16),
                                           (512, 16, 32, 4, 4, 2)])
def test_vocab_head_matches_reference(V, d, B, R, n_q, m):
    """Candidate ids exact and logits to 1e-5 (-inf at the pads), the
    greedy token equal; at m = B the head's token is the full argmax. The
    CPU takes the plain probe: no kernel launch."""
    ref, port = _head_case(V, d, B, R, n_q)
    cands, logits = j_cand_logits(*ref, m=m)
    reset_launches()
    pc, pl = PV.candidate_token_logits(*port, m=m)
    tok = PV.greedy_token(*port, m=m)
    assert all(v == 0 for v in LAUNCHES.values())
    assert pc.dtype == torch.int32 and pl.dtype == torch.float32
    assert pc.shape == (n_q, R * m * (2 * V // B))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(cands))
    want = np.asarray(logits)
    assert np.array_equal(np.isinf(pl.numpy()), np.isinf(want))
    np.testing.assert_allclose(pl.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_greedy(*ref,
                                                                   m=m)))
    if m == B:
        full = np.asarray(jnp.argmax(ref[3] @ ref[2].T, axis=1))
        np.testing.assert_array_equal(tok.numpy(), full)
    else:
        n_distinct = len(set(pc[0][pc[0] >= 0].tolist()))
        assert n_distinct < V / 2
