"""Shared toy-config builders for the registered contracts.
Port of ``repro/analysis/fixtures.py``: the same sizes, seeds and dims.

Contracts are DECLARED beside the entry points they govern (core/query.py,
fit/engine.py, store/rerank.py, core/distributed.py, each kernel dispatch
site) but their fixtures are built HERE, lazily, at audit time: declaring
modules stay import-cheap and free of cycles (this module imports half the
package; the declaration sites import only ``analysis.contracts``).

Every builder follows the reference's recipe: DISTINCTIVE dims (nothing
else in the fixture is 4096 or 48), untrained indexes (the invariants hold
for any params, so the slow fit is skipped), inputs drawn with
``np.random.default_rng`` at fixed seeds and then moved to the audit's
device (``contracts.audit_device``). On the card the kernels run in the
fixtures; a control that has to hold the forbidden tensor on both devices
calls the plain version itself (the oracle's table, the full-width
dequant), and says so.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.contracts import Fixture, audit_device

# kept in sync with the declaration sites, which reference these to build
# their check bounds
QL_Q, QL_L, QL_TOPC = 6, 4096, 32
ST_L, ST_D, ST_Q, ST_C, ST_KP = 4096, 32, 6, 48, 16
FIT_L, FIT_B, FIT_CHUNK, FIT_K = 2048, 48, 256, 4
OL_L, OL_B, OL_CHUNK, OL_K = 1536, 40, 192, 3
OL_CAP, OL_D, OL_ML = 4096, 48, 256
M_PROBE, K_TOP = 4, 5


def _t(a, dtype=None) -> torch.Tensor:
    """A numpy array on the audit device."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(audit_device())
    return t if dtype is None else t.to(dtype)


@functools.lru_cache(maxsize=None)
def _index_on(L: int, n_buckets: int, d: int, n_reps: int, seed: int,
              device: str):
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    cfg = IRLIConfig(d=d, n_labels=L, n_buckets=n_buckets, n_reps=n_reps,
                     d_hidden=32, K=M_PROBE, seed=seed)
    idx = IRLIIndex(cfg, device=device)
    idx.build_index()
    return idx


def _untrained_index(L: int, *, n_buckets: int = 64, d: int = 16,
                     n_reps: int = 2, seed: int = 0):
    """Scorer params + hash partition + inverted index, no training: the
    contracts must hold for ANY params (cached per device: the build
    dominates fixture cost and several contracts share one)."""
    return _index_on(L, n_buckets, d, n_reps, seed, str(audit_device()))


def _corpus(L: int, n_q: int, d: int = 16, seed: int = 5):
    rng = np.random.default_rng(seed)
    return (_t(rng.normal(size=(L, d)).astype(np.float32)),
            _t(rng.normal(size=(n_q, d)).astype(np.float32)))


def _tombstone(L: int, n_dead: int = 10) -> torch.Tensor:
    tomb = torch.zeros((L,), dtype=torch.bool, device=audit_device())
    tomb[:n_dead] = True
    return tomb


# ------------------------------------------------------------------ query --
def query_search(mode: str, streaming: bool = False) -> Fixture:
    """QueryPipeline.search over the [Q=6, L=4096] toy: ``mode="compact"``
    is the contract fixture, ``mode="dense"`` its control."""
    from repro_torch.core.query import QueryPipeline
    idx = _untrained_index(QL_L)
    base, queries = _corpus(QL_L, QL_Q)
    pipe = QueryPipeline(m=M_PROBE, tau=1, k=K_TOP, mode=mode, topC=QL_TOPC)
    if streaming:
        R = idx.cfg.n_reps
        delta = torch.full((R, idx.cfg.n_buckets, 8), -1, dtype=torch.int32,
                           device=audit_device())
        tomb = _tombstone(QL_L)
        fn = lambda p, mem, b, q: pipe.search(p, mem, b, q, delta, tomb)
    else:
        fn = lambda p, mem, b, q: pipe.search(p, mem, b, q)
    return Fixture(fn=fn, args=(idx.params, idx.index.members, base, queries),
                   dims={"Q": QL_Q, "L": QL_L, "C": QL_TOPC, "k": K_TOP})


def local_search_compact(mode: str = "compact") -> Fixture:
    """distributed.local_search (the per-shard path) with live tombstones."""
    from repro_torch.core.distributed import local_search
    from repro_torch.core.search_api import SearchParams
    idx = _untrained_index(QL_L)
    base, queries = _corpus(QL_L, QL_Q)
    tomb = _tombstone(QL_L)
    sp = SearchParams(m=M_PROBE, tau=1, k=K_TOP, mode=mode, topC=QL_TOPC)
    fn = lambda p, mem, b, q: local_search(p, mem, b, q, sp,
                                           tombstone=tomb).ids
    return Fixture(fn=fn, args=(idx.params, idx.index.members, base, queries),
                   dims={"Q": QL_Q, "L": QL_L, "C": QL_TOPC})


def audit_oracle_control() -> Fixture:
    """The shadow-audit oracle's full-probe scan, which builds the [Q, L]
    table BY DESIGN: the tripping control for
    ``query.audit_oracle_off_hot_path`` (forbid_dims("Q", "L") would see
    the oracle if it ever leaked into the serve path). ``exact_topk`` on
    the card runs distance_topk, which holds no [Q, L] table, so the
    control is the oracle's plain version (``distance_topk_ref`` over the
    live mask) on either device."""
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    base, queries = _corpus(QL_L, QL_Q)
    tomb = _tombstone(QL_L)

    def fn(b, q, t):
        live = (~t)[None, :].expand(q.shape[0], -1)
        return distance_topk_ref(q, b, live, k=K_TOP)
    return Fixture(fn=fn, args=(base, queries, tomb),
                   dims={"Q": QL_Q, "L": QL_L})


# ------------------------------------------------------------------ store --
def _store_parts(dtype: str):
    from repro_torch.store.quantized import encode
    idx = _untrained_index(ST_L, d=ST_D, seed=7)
    rng = np.random.default_rng(7)
    base = rng.normal(size=(ST_L, ST_D)).astype(np.float32)
    queries = _t(rng.normal(size=(ST_Q, ST_D)).astype(np.float32))
    return idx, encode(_t(base), dtype, 16), queries


_ST_DIMS = {"Q": ST_Q, "L": ST_L, "D": ST_D, "C": ST_C, "kp": ST_KP}


def store_search(dtype: str) -> Fixture:
    """Quantized-store compact search: ``"int8"`` is the contract fixture
    (no fp32 [L, D] / [Q, C, D]), ``"fp32"`` its control (the full-width
    fp32 gather IS there)."""
    from repro_torch.core.query import QueryPipeline
    idx, store, queries = _store_parts(dtype)
    pipe = QueryPipeline(m=M_PROBE, tau=1, k=K_TOP, mode="compact",
                         topC=ST_C, store_dtype=dtype, refine_k=ST_KP)
    fn = lambda p, mem, s, q: pipe.search(p, mem, s, q)
    return Fixture(fn=fn,
                   args=(idx.params, idx.index.members, store, queries),
                   dims=dict(_ST_DIMS))


def mega_store_search() -> Fixture:
    """mode="mega" over the SAME int8 toy as store_search: the
    ``query.mega_single_dispatch`` fixture. The fused kernel takes this
    geometry on the card (R = 2, B = 64, ML = 128, d = D = 32: 216,064 B
    of shared memory a block, ``mega_query.ops.mega_fits``), so the card
    audit holds one launch at the reference's sizes."""
    from repro_torch.core.query import QueryPipeline
    idx, store, queries = _store_parts("int8")
    pipe = QueryPipeline(m=M_PROBE, tau=1, k=K_TOP, mode="mega",
                         topC=ST_C, store_dtype="int8", refine_k=ST_KP)
    fn = lambda p, mem, s, q: pipe.search(p, mem, s, q)
    return Fixture(fn=fn,
                   args=(idx.params, idx.index.members, store, queries),
                   dims=dict(_ST_DIMS))


def staged_search(pipe):
    """The compact search of ``pipe`` as its separate stage units, one
    dispatch each (what search_staged runs)."""
    from repro_torch.core import query as Q

    def fn(p, mem, s, q):
        h = Q._stage_hidden(pipe, p, q)
        bidx, keep = Q._stage_topm(pipe, p, h)
        cands = Q._stage_gather(pipe, mem, bidx, keep, None, None)
        cid, cnt, n_cand = Q._stage_freq_topc(pipe, cands)
        cids = Q._stage_quant_coarse(pipe, q, s, cid, cnt)
        ids, scores = Q._stage_quant_refine(pipe, q, s, cids)
        return ids, scores, n_cand
    return fn


def mega_split_control() -> Fixture:
    """The SAME search as a per-stage pipeline (the pre-megakernel hot
    path: irli_topk, freq_topc and quant_rerank each dispatched apart)
    MUST trip max_dispatches(1). Also the audit's seeded violation
    (``--seed-violation split_dispatch``)."""
    from repro_torch.core.query import QueryPipeline
    idx, store, queries = _store_parts("int8")
    pipe = QueryPipeline(m=M_PROBE, tau=1, k=K_TOP, mode="compact",
                         topC=ST_C, store_dtype="int8", refine_k=ST_KP)
    return Fixture(fn=staged_search(pipe),
                   args=(idx.params, idx.index.members, store, queries),
                   dims=dict(_ST_DIMS))


# -------------------------------------------------------------------- fit --
def _fit_cfg(**over):
    from repro_torch.core.index import IRLIConfig
    kw = dict(d=16, n_labels=FIT_L, n_buckets=FIT_B, n_reps=3, d_hidden=32,
              K=FIT_K, rounds=2, epochs_per_round=3, batch_size=50, lr=2e-3,
              affinity_chunk=FIT_CHUNK, seed=0)
    return IRLIConfig(**{**kw, **over})


def _fit_parts(cfg=None, n: int = 150):
    from repro_torch.core.network import ScorerConfig, scorer_init
    from repro_torch.fit.engine import FitData, FitEngine
    from repro_torch.fit.state import FitState
    cfg = cfg or _fit_cfg()
    dev = audit_device()
    scfg = ScorerConfig(d_in=cfg.d, d_hidden=cfg.d_hidden,
                        n_buckets=cfg.n_buckets, n_reps=cfg.n_reps,
                        loss=cfg.loss)
    params = scorer_init(scfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, cfg.d)).astype(np.float32)
    ids = rng.integers(0, cfg.n_labels, (n, 5)).astype(np.int32)
    lv = rng.normal(size=(cfg.n_labels, cfg.d)).astype(np.float32)
    data = FitData.build(x, ids, label_vecs=lv, n_labels=cfg.n_labels,
                         chunk=cfg.affinity_chunk, device=dev)
    eng = FitEngine(cfg, scfg)
    state = FitState.create(params, eng.opt.init(params),
                            torch.zeros((cfg.n_reps, cfg.n_labels),
                                        dtype=torch.int32, device=dev), 0)
    idx, w = eng.round_batches(n, 0, 0)
    return cfg, eng, params, data, state, idx, w


_FIT_DIMS = {"L": FIT_L, "B": FIT_B, "chunk": FIT_CHUNK, "K": FIT_K}


def fit_round() -> Fixture:
    """The whole train + affinity + re-partition round, which overwrites
    its state in place."""
    _, eng, _, data, state, idx, w = _fit_parts()
    fn = lambda s, i, ww: eng.round_body(s, i, ww, data, None)
    return Fixture(fn=fn, args=(state, idx, w), dims=dict(_FIT_DIMS),
                   donate_argnums=(0,))


def _dense_repartition(cfg, params, label_vecs):
    from repro_torch.core import repartition as RP
    return RP.repartition(RP.affinity_ann(params, label_vecs, cfg.loss),
                          cfg.K, cfg.n_buckets, "exact",
                          generator=torch.Generator().manual_seed(0))


def fit_round_dense_control() -> Fixture:
    """The seed-style dense path: the full [R, L, B] affinity, then the
    re-partition: MUST trip the [L, B] detector."""
    cfg, _, params, data, _, _, _ = _fit_parts()
    fn = lambda p, lv: _dense_repartition(cfg, p, lv)
    return Fixture(fn=fn, args=(params, data.label_vecs),
                   dims=dict(_FIT_DIMS))


def fit_round_sweep(drift: bool = False) -> Fixture:
    """make_fit_round called twice with fresh same-structure states: one
    argument signature. ``drift`` gives the second state an int64
    assignment where int32 belongs (a second signature: the seeded
    regression)."""
    from repro_torch.analysis.recompile import SignatureCounter
    from repro_torch.fit.state import FitState
    _, eng, params, data, state, idx, w = _fit_parts()
    params2 = {k: v.clone() for k, v in params.items()}
    state2 = FitState.create(params2, eng.opt.init(params2),
                             torch.zeros_like(state.assign), 0)
    if drift:
        state2.assign = state2.assign.long()
    counted = SignatureCounter(eng.make_fit_round(data))
    variants = [("first", (state, idx, w)), ("repeat", (state2, idx, w))]
    return Fixture(fn=None, args=(),
                   sweep={"call": lambda v: counted(*v)[1]["loss"].item(),
                          "variants": variants, "counter": counted})


def sharded_fit_round() -> Fixture:
    """The (data x rep) mesh round on a 2 x 2 mesh over the first four
    ranks of the world: its collective schedule is the contract surface.
    Needs a world of >= 4 ranks."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fit_mesh
    cfg = _fit_cfg(n_reps=2, epochs_per_round=2, batch_size=48)
    _, eng, _, data, state, idx, w = _fit_parts(cfg, n=144)
    mesh = make_fit_mesh(4, rep_axis=2, device_type=audit_device().type)
    state = eng.shard_state(state, mesh)
    round_fn = eng.make_sharded_fit_round(mesh, data, state)

    def fn(s, i, ww):
        ns, m = round_fn(s, i, ww)
        return torch.sum(ns.assign), m["loss"]
    return Fixture(fn=fn, args=(state, idx, w),
                   dims={"L": FIT_L, "B": FIT_B, "steps": idx.shape[0],
                         "P": dist.get_world_size()})


# ------------------------------------------------------------------ online --
def _online_parts():
    """A refit-round toy built through the SAME helper the OnlineRefitLoop
    uses (online/refit.make_refit_round): drained traffic = 120 queries
    self-labelled with 5 served ids each, label vectors = the live corpus
    [OL_L, d]."""
    from repro_torch.core.index import IRLIConfig
    from repro_torch.core.network import ScorerConfig, scorer_init
    from repro_torch.online.refit import make_refit_round
    dev = audit_device()
    cfg = IRLIConfig(d=16, n_labels=OL_L, n_buckets=OL_B, n_reps=2,
                     d_hidden=32, K=OL_K, rounds=1, epochs_per_round=2,
                     batch_size=48, lr=2e-3, affinity_chunk=OL_CHUNK, seed=3)
    scfg = ScorerConfig(d_in=cfg.d, d_hidden=cfg.d_hidden,
                        n_buckets=cfg.n_buckets, n_reps=cfg.n_reps,
                        loss=cfg.loss)
    params = scorer_init(scfg, torch.Generator(device=dev).manual_seed(3))
    rng = np.random.default_rng(3)
    nq = 120
    x = rng.normal(size=(nq, cfg.d)).astype(np.float32)
    ids = rng.integers(0, OL_L, (nq, 5)).astype(np.int32)
    mask = np.ones((nq, 5), np.float32)
    lv = _t(rng.normal(size=(OL_L, cfg.d)).astype(np.float32))
    engine, data, state = make_refit_round(
        cfg, params=params,
        assign=torch.zeros((cfg.n_reps, OL_L), dtype=torch.int32,
                           device=dev),
        x=x, label_ids=ids, label_mask=mask, label_vecs=lv, rng=3, rounds=1)
    idx, w = engine.round_batches(nq, 0, 0)
    return engine.cfg, engine, params, data, state, idx, w


_OL_DIMS = {"L": OL_L, "B": OL_B, "chunk": OL_CHUNK, "K": OL_K}


def online_refit_round() -> Fixture:
    """One incremental refit round over drained serve traffic."""
    _, eng, _, data, state, idx, w = _online_parts()
    fn = lambda s, i, ww: eng.round_body(s, i, ww, data, None)
    return Fixture(fn=fn, args=(state, idx, w), dims=dict(_OL_DIMS),
                   donate_argnums=(0,))


def online_refit_dense_control() -> Fixture:
    """Dense [L, B] affinity + re-partition over the refit dims: MUST trip
    the [L, B] detector."""
    cfg, _, params, data, _, _, _ = _online_parts()
    fn = lambda p, lv: _dense_repartition(cfg, p, lv)
    return Fixture(fn=fn, args=(params, data.label_vecs),
                   dims=dict(_OL_DIMS))


def _swap_args():
    rng = np.random.default_rng(23)
    R, B = 2, 24
    assign = _t(rng.integers(0, B, (R, OL_CAP)), torch.int32)
    tomb = _tombstone(OL_CAP, 100)
    vecs = _t(rng.normal(size=(OL_CAP, OL_D)).astype(np.float32))
    return B, assign, tomb, vecs


def online_swap_no_copy() -> Fixture:
    """The artifact swap's device work: rebuild_members over the full-
    capacity assignment, the [cap, d] payload passing through untouched."""
    from repro_torch.artifact import rebuild_members
    B, assign, tomb, vecs = _swap_args()

    def fn(a, t, v):
        members, load = rebuild_members(a, t, B=B, max_load=OL_ML)
        return members, load, v      # payload moves by reference

    return Fixture(fn=fn, args=(assign, tomb, vecs),
                   dims={"cap": OL_CAP, "d": OL_D})


def online_swap_copy_control() -> Fixture:
    """Same rebuild, but the payload is touched (a full [cap, d] copy):
    MUST trip both the dim detector and the intermediate budget."""
    from repro_torch.artifact import rebuild_members
    B, assign, tomb, vecs = _swap_args()

    def fn(a, t, v):
        members, load = rebuild_members(a, t, B=B, max_load=OL_ML)
        return members, load, v * 1.0     # the copy the contract forbids

    return Fixture(fn=fn, args=(assign, tomb, vecs),
                   dims={"cap": OL_CAP, "d": OL_D})


# ----------------------------------------------------------- search cache --
def pipeline_cache_sweep() -> Fixture:
    """PipelineCache over a SearchParams sweep: 4 distinct resolved keys
    (two param sets, a dense variant, a second batch bucket), each repeated
    — exactly 4 compiles expected."""
    from repro_torch.core.search_api import PipelineCache, SearchParams
    from repro_torch.obs.registry import MetricRegistry
    idx = _untrained_index(300, n_buckets=16)
    base, queries = _corpus(300, 8)
    cache = PipelineCache(registry=MetricRegistry())
    spa = SearchParams(m=M_PROBE, tau=1, k=K_TOP, mode="compact", topC=32)
    spb = spa.replace(topC=64)
    spd = SearchParams(m=M_PROBE, tau=1, k=K_TOP, mode="dense")

    def call(variant):
        sp, qn = variant
        cache.search(sp, idx.params, idx.index.members, base, queries[:qn])

    variants = [("compact-a", (spa, 8)), ("compact-a-again", (spa, 8)),
                ("compact-b", (spb, 8)), ("compact-b-again", (spb, 8)),
                ("dense", (spd, 8)), ("dense-again", (spd, 8)),
                ("compact-a-bucket4", (spa, 4)),
                ("compact-a-bucket4-again", (spa, 4))]
    return Fixture(fn=None, args=(),
                   sweep={"call": call, "variants": variants,
                          "counter": cache})


# ------------------------------------------------------------ distributed --
def production_search() -> Fixture:
    """make_production_search over every rank of the world as a corpus
    shard. Every rank holds the same member/base values: the collective
    schedule is the contract surface, not the content. The first call (its
    one-time shard-size check, one all-reduce of two int64) runs here, at
    build time, so the recorded call is a search in steady state."""
    import torch.distributed as dist

    from repro_torch.core.distributed import make_production_search
    from repro_torch.core.search_api import SearchParams
    from repro_torch.launch.mesh import make_host_mesh
    P_n = dist.get_world_size()
    Qn, k = 4, K_TOP
    idx = _untrained_index(256, n_buckets=16)
    base, queries = _corpus(256, Qn)
    mesh = make_host_mesh(P_n, device_type=audit_device().type)
    search = make_production_search(
        mesh, SearchParams(m=M_PROBE, tau=1, k=k, mode="compact", topC=32))

    def fn(p, mem, b, q):
        r = search(p, mem, b, q)
        return r.ids, r.scores, r.n_candidates
    args = (idx.params, idx.index.members, base, queries)
    fn(*args)
    return Fixture(fn=fn, args=args, dims={"Q": Qn, "k": k, "P": P_n,
                                           "L": 256})


# ----------------------------------------------------------------- kernels --
def freq_topc_fixture(dense: bool = False) -> Fixture:
    """frequent_topc dispatch over [Q=6, W] candidates drawn from L=4096
    ids; the dense control builds the [Q, L] histogram the kernel exists to
    avoid."""
    rng = np.random.default_rng(11)
    Qn, W, L, C = 6, 96, 4096, 48
    cands = _t(rng.integers(0, L, (Qn, W)), torch.int32)
    if dense:
        def fn(c):
            hist = torch.zeros((c.shape[0], L), dtype=torch.float32,
                               device=c.device)
            hist.scatter_add_(1, c.long(), torch.ones(c.shape,
                                                      device=c.device))
            cnt, ids = torch.topk(hist, C)
            return ids, cnt
    else:
        from repro_torch.kernels.freq_topc.ops import frequent_topc
        fn = lambda c: frequent_topc(c, C=C)
    return Fixture(fn=fn, args=(cands,), dims={"Q": Qn, "L": L, "C": C})


def quant_rerank_fixture(chunk: int | None = None) -> Fixture:
    """quant_coarse_topk dispatch: the plain version's fp32 dequant working
    set is bounded by ``chunk`` rows a query (the kernel on the card holds
    no dequantized row in device memory). The control (``chunk=C``) is the
    plain version at full width, called itself on either device: it
    dequantizes the whole [Q, C, D]."""
    from repro_torch.kernels.quant_rerank.ops import quant_coarse_topk
    from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref
    from repro_torch.store.quantized import encode
    rng = np.random.default_rng(13)
    Qn, C, D, L, ch = 6, 80, 32, 320, 16
    store = encode(_t(rng.normal(size=(L, D)).astype(np.float32)), "int8",
                   16)
    queries = _t(rng.normal(size=(Qn, D)).astype(np.float32))
    cand_ids = _t(rng.integers(0, L, (Qn, C)), torch.int32)
    counts = torch.ones((Qn, C), dtype=torch.float32, device=audit_device())
    use = ch if chunk is None else chunk
    coarse = quant_coarse_topk if chunk is None else quant_rerank_ref
    fn = lambda q, cid, cnt: coarse(
        q, store.codes, store.scales, cid, cnt, tau=1, k=8,
        metric="angular", chunk=use)
    return Fixture(fn=fn, args=(queries, cand_ids, counts),
                   dims={"Q": Qn, "C": C, "D": D, "chunk": use})


def distance_topk_fixture(naive: bool = False) -> Fixture:
    """rerank_topk dispatch (masked l2 rerank). The naive control broadcasts
    the [Q, L, D] difference tensor pairwise_sim's expansion form avoids."""
    rng = np.random.default_rng(17)
    Qn, L, D, k = 6, 512, 24, K_TOP
    queries = _t(rng.normal(size=(Qn, D)).astype(np.float32))
    base = _t(rng.normal(size=(L, D)).astype(np.float32))
    mask = torch.ones((Qn, L), dtype=torch.float32, device=audit_device())
    if naive:
        def fn(q, b, m):
            sim = -((q[:, None, :] - b[None, :, :]) ** 2).sum(dim=-1)
            sim = torch.where(m > 0, sim, torch.full_like(sim, -torch.inf))
            return torch.topk(sim, k)
    else:
        from repro_torch.kernels.distance_topk.ops import rerank_topk
        fn = lambda q, b, m: rerank_topk(q, b, m, k=k, metric="l2")
    return Fixture(fn=fn, args=(queries, base, mask),
                   dims={"Q": Qn, "L": L, "D": D})


def irli_topk_fixture(naive: bool = False) -> Fixture:
    """scorer_topk dispatch (fused scoring + top-m). The naive control
    selects via a [Q, m, B] one-hot stack instead of a top-k."""
    rng = np.random.default_rng(19)
    Qn, H, B, m = 6, 32, 1024, 7
    h = _t(rng.normal(size=(Qn, H)).astype(np.float32))
    w2 = _t(rng.normal(size=(H, B)).astype(np.float32))
    b2 = _t(rng.normal(size=(B,)).astype(np.float32))
    if naive:
        def fn(hh, ww, bb):
            logits = hh @ ww + bb[None, :]
            _, idx = torch.topk(logits, m)
            onehot = torch.nn.functional.one_hot(idx, B).float()  # [Q,m,B]
            vals = (onehot * logits[:, None, :]).sum(dim=-1)
            return vals, idx
    else:
        from repro_torch.kernels.irli_topk.ops import scorer_topk
        fn = lambda hh, ww, bb: scorer_topk(hh, ww, bb, m=m)
    return Fixture(fn=fn, args=(h, w2, b2),
                   dims={"Q": Qn, "B": B, "m": m})
