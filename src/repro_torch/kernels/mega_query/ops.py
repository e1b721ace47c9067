"""The ONE dispatch site of ``mode="mega"`` (core/query.QueryPipeline.search
routes every such call here) and the fused kernel's H100 footprint model.

``mega_search`` picks, from shapes and state alone, before any launch:

  * on the CPU: the plain version (ref.py, the compact op sequence);
  * on the card, when the kernel can serve the request (no delta/tombstone
    state, fp32 scorer, the footprint fits): ONE launch of the fused kernel
    (mega_query.cu) and no other kernel;
  * on the card otherwise: the compact pipeline, which launches its own
    kernels (irli_topk, freq_topc, quant_rerank), with the same results.

The footprint model (``mega_smem_bytes``) is the kernel's shared memory per
block, the larger of its two layouts: the two 256-thread tile workers'
scorer tiles (irli_topk's ``tile_smem_bytes``: the ring of GEMM slices,
which the [128, 129] logit tile reuses, and the running top-m lists, plus
1024 bytes to align the first), and the per-query stage (the sort row of
n = next power of two >= R·m·ML candidates, the top-C slots, the packed-key
arrays, the query). It replaces the reference's TPU VMEM model
(kernel_vmem_bytes against 0.75 x 16 MB): what the H100 limits is one
block's 232,448 bytes of shared memory, and the freq_topc sort width
(n <= 32768). ``kernel_attrs`` reads the C side's own account on the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import (H100_SMS, LAUNCHES, billing, check_launch,
                                 holds_no_data, on_card, tma_operand)
from repro_torch.kernels.freq_topc.ops import MAX_WIDTH, sort_width
from repro_torch.kernels.irli_topk.ops import MAX_M, tile_smem_bytes
from repro_torch.kernels.mega_query.ref import mega_search_ref
from repro_torch.store.quantized import QuantizedStore
from repro_torch.store.rerank import resolve_refine_k

#: Serving geometry for SHAPE-FREE eligibility (select_mode runs before the
#: index exists), the reference's DEFAULT_GEOM: d=128 query dim, H=1024
#: hidden, B=4096 buckets, R=2 reps, max_load=64, D=128 payload dim, int8
#: block 32 (tq and tb are TPU tile sizes the H100 model does not read).
DEFAULT_GEOM = dict(tq=8, d=128, H=1024, B=4096, R=2, ML=64, D=128,
                    block=32, tb=512)
#: dynamic shared memory one block may use on the H100 (sm_90)
SMEM_BYTES = 232_448
#: tile workers a block (mega_query.cu kWorkers)
_WORKERS = 2
#: store kinds of the kernel
_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
def _pow2(c: int) -> int:
    p = 1
    while p < c:
        p *= 2
    return p


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's widths for one request: W candidate slots, the sort
    width n, C = min(topC, W) FrequentOnes slots, k' coarse survivors and
    the final k_eff = min(k, C) real columns; Cp, Kp the packed-key sort
    widths."""
    W: int
    n: int
    C: int
    Cp: int
    kp: int
    Kp: int
    k_eff: int


def plan(R: int, ML: int, m: int, topC: int, refine_k: int, k: int) -> Plan:
    W = R * m * ML
    C = min(topC, W)
    kp = min(resolve_refine_k(refine_k, k, topC), C)
    return Plan(W=W, n=sort_width(W), C=C, Cp=_pow2(C), kp=kp,
                Kp=_pow2(kp), k_eff=min(k, C))


def smem_bytes(p: Plan, *, R: int, m: int, D: int) -> int:
    """The launch's dynamic shared memory (mega_query.cu smem_needed)."""
    per_query = (_align16(max(4 * p.n, 8 * p.Cp, 8 * p.Kp))
                 + 3 * _align16(4 * p.C) + _align16(4 * D)
                 + 2 * _align16(4 * R * m) + 2 * _align16(4 * p.kp) + 16)
    return max(per_query, 1024 + _WORKERS * tile_smem_bytes(m))


def mega_smem_bytes(m: int, topC: int, refine_k: int, k: int, *,
                    geom: dict | None = None) -> int:
    """The fused kernel's shared memory per block for a (m, topC, k', k)
    knob combo over ``geom`` (DEFAULT_GEOM when None)."""
    g = dict(DEFAULT_GEOM, **(geom or {}))
    p = plan(g["R"], g["ML"], m, topC, refine_k, k)
    return smem_bytes(p, R=g["R"], m=m, D=g["D"])


def mega_fits(m: int, topC: int, refine_k: int, k: int, *,
              geom: dict | None = None) -> bool:
    """True iff the fused kernel can serve these knobs on the H100: the
    candidate row fits the freq_topc sort (R·m·ML <= MAX_WIDTH), m fits the
    scorer tile's lists and the buckets, and the shared memory fits one
    block. The auto-mode gate (core/query.select_mode)."""
    g = dict(DEFAULT_GEOM, **(geom or {}))
    if g["R"] * m * g["ML"] > MAX_WIDTH or not 1 <= m <= min(MAX_M, g["B"]):
        return False
    return mega_smem_bytes(m, topC, refine_k, k, geom=geom) <= SMEM_BYTES


# ------------------------------------------------------------ the kernel --
@functools.cache
def _lib():
    """The kernel's C entries, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("mega_query")
    lib.mega_query_grid.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
    lib.mega_query_grid.restype = ctypes.c_int
    lib.mega_query_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.mega_query_launch.restype = ctypes.c_int
    lib.mega_query_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_longlong)]
    lib.mega_query_attrs.restype = ctypes.c_int
    return lib


def kernel_attrs(rows_dtype=torch.int8, m: int = 5) -> dict[str, int]:
    """The C side's own account (mega_query_attrs, on the card) for a store
    kind: registers a thread, local (spill) bytes a thread, the two
    workers' scorer-tile shared memory at m, ring stages, slice depth."""
    out = (ctypes.c_longlong * 5)()
    check_launch("mega_query_attrs",
                 _lib().mega_query_attrs(_KINDS[rows_dtype], m, out))
    return dict(zip(("registers", "spill_bytes", "tiles_smem_bytes",
                     "stages", "slice_depth"), out))


@functools.cache
def _grid(device_index: int, kind: int, smem: int) -> int:
    """Blocks of the cooperative launch: as many as fit the card at once."""
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().mega_query_grid(kind, smem, ctypes.byref(grid))
    check_launch("mega_query (occupancy)", err)
    return grid.value


def cost(R: int, Q: int, d: int, H: int, B: int, ML: int, L: int, *,
         m: int, topC: int, refine_k: int, k: int, block: int = 32,
         row_bytes: int | None = None, valid: int | None = None,
         refine: int | None = None, buckets: int | None = None,
         code_rows: int | None = None,
         refine_rows: int | None = None) -> dict:
    """The work of one launch: both scorer GEMMs (2·R·Q·(d·H + H·B)) and
    2·d operations a valid coarse slot and a refined survivor; the scorer
    and the queries read once, each probed bucket's member row once, each
    distinct code row and refine row once (``row_bytes`` a row: int8 codes
    and their scales by default), the ids, scores and counts written once.
    What the data decides has a default from the shapes: every one of the
    Q·C coarse slots valid and distinct, every probe a distinct bucket,
    Q·k' refined rows."""
    p = plan(R, ML, m, topC, refine_k, k)
    valid = Q * p.C if valid is None else valid
    refine = Q * p.kp if refine is None else refine
    buckets = min(R * Q * m, R * B) if buckets is None else buckets
    code_rows = min(valid, L) if code_rows is None else code_rows
    refine_rows = min(refine, L) if refine_rows is None else refine_rows
    row_bytes = d + d // block * 4 if row_bytes is None else row_bytes
    return {"flops": 2 * R * Q * (d * H + H * B) + (valid + refine) * 2 * d,
            "bytes": (R * d * H + R * H + R * H * B + R * B + Q * d) * 4
            + buckets * ML * 4 + (code_rows + refine_rows) * row_bytes
            + Q * (2 * k + 1) * 4}


def _check(name, t, dtype, ndim):
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"mega_query: {name} must be {ndim}-d {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def mega_query(params: dict, members, rows, scales, exact, queries, *,
               m: int, tau: int, topC: int, k: int, refine_k: int = 0,
               metric: str = "angular", adaptive_m: bool = False,
               probe_mass: float = 1.0, phases: int = 3,
               select: bool = True):
    """Launch the fused kernel: scorer params (w1 [R, d, H], b1 [R, H], w2
    [R, H, B], b2 [R, B] f32), members [R, B, ML] int32, rows [L, d] f32 |
    int8 | bf16 (+ scales [L, d/block] f32 for int8, exact [L, d] f32 or
    None), queries [Q, d] f32, all on the card -> (ids [Q, k] int32,
    scores [Q, k] f32, n_candidates [Q] int32). Allocates outputs and
    scratch with torch.empty: the launch is the only kernel it runs.

    ``phases`` < 3 or ``select=False`` make the launch a timing probe whose
    outputs are meaningless: it runs phases 1 .. ``phases`` only, and
    without ``select`` phase 2 walks its GEMM with no top-m (phases <= 2
    then)."""
    w1, b1, w2, b2 = (params[n] for n in ("w1", "b1", "w2", "b2"))
    if not on_card(w1, b1, w2, b2, members, rows, scales, exact, queries):
        raise ValueError("mega_query launches on CUDA tensors only")
    for name, t, nd in (("w1", w1, 3), ("b1", b1, 2), ("w2", w2, 3),
                        ("b2", b2, 2), ("queries", queries, 2)):
        _check(name, t, torch.float32, nd)
    _check("members", members, torch.int32, 3)
    if rows.dtype not in _KINDS or rows.ndim != 2:
        raise ValueError(f"mega_query: rows must be [L, D] of "
                         f"{list(_KINDS)}, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    R, d, H = w1.shape
    B = w2.shape[2]
    ML = members.shape[2]
    L, D = rows.shape
    Q = queries.shape[0]
    if (tuple(b1.shape) != (R, H) or tuple(w2.shape) != (R, H, B)
            or tuple(b2.shape) != (R, B) or tuple(members.shape[:2]) != (R, B)
            or queries.shape[1] != d or D != d):
        raise ValueError("mega_query: scorer, members, rows and queries "
                         "shapes disagree")
    if phases not in (1, 2, 3) or (not select and phases == 3):
        raise ValueError(f"mega_query: phases={phases}, select={select} "
                         f"(a probe without selection stops at phase 2)")
    kind = _KINDS[rows.dtype]
    n_blocks = block = 1
    if (scales is not None) != (kind == 1):
        raise ValueError("mega_query: int8 rows need scales; others take "
                         "none")
    if scales is not None:
        _check("scales", scales, torch.float32, 2)
        n_blocks = scales.shape[1]
        block = D // n_blocks
        if tuple(scales.shape) != (L, n_blocks) or n_blocks * block != D:
            raise ValueError(f"mega_query: scales {tuple(scales.shape)} do "
                             f"not block rows [{L}, {D}]")
    if exact is not None:
        _check("exact", exact, torch.float32, 2)
        if tuple(exact.shape) != (L, D):
            raise ValueError("mega_query: exact tier shape != rows shape")
    geom = dict(R=R, B=B, ML=ML, d=d, D=D)
    if not mega_fits(m, topC, refine_k, k, geom=geom):
        raise ValueError(
            f"mega_query: m={m}, topC={topC}, refine_k={refine_k}, k={k} at "
            f"{geom} do not fit the kernel (mega_fits); use mode='compact'")
    p = plan(R, ML, m, topC, refine_k, k)
    smem = smem_bytes(p, R=R, m=m, D=D)
    row_bytes = D * rows.element_size() + (n_blocks * 4 if kind == 1 else 0)
    with billing("mega_query", lambda: cost(
            R, Q, d, H, B, ML, L, m=m, topC=topC, refine_k=refine_k, k=k,
            block=block, row_bytes=row_bytes)):
        return _launch(w1, b1, w2, b2, members, rows, scales, exact, queries,
                       p, smem, kind, n_blocks, block, m=m, tau=tau, k=k,
                       metric=metric, adaptive=adaptive_m
                       and probe_mass < 1.0, probe_mass=probe_mass,
                       phases=phases, select=select)


def _launch(w1, b1, w2, b2, members, rows, scales, exact, queries, p, smem,
            kind, n_blocks, block, *, m, tau, k, metric, adaptive,
            probe_mass, phases, select):
    """Allocate the outputs and the scratch and launch; tensors without
    data stop before the launch (the fake path, which plans one block an
    SM of an H100 in place of the card's occupancy query)."""
    R, d, H = w1.shape
    B = w2.shape[2]
    ML = members.shape[2]
    D = rows.shape[1]
    Q = queries.shape[0]
    dev = queries.device
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    scores = torch.empty((Q, k), dtype=torch.float32, device=dev)
    n_cand = torch.empty((Q,), dtype=torch.int32, device=dev)
    if Q == 0:
        return ids, scores, n_cand
    fake = holds_no_data(w1, b1, w2, b2, members, rows, scales, exact,
                         queries)
    grid = H100_SMS if fake else _grid(dev.index, kind, smem)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = {
        # rows padded to 16 bytes: phase 2 reads them by TMA
        "hid": torch.empty((R, Q, -(-H // 4) * 4), **f32)[..., :H],
        "part_v": torch.empty((R, Q, m), **f32),
        "part_i": torch.empty((R, Q, m), dtype=torch.int32, device=dev),
        "part_lse": torch.empty((R, Q), **f32) if adaptive else None,
        "srt": torch.empty((grid, p.n), dtype=torch.int32, device=dev),
        "kscr": torch.empty((grid, p.n), dtype=torch.int32, device=dev),
    }
    queries = tma_operand(queries[None])[0]
    w1, w2 = tma_operand(w1), tma_operand(w2)
    ins = [queries, w1, b1.contiguous(), w2, b2.contiguous(),
           members.contiguous(), rows.contiguous()]
    ins += [None if t is None else t.contiguous() for t in (scales, exact)]
    if fake:
        return ids, scores, n_cand
    ptrs = [None if t is None else t.data_ptr() for t in ins + [
        scratch["hid"], scratch["part_v"], scratch["part_i"],
        scratch["part_lse"], scratch["srt"], scratch["kscr"], ids, scores,
        n_cand]]
    ints = [Q, D, R, H, B, ML, n_blocks, block, m, p.n, p.C, p.Cp, p.kp,
            p.Kp, k, p.k_eff, int(metric == "l2"), int(adaptive),
            queries.stride(0), w1.stride(1), scratch["hid"].stride(1),
            w2.stride(1), phases, int(select)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().mega_query_launch(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ints))(*ints), float(tau),
            float(probe_mass), kind, grid, smem, stream)
    check_launch("mega_query", err)
    LAUNCHES["mega_query"] += 1
    return ids, scores, n_cand


def _kernel_eligible(pipe, params, members, base, queries, delta_members,
                     tombstone) -> bool:
    """Whether the fused kernel serves this request, decided from state,
    dtypes and shapes alone (never from a failed launch)."""
    if delta_members is not None or tombstone is not None:
        return False                      # streaming state: compact union
    if any(params[n].dtype != torch.float32 for n in ("w1", "b1", "w2",
                                                       "b2")):
        return False
    if queries.dtype != torch.float32 or members.dtype != torch.int32:
        return False
    rows = base.codes if isinstance(base, QuantizedStore) else base
    if rows.dtype not in _KINDS or rows.shape[1] != queries.shape[1]:
        return False
    R, B, ML = members.shape
    d = queries.shape[1]
    return mega_fits(pipe.m, pipe.topC, pipe.refine_k, pipe.k,
                     geom=dict(R=R, B=B, ML=ML, d=d, D=d))


def mega_search(pipe, params, members, base, queries, delta_members=None,
                tombstone=None):
    """mode="mega" (called by QueryPipeline.search) -> (ids [Q, k] int32,
    scores [Q, k] f32, n_candidates [Q] int32), the compact path's result.
    ``base`` is a raw fp32 [L, d] tensor or a QuantizedStore."""
    store = base if isinstance(base, QuantizedStore) else None
    rows = store.codes if store is not None else base
    if not on_card(queries, members, rows):
        R, B, ML = members.shape
        H = params["w1"].shape[2]
        row_bytes = rows.shape[1] * rows.element_size() + (
            0 if store is None or store.scales is None
            else store.scales.shape[1] * 4)
        with billing("mega_query", lambda: cost(
                R, queries.shape[0], queries.shape[1], H, B, ML,
                rows.shape[0], m=pipe.m, topC=pipe.topC,
                refine_k=pipe.refine_k, k=pipe.k, row_bytes=row_bytes)):
            return mega_search_ref(
                params, members, base, queries, delta_members, tombstone,
                m=pipe.m, tau=pipe.tau, topC=pipe.topC, k=pipe.k,
                refine_k=pipe.refine_k, metric=pipe.metric,
                adaptive_m=pipe.adaptive_m, probe_mass=pipe.probe_mass,
                chunk=resolve_refine_k(pipe.refine_k, pipe.k, pipe.topC))
    if not _kernel_eligible(pipe, params, members, base, queries,
                            delta_members, tombstone):
        return dataclasses.replace(pipe, mode="compact").search(
            params, members, base, queries, delta_members, tombstone)
    return mega_query(
        params, members, rows, None if store is None else store.scales,
        None if store is None else store.exact, queries, m=pipe.m,
        tau=pipe.tau, topC=pipe.topC, k=pipe.k, refine_k=pipe.refine_k,
        metric=pipe.metric, adaptive_m=pipe.adaptive_m,
        probe_mass=pipe.probe_mass)


# ------------------------------------------------------- static contracts --
# The fused path's reason to exist, as a registered invariant: mode="mega"
# is ONE dispatch (on the card one CUDA kernel, mega_query) with the
# compact memory guarantees inside. The control is the per-stage split of
# the same search, which MUST trip the counters.
from repro_torch.analysis import contracts as _C  # noqa: E402


def _mega_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.mega_store_search()


def _split_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.mega_split_control()


_C.register(_C.Contract(
    id="query.mega_single_dispatch",
    site="repro_torch.kernels.mega_query.ops.mega_search",
    description="mode='mega' is exactly one dispatch — one CUDA kernel on "
                "the card, no per-stage kernel round-trips — and inside it "
                "the compact guarantees hold: no [Q, L] count table, no "
                "fp32 [L, D] store decode, the [Q, C] candidates held on "
                "chip by mega_query on the card. The control is the staged "
                "split of the same search, which MUST trip the counters",
    fixture=_mega_fixture,
    checks=[
        _C.max_dispatches(1),
        _C.forbid_dims("Q", "L"),
        _C.require_dtype_free("float32", "L", "D"),
        _C.require_dims("Q", "C", on_chip="mega_query"),
    ],
    control=_split_control,
))
