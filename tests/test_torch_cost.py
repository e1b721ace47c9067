"""The port's cost model (``repro_torch/analysis/cost.py``) against hand
counts and against the reference's ``repro.analysis.hlo.analyze_hlo`` on
the same programs, and each kernel's declared work (``ops.cost``) and fake
path.

Ported from ``tests/test_hlo_analysis.py``: the FLOPs of a matmul, of a
10-step and a 3 x 4 nested loop, and the HBM bytes of an 8-step loop. The
reference's other cases test its HLO parser (while-attribute order, a
missing condition, a dynamic trip count, ``trip_count`` of a missing
computation, tuple-typed results, the donation alias header, the
``benchmarks.hlo_analysis`` shim): an eager call has no HLO to parse and
runs each loop iteration, so they have no counterpart here (donation is
``analysis/contracts``'s storage identity, tested in
test_torch_analysis.py).

The DTensor and collective cases run on torch's ``fake`` process group of
256 ranks (a 16 x 16 "cuda" mesh), made for this module and destroyed
after it.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.hlo import analyze_hlo, compiled_text  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.analysis import trace  # noqa: E402
from repro_torch.analysis.cost import (COLLECTIVES, CostRecorder,  # noqa: E402
                                       analyze_call)


def _flops(fn, *args):
    return analyze_call(fn, args)[0]["flops"]


# ------------------------------------------------ hand counts (hlo tests) --
def test_plain_matmul_flops_exact():
    a, b = torch.zeros(128, 256), torch.zeros(256, 64)
    assert _flops(lambda a, b: a @ b, a, b) == 2 * 128 * 256 * 64


def test_bmm_with_an_fp32_output_counts_its_product():
    """bmm.dtype (bf16 operands, an fp32 output: the MoE's expert
    products on the card) passes its dtype positionally after the
    tensors; it is the same product's FLOPs (meta tensors: the CPU has no
    such kernel)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(4, 8, 16, dtype=torch.bfloat16, device="meta")
        b = torch.empty(4, 16, 8, dtype=torch.bfloat16, device="meta")
        rec, out = analyze_call(
            lambda a, b: torch.bmm(a, b, out_dtype=torch.float32), (a, b))
    assert out.dtype == torch.float32
    assert rec["flops"] == 2 * 4 * 8 * 16 * 8


def test_loop_multiplies_by_its_iterations():
    a = torch.zeros(64, 64)

    def f(a):
        c = a
        for _ in range(10):
            c = c @ a
        return c

    assert _flops(f, a) == 10 * 2 * 64 ** 3


def test_nested_loops_multiply():
    a = torch.zeros(32, 32)

    def f(a):
        c = a
        for _ in range(3):
            for _ in range(4):
                c = c @ a
        return c

    assert _flops(f, a) == 12 * 2 * 32 ** 3


def test_hbm_bytes_scale_with_the_loop():
    x = torch.zeros(1024, 1024)

    def f(x):
        c = x
        for _ in range(8):
            c = torch.tanh(c) * 2.0
        return c

    rec, _ = analyze_call(f, (x,))
    assert rec["hbm_bytes"] >= 8 * 1024 * 1024 * 4, rec["hbm_bytes"]
    # both results of an iteration live at once at most: two buffers
    assert rec["temp_bytes"] <= 3 * 1024 * 1024 * 4, rec


@pytest.mark.parametrize("case", ["matmul", "mlp"])
def test_flops_equal_the_reference_cost_model(case):
    rng = np.random.default_rng(0)
    if case == "matmul":
        shapes = [(128, 256), (256, 64)]

        def jf(a, b):
            return a @ b

        def tf(a, b):
            return a @ b
    else:
        shapes = [(32, 64), (64, 128), (128,), (128, 16), (16,)]

        def jf(x, w1, b1, w2, b2):
            return jax.nn.relu(x @ w1 + b1) @ w2 + b2

        def tf(x, w1, b1, w2, b2):
            return torch.relu(x @ w1 + b1) @ w2 + b2
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = analyze_hlo(compiled_text(jf, tuple(jnp.asarray(a)
                                               for a in arrs)))["flops"]
    got, out = analyze_call(tf, tuple(torch.from_numpy(a) for a in arrs))
    assert got["flops"] == want
    np.testing.assert_allclose(out.numpy(), np.asarray(jf(*arrs)),
                               rtol=1e-4, atol=1e-4)


# ----------------------------------------------- fake 256-rank world ------
@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield make_production_mesh(device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_dtensor_mm_counts_the_ranks_local_flops(mesh):
    """[64, 3072] rows Shard(0) on "data" x [3072, 256] columns Shard(1) on
    "model": the rank's 2·64·3072·256, not the whole mesh's 256x; the op
    recorder sees the local [64, 256] product alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = DTensor.from_local(torch.empty(64, 3072, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(3072, 256, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        rec, out = analyze_call(lambda a, b: a @ b, (a, b))
        ops = trace.record_call(lambda a, b: a @ b, (a, b)).ops
    assert rec["flops"] == 2 * 64 * 3072 * 256 == 100_663_296
    assert tuple(out.shape) == (1024, 4096)
    assert [(o.op, o.shape) for o in ops] == [("aten.mm.default", (64, 256))]


HLO_COLLECTIVES = """HloModule m

ENTRY %main (p0: s32[4096,20]) -> (s32[1048576,20], s32[4096,20]) {
  %p0 = s32[4096,20]{1,0} parameter(0)
  %ag = s32[1048576,20]{1,0} all-gather(s32[4096,20]{1,0} %p0), dimensions={0}
  %ar = s32[4096,20]{1,0} all-reduce(s32[4096,20]{1,0} %p0), to_apply=%add
  ROOT %t = (s32[1048576,20]{1,0}, s32[4096,20]{1,0}) tuple(%ag, %ar)
}
"""


def test_collectives_by_kind_as_the_reference_counts_them(mesh):
    """An all-gather of [4096, 20] int32 over 256 ranks and an all-reduce
    of it: the kinds and result bytes of the reference's cost model on the
    same program."""
    import torch.distributed as dist
    want = analyze_hlo(HLO_COLLECTIVES)

    def f(t):
        out = torch.empty((256 * 4096, 20), dtype=torch.int32)
        dist.all_gather_into_tensor(out, t)
        dist.all_reduce(t)
        return out

    rec, _ = analyze_call(f, (torch.zeros(4096, 20, dtype=torch.int32),))
    assert rec["collectives"] == {k: int(want["collectives"][k])
                                  for k in COLLECTIVES}
    assert rec["collective_count"] == want["collective_count"] == 2
    assert rec["collective_bytes"] == want["collective_bytes"]


def test_a_dry_run_read_without_an_answer_names_its_site():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), K.stand_in_card():
        x = torch.empty(4, device="meta")
        with pytest.raises(RuntimeError, match="test_torch_cost.py"):
            with CostRecorder(device="meta", dry=True):
                bool(x.sum() > 0)
        with CostRecorder(device="meta", dry=True,
                          answers={"test_torch_cost.py:"
                                   "test_a_dry_run_read_without_an_answer"
                                   "_names_its_site": True}) as rec:
            assert bool(x.sum() > 0) is True
    assert list(rec.host_reads.values()) == [1]


# ------------------------------------------- kernels: cost and fake path --
def _ops():
    from repro_torch.kernels.bce_logits import ops as bops
    from repro_torch.kernels.distance_topk import ops as dops
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.irli_topk import ops as iops
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.mega_query import ops as mops
    from repro_torch.kernels.quant_rerank import ops as qops
    return dict(irli_topk=iops, freq_topc=fops, quant_rerank=qops,
                mega_query=mops, bce_logits=bops, kchoice=kops,
                distance_topk=dops, flash_attention=faops,
                embedding_bag=eops)


def _case(name):
    """(inputs as (shape, dtype) or None, launcher(**inputs), plain
    version(**inputs) on real CPU tensors, the cost at these shapes
    counted by hand)."""
    from repro_torch.kernels.bce_logits.ref import weighted_bce_ref
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    from repro_torch.kernels.irli_topk.ref import irli_topk_ref
    from repro_torch.kernels.kchoice.ref import kchoice_ref
    from repro_torch.kernels.mega_query.ref import mega_search_ref
    from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref
    from repro_torch.store.quantized import QuantizedStore
    o = _ops()
    f32, i32 = torch.float32, torch.int32
    if name == "irli_topk":
        ins = dict(h=((2, 8, 16), f32), w2=((2, 16, 40), f32),
                   b2=((2, 40), f32))
        return (ins, lambda **t: o[name].irli_topk(**t, m=5),
                lambda **t: irli_topk_ref(**t, m=5),
                # 2·G·Q·H·B; (h + w2 + b2)·4 + G·Q·m·8
                {"flops": 2 * 2 * 8 * 16 * 40,
                 "bytes": (256 + 1280 + 80) * 4 + 2 * 8 * 5 * 8})
    if name == "freq_topc":
        ins = dict(cands=((6, 50), i32))
        return (ins, lambda **t: o[name].freq_topc(**t, C=4),
                lambda **t: freq_topc_ref(**t, C=4),
                {"flops": 0, "bytes": 6 * 50 * 4 + 6 * 4 * 8})
    if name == "quant_rerank":
        ins = dict(queries=((4, 64), f32), codes=((100, 64), torch.int8),
                   scales=((100, 2), f32), cand_ids=((4, 12), i32),
                   cand_counts=((4, 12), f32))
        return (ins, lambda **t: o[name].quant_rerank(**t, tau=1, k=5),
                lambda **t: quant_rerank_ref(**t, tau=1, k=5, chunk=5),
                # 48 slots valid and distinct: 48·2·64; queries + ids and
                # counts + 48 rows of 64 codes and 2 scales + [4, 5] out
                {"flops": 48 * 2 * 64,
                 "bytes": 1024 + 384 + 48 * (64 + 8) + 4 * 5 * 8})
    if name == "mega_query":
        ins = dict(w1=((2, 32, 16), f32), b1=((2, 16), f32),
                   w2=((2, 16, 24), f32), b2=((2, 24), f32),
                   members=((2, 24, 8), i32), rows=((50, 32), torch.int8),
                   scales=((50, 1), f32), queries=((3, 32), f32))
        kw = dict(m=2, tau=1, topC=10, k=4)

        def launch(w1, b1, w2, b2, members, rows, scales, queries):
            return o[name].mega_query(
                dict(w1=w1, b1=b1, w2=w2, b2=b2), members, rows, scales,
                None, queries, **kw)

        def plain(w1, b1, w2, b2, members, rows, scales, queries):
            return mega_search_ref(
                dict(w1=w1, b1=b1, w2=w2, b2=b2), members,
                QuantizedStore("int8", 32, rows, scales), queries, **kw)

        # C = k' = 10 of W = 32 slots: 30 coarse and 30 refined rows of
        # 32 + 4 bytes, 12 probed buckets of 8 members
        return (ins, launch, plain,
                {"flops": 2 * 2 * 3 * (32 * 16 + 16 * 24) + 60 * 2 * 32,
                 "bytes": (1024 + 32 + 768 + 48 + 96) * 4 + 12 * 8 * 4
                 + 60 * 36 + 3 * 9 * 4})
    if name == "bce_logits":
        ins = dict(logits=((6, 10), f32), targets=((6, 10), f32),
                   weights=((3,), f32))
        return (ins, lambda **t: o[name].bce_logits(**t, scale=0.5),
                lambda **t: weighted_bce_ref(*t.values(), 0.5),
                {"flops": 12 * 60, "bytes": 12 * 60 + 4 * 3})
    if name == "kchoice":
        ins = dict(topk_idx=((2, 20, 3), i32), order_=((2, 20), i32))
        order = torch.arange(20, dtype=i32).repeat(2, 1)
        return (ins, lambda topk_idx, order_: o[name].kchoice(
                    topk_idx, order_, B=8),
                lambda topk_idx, order_: kchoice_ref(topk_idx, order, B=8),
                {"flops": 2 * 20 * 4,
                 "bytes": 2 * 20 * 3 * 4 + 2 * 20 * 4 + 2 * 20 * 4})
    if name == "distance_topk":
        ins = dict(queries=((5, 16), f32), base=((30, 16), f32),
                   mask=((30,), torch.bool))
        return (ins, lambda **t: o[name].distance_topk(**t, k=4),
                lambda **t: distance_topk_ref(**t, k=4),
                {"flops": 2 * 5 * 30 * 16,
                 "bytes": 35 * 16 * 4 + 30 + 5 * 4 * 8})
    if name == "flash_attention":
        ins = dict(q=((1, 2, 16, 16), f32), k=((1, 1, 16, 16), f32),
                   v=((1, 1, 16, 16), f32))
        return (ins, lambda **t: o[name].flash_attention(**t),
                lambda **t: flash_attention_ref(**t),
                {"flops": 2 * 1 * 2 * 16 * 17 * 16,
                 "bytes": (2 * 2 + 2 * 1) * 16 * 16 * 4})
    assert name == "embedding_bag"
    ins = dict(ids=((4, 3), i32), weights=((4, 3), f32),
               table=((10, 8), f32))
    return (ins, lambda **t: o[name].embedding_bag(**t),
            lambda **t: embedding_bag_ref(**t),
            # 12 slots over a 10-row table: 10 distinct rows of 32 bytes
            {"flops": 2 * 4 * 3 * 8, "bytes": 4 * 3 * 8 + 10 * 32 + 4 * 32})


def _real(shape, dtype, gen):
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.3
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, dtype=dtype)
    return torch.randint(0, 8, shape, generator=gen, dtype=dtype)


def _leaves(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))]


#: the only ops a fake path may run: allocations, views and copies
_ALLOC = re.compile(r"aten\.(empty|empty_strided|empty_like|zeros|full|"
                    r"clone|copy_|fill_|zero_|lift_fresh|_to_copy)\b")


KERNELS = list(K.LAUNCHES)


@pytest.mark.parametrize("name", KERNELS)
def test_cost_equals_a_hand_count(name):
    ins, _, _, want = _case(name)
    o = _ops()[name]
    shapes = {k: s for k, (s, _) in ins.items()}
    got = {
        "irli_topk": lambda: o.cost(2, 8, 16, 40, 5),
        "freq_topc": lambda: o.cost(6, 50, 4),
        "quant_rerank": lambda: o.cost(4, 12, 64, 5, 100, n_blocks=2),
        "mega_query": lambda: o.cost(2, 3, 32, 16, 24, 8, 50, m=2,
                                     topC=10, refine_k=0, k=4),
        "bce_logits": lambda: o.cost(6, 10, 3),
        "kchoice": lambda: o.cost(2, 20, 3, 8),
        "distance_topk": lambda: o.cost(5, 30, 16, 4),
        "flash_attention": lambda: o.cost(1, 2, 1, 16, 16, itemsize=4),
        "embedding_bag": lambda: o.cost(4, 3, 10, 8),
    }[name]()
    assert got == want, (name, shapes)


@pytest.mark.parametrize("name", KERNELS)
def test_fake_path_shapes_cost_and_no_plain_op(name):
    """The launcher on meta tensors (the dry run's stand-in for the card)
    returns the plain version's output shapes and dtypes (the plain
    version run on real CPU tensors), bills ``cost()`` once, runs only
    allocations, views and copies, and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ins, launch, plain, want = _case(name)
    gen = torch.Generator().manual_seed(0)
    ref = _leaves(plain(**{k: _real(s, d, gen)
                           for k, (s, d) in ins.items()}))
    before = dict(K.LAUNCHES)
    with FakeTensorMode(), K.stand_in_card():
        fake = {k: torch.empty(s, dtype=d, device="meta")
                for k, (s, d) in ins.items()}
        with CostRecorder(device="meta", dry=True) as rec:
            tr = trace.record_call(lambda: launch(**fake))
        out = _leaves(tr.result)
    assert [(tuple(t.shape), t.dtype) for t in out] == \
        [(tuple(t.shape), t.dtype) for t in ref]
    assert all(t.is_meta for t in out)
    assert rec.launches == {name: 1}
    assert (rec.flops, rec.hbm_bytes) == (want["flops"], want["bytes"])
    assert dict(K.LAUNCHES) == before
    ran = [r.op for r in tr.ops if not r.view]
    assert ran and all(_ALLOC.match(op) for op in ran), ran


@pytest.mark.parametrize("name", ["irli_topk", "freq_topc", "quant_rerank",
                                  "distance_topk", "embedding_bag"])
def test_the_cpu_entry_bills_cost_not_the_plain_ops(name):
    """On the CPU the public entry runs the plain version, and the
    recorder bills the kernel's declared work, not the plain version's
    ops (the [Q, B] logits of irli_topk's plain version, say)."""
    ins, _, _, want = _case(name)
    o = _ops()[name]
    gen = torch.Generator().manual_seed(1)
    t = {k: _real(s, d, gen) for k, (s, d) in ins.items()}
    call = {
        "irli_topk": lambda: o.scorer_topk(t["h"], t["w2"], t["b2"], m=5),
        "freq_topc": lambda: o.frequent_topc(t["cands"], C=4),
        "quant_rerank": lambda: o.quant_coarse_topk(*t.values(), tau=1,
                                                    k=5),
        "distance_topk": lambda: o.rerank_topk(*t.values(), k=4),
        "embedding_bag": lambda: o.bag_lookup_reduce(*t.values()),
    }[name]
    rec, _ = analyze_call(call)
    assert rec["launches"] == {name: 1}
    assert rec["flops"] == want["flops"]
    # the outer entry's own ops (rerank_topk's where) come on top
    assert rec["hbm_bytes"] >= want["bytes"]
