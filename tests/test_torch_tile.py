"""The Python side of the tile GEMM's plans, on the CPU: the ring's depth
and stage bytes, the shared-memory models of irli_topk, mega_query and
distance_topk (each checked against the C side's own export on the card in
test_torch_cuda.py), distance_topk's split count and its rule for keeping
the lists in shared memory, and the TMA operand layout.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import tma_operand  # noqa: E402
from repro_torch.kernels.distance_topk import ops as dops  # noqa: E402
from repro_torch.kernels.irli_topk import ops as iops  # noqa: E402
from repro_torch.kernels.mega_query import ops as mops  # noqa: E402

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_slice_row_is_one_swizzle_span(dtype):
    """A slice is as deep as one 128-byte row of h: 32 fp32 or 64 bf16;
    a stage holds the X and the Y slice, 16 KB each."""
    esize = torch.empty((), dtype=dtype).element_size()
    assert iops.SLICE_DEPTH[dtype] * esize == 128
    assert iops.STAGE_BYTES == 2 * 128 * 128
    assert iops.STAGES >= 3


@pytest.mark.parametrize("m", [1, 5, 8, 9, 64])
def test_irli_footprint(m):
    """The ring (3 x 32 KB; each column tile's [128, 129] logits reuse
    it), two [128] lse halves and 256 half-row lists of m pairs, a multiple
    of 1024 bytes (so mega_query's second worker starts aligned); a block
    adds 1024 bytes of alignment slack and fits the card at every m <= 64,
    and two such workers (mega_query's block) up to m = 8."""
    tile = iops.tile_smem_bytes(m)
    assert tile == 3 * 32_768 + 2 * 128 * 4 + 256 * m * 8
    assert tile % 1024 == 0 and 128 * 129 * 4 <= 3 * 32_768
    assert iops.smem_bytes(m) == 1024 + tile <= mops.SMEM_BYTES
    assert (1024 + 2 * tile <= mops.SMEM_BYTES) == (m <= 8)


@pytest.mark.parametrize("m", list(range(1, 13)))
def test_mega_tiles_fit_up_to_m_8(m):
    """Two scorer tiles share one block: at DEFAULT_GEOM the fused kernel
    fits up to m = 8 (two tiles of 109,568 bytes at m = 5)."""
    assert mops.mega_fits(m, 1024, 0, 10) == (m <= 8)
    g = dict(mops.DEFAULT_GEOM)
    p = mops.plan(g["R"], g["ML"], m, 1024, 0, 10)
    assert mops.smem_bytes(p, R=g["R"], m=m, D=g["D"]) >= \
        1024 + 2 * iops.tile_smem_bytes(m)


@pytest.mark.parametrize("d,k,in_smem,resident", [
    (96, 1, True, True),
    (96, 10, True, True),         # the exact oracle
    (96, 100, True, True),        # chip_smoke's neighbours chunk
    (96, 108, True, True),        # the widest lists in shared memory at d = 96
    (96, 109, False, True),
    (100, 10, True, True),
    (17, 300, False, True),
    (8, 1, True, True),
    (288, 10, True, True),        # the widest d the resident tile allows
    (289, 10, True, False),       # past it the tile's slices stream
    (384, 10, True, False),
    (768, 92, True, False),       # the widest lists in shared memory then
    (768, 93, False, False),
    (960, 100, False, False),
    (4096, 1, True, False),
])
def test_distance_lists_rule(d, k, in_smem, resident):
    """One block an SM holds the ring (4 stages of 16 KB), the resident
    query tile ([ceil32(d)][128] fp32) while it fits beside them (else 4
    stages of 32 KB that also bring the tile's slices), the warps' one-row
    staging areas and the rows' counts and thresholds; the [128, k] lists
    stay in shared memory while they fit beside them. Every d fits."""
    assert dops.query_resident(d) == resident
    assert dops.lists_in_smem(d, k) == in_smem
    assert dops.blocks_per_sm(d, k) == 1
    smem = dops.smem_bytes(d, k)
    ring = 4 * 16_384 + -(-d // 32) * 32 * 512 if resident else 4 * 32_768
    assert smem == (1024 + ring + 8 * 128 * 4 + 3 * 128 * 4
                    + (128 * k * 8 if in_smem else 0))
    assert smem <= dops.SMEM_BYTES


@pytest.mark.parametrize("Q,L,k,per_sm,want", [
    (1024, 2_065_536, 10, 1, 16),   # the stream cell's oracle: 1009 tiles each
    (1024, 2_065_536, 10, 2, 33),   # two blocks an SM would double them
    (3, 50_000, 12, 1, 131),
    (64, 70_000, 100, 1, 110),
    (130, 5000, 10, 1, 40),         # one tile a split
    (1, 1, 1, 1, 1),
    (64, 2_000_000, 10, 2, 261),
])
def test_distance_split_count(Q, L, k, per_sm, want):
    """One wave of blocks, no empty split, at most MAX_SPLITS."""
    s = dops.split_count(Q, L, k, 132, per_sm)
    assert -(-Q // 128) * s <= 132 * per_sm or s == 1
    assert s == want
    tiles = -(-L // 128)
    tps = -(-tiles // s)
    assert (s - 1) * tps < tiles <= s * tps and s <= dops.MAX_SPLITS


@pytest.mark.parametrize("shape,dtype,sl,copied,ld", [
    ((2, 7, 33), torch.float32, None, True, 36),
    ((1, 5, 16), torch.float32, None, False, 16),
    ((2, 3, 20), torch.bfloat16, None, True, 24),
    ((2, 4, 96), torch.float32, None, False, 96),
    ((2, 4, 96), torch.float32, 40, False, 96),     # a view: rows as they lie
    ((2, 96, 4), torch.float32, "T", True, 96),     # columns not contiguous
])
def test_tma_operand(shape, dtype, sl, copied, ld):
    """A tensor already laid out for a tensor map goes as it is; any other
    is copied into zero-padded 16-byte rows, with the same values."""
    x = torch.randn(shape).to(dtype)
    if sl == "T":
        x = x.transpose(1, 2)
    elif sl is not None:
        x = x[..., :sl]
    y = tma_operand(x)
    assert (y.data_ptr() != x.data_ptr()) == copied
    assert y.shape == x.shape and torch.equal(y, x)
    assert y.stride(1) == ld and y.stride(0) == y.shape[1] * ld
    assert (ld * y.element_size()) % 16 == 0 and y.data_ptr() % 16 == 0
