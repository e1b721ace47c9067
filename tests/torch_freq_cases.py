"""Candidate rows shared by the freq_topc tests on the CPU
(test_torch_kernels.py) and on the card (test_torch_cuda.py), and by
chip_smoke.py's freq_topc phase. Imports no jax: the card's machine has
none."""
import functools

import numpy as np

#: the cases of test_kernels.py's freq_topc: (Q, C0, V, C)
FREQ_CASES = [
    (8, 96, 40, 16),      # fewer values than slots: heavy duplication
    (7, 120, 500, 64),    # mostly-distinct
    (4, 100, 30, 160),    # C > C0: output right-padded
]

#: row widths at the edges of the kernel's warps (2048 ids), its block
#: (32,768) and its clusters, the stream cell's 65,280, and past it
WIDTHS = [1, 31, 777, 32_000, 32_768, 32_769, 65_280, 70_000]

INT_MAX = 2 ** 31 - 1


def random_rows(Q, C0, V, seed=None):
    """[Q, C0] int32 ids in [-1, V) (pad -1): row 0 half pads, the last
    row all pads."""
    rng = np.random.default_rng(Q + C0 if seed is None else seed)
    cands = rng.integers(-1, V, (Q, C0)).astype(np.int32)
    cands[0, : C0 // 2] = -1                     # heavily padded row
    cands[-1] = -1                               # zero-candidate row
    return cands


def runs_row(rng, counts, width, lo=0):
    """One row: ids lo, lo+1, ... repeated counts[i] times, the rest of the
    width distinct ids past them, shuffled."""
    ids = np.repeat(np.arange(lo, lo + len(counts)), counts)
    rest = width - len(ids)
    ids = np.concatenate([ids, lo + len(counts) + np.arange(rest)])
    return rng.permutation(ids).astype(np.int32)


@functools.cache
def freq_rows():
    """name -> (cands [Q, C0] int32, C): the widths above with random ids
    (C = 1024), and the adversarial rows: all pads, one id repeated 65,280
    times, all-distinct rows, ids near 2^31 - 2 (and 2^31 - 1), C past the
    distinct ids, counts spread wider than a ranking window (63 values),
    negative ids other than -1."""
    rng = np.random.default_rng(20)
    rows = {f"width {w}": (random_rows(3, w, max(w // 2, 2)), 1024)
            for w in WIDTHS}
    rows["all pads"] = (np.full((2, 1000), -1, np.int32), 16)
    one = np.full((2, 65_280), 7, np.int32)
    one[1, ::9] = -1
    rows["one id x 65,280"] = (one, 1024)
    rows["one id x 32,000"] = (np.full((2, 32_000), 123_456, np.int32), 5)
    rows["all distinct 32,768"] = (np.stack(
        [rng.permutation(32_768) for _ in range(2)]).astype(np.int32), 1024)
    rows["all distinct 65,280"] = (np.stack(
        [rng.permutation(65_280) * 3 for _ in range(2)]).astype(np.int32),
        1024)
    big = rng.integers(INT_MAX - 5000, INT_MAX - 1, (3, 5000)).astype(
        np.int32)
    big[0, ::7] = -1
    big[2, :3] = INT_MAX
    rows["ids near 2^31 - 2"] = (big, 1024)
    wide_big = rng.integers(INT_MAX - 20_000, INT_MAX - 1, (2, 40_000))
    rows["ids near 2^31 - 2, 40,000 wide"] = (wide_big.astype(np.int32), 64)
    rows["C > distinct ids"] = (random_rows(4, 777, 50), 1024)
    spread = [256 * i + 1 for i in range(1, 12)]              # 11 windows
    rows["counts past one window"] = (np.stack(
        [runs_row(rng, spread, 32_768),
         runs_row(rng, spread[::-1], 32_768, 9)]), 1024)
    rows["counts past one window, 70,000 wide"] = (np.stack(
        [runs_row(rng, spread + [3000, 5000], 70_000),
         runs_row(rng, [2] * 700 + spread, 70_000, 40)]), 8)
    neg = rng.integers(-9, 60, (3, 3000)).astype(np.int32)
    rows["negative pads"] = (neg, 100)
    return rows


#: the names of freq_rows(), for parametrize
FREQ_ROW_NAMES = list(freq_rows())
