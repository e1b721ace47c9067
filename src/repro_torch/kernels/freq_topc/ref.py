"""Plain PyTorch version of the FrequentOnes top-C kernel, and a plain
model of the kernel's schedule.

Same contract as the reference's ``freq_topc_ref`` and the CUDA kernel:
count-descending, ties toward the smaller id, -1/0 padding past the
distinct-candidate count. ``freq_topc_radix`` takes the kernel's steps
(pad key, radix passes, run ends, count windows) in torch; the tests and
chip_smoke.py hold it against ``freq_topc_ref``, the main path never runs
it.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable

#: keys a thread of the kernel holds, keys one block holds (512 threads),
#: bits of a ranking pass's digit
KEYS, CHUNK, DIGIT_BITS = 64, 32768, 6


def freq_topc_ref(cands: torch.Tensor, *, C: int):
    """cands [Q, C0] int32 (pad -1) -> (ids [Q, C] int32, counts [Q, C] f32)."""
    Q, C0 = cands.shape
    C_eff = min(C, C0)
    s = torch.sort(cands, dim=1).values                       # pads (-1) first
    is_start = torch.ones_like(s, dtype=torch.bool)
    is_start[:, 1:] = s[:, 1:] != s[:, :-1]
    run_id = torch.cumsum(is_start, dim=1) - 1                # [Q, C0] int64
    counts = torch.zeros((Q, C0), dtype=torch.float32, device=cands.device)
    counts.scatter_add_(1, run_id, torch.ones_like(counts))
    score = torch.where(is_start & (s >= 0), torch.gather(counts, 1, run_id),
                        torch.full_like(counts, -1.0))
    top_cnt, top_pos = topk_stable(score, C_eff)
    ids = torch.where(top_cnt > 0, torch.gather(s, 1, top_pos),
                      torch.full_like(top_pos, -1)).to(torch.int32)
    top_cnt = top_cnt.clamp_min(0.0)
    if C_eff < C:                                             # pad to C
        ids = torch.cat([ids, ids.new_full((Q, C - C_eff), -1)], dim=1)
        top_cnt = torch.cat([top_cnt, top_cnt.new_zeros((Q, C - C_eff))],
                            dim=1)
    return ids, top_cnt


def sort_passes(pad: int, digit_bits: int = DIGIT_BITS) -> tuple[int, int]:
    """(passes, bits a digit) of the id sort: b = bit_length(pad) bits,
    pad = max_id + 1, in ceil(b / digit_bits) passes of equal width."""
    b = int(pad).bit_length()
    passes = -(-b // digit_bits)
    return passes, (-(-b // passes) if passes else 0)


def _ranks(d: torch.Tensor, chunk: int, bins: int) -> torch.Tensor:
    """The kernel's stable ranks of digits d [slots] (slot order: chunks of
    ``chunk``, then threads of KEYS slots): each chunk's digit counts
    scanned digit-major over the chunks (the wide kernel's [bins, chunks]
    table), plus each key's rank in its chunk: its thread's counter of its
    digit, scanned digit-major then by thread, counted on in slot order."""
    chunks, threads = d.numel() // chunk, chunk // KEYS
    dc = d.view(chunks, chunk)
    hist = torch.zeros((bins, chunks), dtype=torch.int64)
    hist.index_put_((dc, torch.arange(chunks)[:, None].expand_as(dc)),
                    torch.ones_like(dc), accumulate=True)
    base = (torch.cumsum(hist.flatten(), 0) - hist.flatten()).view(bins,
                                                                  chunks)
    thread = torch.arange(chunk) // KEYS
    ranks = torch.empty_like(dc)
    for k in range(chunks):
        col = torch.zeros((bins, threads), dtype=torch.int64)
        col.index_put_((dc[k], thread), torch.ones_like(thread),
                       accumulate=True)
        start = (torch.cumsum(col.flatten(), 0) - col.flatten()).view_as(col)
        order = torch.argsort(dc[k] * threads + thread, stable=True)
        within = torch.empty_like(order)
        within[order] = torch.arange(chunk)       # rank in the chunk
        ranks[k] = base[dc[k], k] + within - start[dc[k], 0]
    return ranks.flatten()


def freq_topc_radix(cands: torch.Tensor, *, C: int, chunk: int = CHUNK,
                    digit_bits: int = DIGIT_BITS):
    """The kernel's schedule in torch, row by row: cands [Q, C0] int32 (pad:
    any negative id) -> (ids [Q, C] int32, counts [Q, C] f32), equal to
    freq_topc_ref bit for bit. Rows of at most ``chunk`` ids take one block
    (slots: C0 rounded up to whole warps of 32 threads, KEYS slots each),
    wider rows whole chunks; the id sort runs sort_passes(max_id + 1,
    digit_bits) stable passes; each run's count sits at its last slot; the
    top-C ranks the counts in windows of 2^digit_bits - 1 values, largest
    first."""
    Q, C0 = cands.shape
    warp = min(32 * KEYS, chunk)
    slots = (-(-C0 // warp) * warp if C0 <= chunk
             else -(-C0 // chunk) * chunk)
    block = min(slots, chunk)
    ids = torch.full((Q, C), -1, dtype=torch.int32)
    cnt = torch.zeros((Q, C), dtype=torch.float32)
    last = (1 << digit_bits) - 1                     # the unranked bin
    for q in range(Q):
        x = cands[q].to(device="cpu", dtype=torch.int64)
        pad = int(x.max().clamp_min(-1)) + 1 if C0 else 0
        if pad == 0:
            continue
        keys = torch.full((slots,), pad, dtype=torch.int64)
        keys[:C0] = torch.where(x < 0, pad, x)
        passes, bits = sort_passes(pad, digit_bits)
        for p in range(passes):
            d = (keys >> (p * bits)) & ((1 << bits) - 1)
            nxt = torch.empty_like(keys)
            nxt[_ranks(d, block, 1 << bits)] = keys
            keys = nxt
        pos = torch.arange(slots)
        nxt = torch.cat([keys[1:], keys.new_full((1,), -1)])
        end = (keys != pad) & (nxt != keys)
        start = torch.searchsorted(keys, keys)       # first slot of the run
        c = torch.where(end, pos - start + 1, 0)
        hi, placed = int(c.max()), 0
        while hi > 0 and placed < C:
            act = (c > 0) & (c > hi - last) & (c <= hi)
            r = _ranks(torch.where(act, hi - c, last), block, last + 1)
            j = placed + r[act]
            keep = j < C
            ids[q, j[keep]] = keys[act][keep].to(torch.int32)
            cnt[q, j[keep]] = c[act][keep].to(torch.float32)
            placed += int(act.sum())
            rest = c[(c > 0) & (c <= hi - last)]
            hi = int(rest.max()) if rest.numel() else 0
    return ids.to(cands.device), cnt.to(cands.device)
