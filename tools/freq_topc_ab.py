#!/usr/bin/env python3
"""Time freq_topc against the bitonic kernel of an earlier checkout, on one
NVIDIA card, at the rows the two index paths hand it.

    python3 tools/freq_topc_ab.py OTHER_ROOT

OTHER_ROOT is the root of another checkout of this repository whose
``src/repro_torch/kernels/freq_topc/freq_topc.cu`` has the bitonic
kernel's C interface (``freq_topc_launch`` and ``freq_topc_wide_launch``
over rows padded to a power of two, with an int32 and, past 32,768, an
int64 scratch row). The script builds that source with this checkout's
nvcc flags, builds the serve cell's index and the stream cell's state as
chip_smoke.py does (its seeds and widths), takes the candidates that the
compact search ([1024, 32,000]) and the streaming search ([1024, 65,280])
hand freq_topc, holds both kernels to the plain version on them, and times
them in turns (other, this, this, other; CUDA-event medians). Its last line
is one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def other_kernel(root: Path, torch):
    """The other checkout's freq_topc, built into build/ab/, as a function
    cands [Q, C0] int32 -> (ids, counts)."""
    from repro_torch.kernels import _build
    src = root / "src/repro_torch/kernels/freq_topc/freq_topc.cu"
    out = ROOT / "build" / "ab" / "libfreq_topc_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    head = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    tail = [ctypes.c_void_p] * 3
    lib.freq_topc_launch.argtypes = head + tail
    lib.freq_topc_wide_launch.argtypes = head + [ctypes.c_void_p] + tail

    def run(cands, C):
        Q, C0 = cands.shape
        n = 32
        while n < C0:
            n *= 2
        dev = cands.device
        ids = torch.empty((Q, C), dtype=torch.int32, device=dev)
        cnt = torch.empty((Q, C), dtype=torch.float32, device=dev)
        srt = torch.empty((Q, n), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n <= 32768:
            err = lib.freq_topc_launch(cands.data_ptr(), Q, C0, n, C,
                                       srt.data_ptr(), ids.data_ptr(),
                                       cnt.data_ptr(), stream)
        else:
            keys = torch.empty((Q, n), dtype=torch.int64, device=dev)
            err = lib.freq_topc_wide_launch(
                cands.data_ptr(), Q, C0, n, C, srt.data_ptr(),
                keys.data_ptr(), ids.data_ptr(), cnt.data_ptr(), stream)
        if err:
            raise RuntimeError(f"the other freq_topc: cudaError {err}")
        return ids, cnt

    return run


def main() -> int:
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__.split("\n\n")[1])
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import scorer_hidden
    from repro_torch.core.query import gather_members
    from repro_torch.core.search_api import SearchParams
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    from repro_torch.kernels.irli_topk import ops as iops
    from repro_torch.stream import MutableIRLIIndex

    other = other_kernel(Path(sys.argv[1]).resolve(), torch)
    dev = torch.device("cuda", 0)
    # the serve cell's index and queries (chip_smoke.main)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    corpus = torch.randn((cs.L, cs.D), generator=gen, device=dev)
    corpus /= corpus.norm(dim=1, keepdim=True)
    src = torch.randint(0, cs.L, (cs.Q,), generator=gen, device=dev)
    queries = corpus[src] + 0.05 * torch.randn((cs.Q, cs.D), generator=gen,
                                               device=dev)
    queries /= queries.norm(dim=1, keepdim=True)
    idx = IRLIIndex(IRLIConfig(d=cs.D, n_labels=cs.L, n_buckets=cs.B,
                               n_reps=cs.R, d_hidden=cs.H, seed=cs.SEED),
                    device=dev)
    idx.build_index()
    p = idx.params
    bidx = iops.irli_topk(scorer_hidden(p, queries), p["w2"], p["b2"],
                          m=cs.M)[1]
    rows = {"search": gather_members(idx.index.members, bidx)}
    # the stream cell's state (chip_smoke.stream_cell's path)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    new = torch.randn((cs.N_INSERT, cs.D), generator=gen, device=dev)
    new /= new.norm(dim=1, keepdim=True)
    dead = torch.cat([
        torch.randperm(cs.L, generator=gen, device=dev)[:cs.N_DEL_BASE],
        cs.L + torch.randperm(cs.N_INSERT, generator=gen,
                              device=dev)[:cs.N_DEL_NEW]])
    midx = MutableIRLIIndex(idx, corpus, store_dtype="int8")
    for s in range(0, cs.N_INSERT, cs.INSERT_BATCH):
        midx.insert(new[s:s + cs.INSERT_BATCH])
    midx.delete(dead)
    launch = fops.freq_topc

    def capture(cands, *, C):
        rows["stream"] = cands
        return launch(cands, C=C)

    fops.freq_topc = capture
    try:
        midx.search(queries, SearchParams(m=cs.M, tau=cs.TAU, k=cs.K,
                                          store_dtype="int8"))
    finally:
        fops.freq_topc = launch
    out = {}
    for name, cands in rows.items():
        ref = freq_topc_ref(cands, C=cs.TOPC)
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            fn = ((lambda: other(cands, cs.TOPC)) if who == "other"
                  else (lambda: fops.freq_topc(cands, C=cs.TOPC)))
            got = fn()
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise AssertionError(f"{who} differs from the plain version "
                                     f"at the {name} rows")
            times[who].append(cs.time_ms(torch, fn, n=10, warmup=2))
        out[name] = {"shape": list(cands.shape), **times}
        print(f"{name} rows {tuple(cands.shape)}: other {times['other']} "
              f"ms, this {times['this']} ms", flush=True)
    print(json.dumps({"freq_topc_ab": out,
                      "card": cs.nvidia_smi("name,power.limit")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
