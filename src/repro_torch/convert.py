"""Carry an index across from the JAX package: its arrays, as numpy, become
the port's objects, so the same index can be served by both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import partition as PT
from repro_torch.core.index import IRLIConfig, IRLIIndex
from repro_torch.kernels import resolve_device
from repro_torch.store.quantized import QuantizedStore, check_scales


def _tensor(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def from_reference(cfg, *, params: dict, assign, members=None,
                   store: dict | None = None,
                   device: str | torch.device = "cuda"):
    """Build the port's index (and store) from the reference's arrays.

    cfg: the reference's IRLIConfig (or any object with its fields);
    params: ``{"w1", "b1", "w2", "b2"}`` as numpy; assign [R, L] and,
    optionally, the member matrix [R, B, max_load] (else rebuilt, bit for
    bit, from ``assign``); store: ``{"dtype", "block", "codes", "scales",
    "exact"}`` with numpy leaves (bf16 codes may come widened to fp32, which
    is exact). Returns (IRLIIndex, QuantizedStore or None)."""
    dev = resolve_device(device)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(
        IRLIConfig) if hasattr(cfg, f.name)}
    idx = IRLIIndex(IRLIConfig(**fields), device=dev)
    idx.params = {k: _tensor(np.asarray(params[k], np.float32),
                             torch.float32, dev)
                  for k in ("w1", "b1", "w2", "b2")}
    idx.assign = _tensor(np.asarray(assign, np.int32), torch.int32, dev)
    if members is None:
        idx.build_index()
    else:
        mem = _tensor(np.asarray(members, np.int32), torch.int32, dev)
        idx.index = PT.InvertedIndex(
            members=mem, load=PT.loads(idx.assign, idx.cfg.n_buckets),
            max_load=int(mem.shape[-1]))
    return idx, (None if store is None else _store(store, dev))


def _store(arrays: dict, dev: torch.device) -> QuantizedStore:
    dtype = arrays["dtype"]
    code_dtype = {"fp32": torch.float32, "int8": torch.int8,
                  "bf16": torch.bfloat16}[dtype]
    codes = np.asarray(arrays["codes"])
    codes = _tensor(codes if dtype == "int8" else codes.astype(np.float32),
                    torch.float32 if dtype != "int8" else torch.int8,
                    dev).to(code_dtype)
    scales = arrays.get("scales")
    exact = arrays.get("exact")
    store = QuantizedStore(
        dtype, int(arrays["block"]), codes,
        None if scales is None else _tensor(np.asarray(scales, np.float32),
                                            torch.float32, dev),
        None if exact is None else _tensor(np.asarray(exact, np.float32),
                                           torch.float32, dev))
    check_scales(store)
    return store
