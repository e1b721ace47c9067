"""Carry an index across between the JAX package and the port: its arrays,
as numpy, become the port's objects (and back), so the same index can be
served, and fitted further, by both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import partition as PT
from repro_torch.core.index import IRLIConfig, IRLIIndex
from repro_torch.fit.state import FitState
from repro_torch.kernels import resolve_device
from repro_torch.store.quantized import QuantizedStore, check_scales


def _tensor(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


_PARAMS = ("w1", "b1", "w2", "b2")


def _params(params: dict, dev) -> dict:
    return {k: _tensor(np.asarray(params[k], np.float32), torch.float32, dev)
            for k in _PARAMS}


def opt_state_from_reference(opt_state: dict,
                             device: str | torch.device = "cuda") -> dict:
    """The reference's AdamW state ``{"step", "m": {..}, "v": {..}}``
    (numpy leaves) -> the port's (moments on ``device``, step on the
    host)."""
    dev = resolve_device(device)
    return {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32),
            "m": _params(opt_state["m"], dev),
            "v": _params(opt_state["v"], dev)}


def fit_state_from_reference(state: dict, *, seed: int = 0,
                             device: str | torch.device = "cuda"
                             ) -> FitState:
    """A port ``FitState`` from a reference FitState's ``as_dict()`` with
    numpy leaves (``params``, ``opt``, ``assign``, ``round``, ``epoch``).
    The reference's JAX key cannot become a ``torch.Generator``: the port's
    random stream starts from ``seed`` instead."""
    dev = resolve_device(device)
    out = FitState.create(_params(state["params"], dev),
                          opt_state_from_reference(state["opt"], dev),
                          _tensor(np.asarray(state["assign"], np.int32),
                                  torch.int32, dev), seed)
    out.round_idx = int(np.asarray(state.get("round", 0)))
    out.epoch_idx = int(np.asarray(state.get("epoch", 0)))
    return out


def to_reference(index: IRLIIndex) -> dict:
    """The port index's fit state as numpy, in the reference's layout:
    ``{"params": {..}, "opt": {"step", "m", "v"}, "assign"}`` — what the
    reference's IRLIIndex holds as ``params``, ``opt_state`` and
    ``assign``."""
    np32 = lambda t: t.detach().cpu().numpy()
    opt = index.opt_state
    return {"params": {k: np32(index.params[k]) for k in _PARAMS},
            "opt": {"step": np.asarray(int(opt["step"]), np.int32),
                    "m": {k: np32(opt["m"][k]) for k in _PARAMS},
                    "v": {k: np32(opt["v"][k]) for k in _PARAMS}},
            "assign": np32(index.assign).astype(np.int32)}


def from_reference(cfg, *, params: dict, assign, members=None,
                   store: dict | None = None, opt_state: dict | None = None,
                   device: str | torch.device = "cuda"):
    """Build the port's index (and store) from the reference's arrays.

    cfg: the reference's IRLIConfig (or any object with its fields);
    params: ``{"w1", "b1", "w2", "b2"}`` as numpy; assign [R, L] and,
    optionally, the member matrix [R, B, max_load] (else rebuilt, bit for
    bit, from ``assign``); store: ``{"dtype", "block", "codes", "scales",
    "exact"}`` with numpy leaves (bf16 codes may come widened to fp32, which
    is exact); opt_state: the reference's AdamW state ``{"step", "m",
    "v"}``, so the port can fit on from where the reference stopped.
    Returns (IRLIIndex, QuantizedStore or None)."""
    dev = resolve_device(device)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(
        IRLIConfig) if hasattr(cfg, f.name)}
    idx = IRLIIndex(IRLIConfig(**fields), device=dev)
    idx.params = _params(params, dev)
    if opt_state is None:
        idx.opt_state = idx.opt.init(idx.params)
    else:
        idx.opt_state = opt_state_from_reference(opt_state, dev)
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
