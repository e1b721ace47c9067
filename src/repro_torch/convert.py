"""Carry an index across between the JAX package and the port: its arrays,
as numpy, become the port's objects (and back), so the same index can be
served, and fitted further, by both packages. The model params trees
(LM, DIEN, DLRM, BST, xDeepFM, SchNet) cross the same way, with the AdamW
state of a train step over them, and so do the LM's KV caches.
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
    numpy leaves (``params``, ``opt``, ``assign``, ``round``, ``epoch``), as
    the reference's Trainer checkpoints and restores it: params, AdamW
    moments and step, assign and the round / epoch counters. The
    reference's JAX key cannot become a ``torch.Generator``: the port's
    random stream starts from ``seed`` instead (``FitState.as_dict()`` of
    the result is the port Trainer's state)."""
    dev = resolve_device(device)
    out = FitState.create(_params(state["params"], dev),
                          opt_state_from_reference(state["opt"], dev),
                          _tensor(np.asarray(state["assign"], np.int32),
                                  torch.int32, dev), seed)
    out.round_idx = int(np.asarray(state.get("round", 0)))
    out.epoch_idx = int(np.asarray(state.get("epoch", 0)))
    return out


def fit_state_to_reference(state: FitState) -> dict:
    """A port ``FitState`` as numpy in the reference FitState's
    ``as_dict()`` layout, without ``rng``: the generator state has no JAX
    key, so the caller supplies one (``jax.random.PRNGKey``)."""
    np32 = lambda t: t.detach().cpu().numpy()
    opt = state.opt_state
    return {"params": {k: np32(state.params[k]) for k in _PARAMS},
            "opt": {"step": np.asarray(int(opt["step"]), np.int32),
                    "m": {k: np32(opt["m"][k]) for k in _PARAMS},
                    "v": {k: np32(opt["v"][k]) for k in _PARAMS}},
            "assign": np32(state.assign).astype(np.int32),
            "round": np.asarray(state.round_idx, np.int32),
            "epoch": np.asarray(state.epoch_idx, np.int32)}


def to_reference(index: IRLIIndex) -> dict:
    """The port index's fit state as numpy, in the reference's layout:
    ``{"params": {..}, "opt": {"step", "m", "v"}, "assign"}`` — what the
    reference's IRLIIndex holds as ``params``, ``opt_state`` and
    ``assign``."""
    out = fit_state_to_reference(FitState(
        params=index.params, opt_state=index.opt_state, assign=index.assign,
        rng=index.rng, round_idx=0, epoch_idx=0))
    return {k: out[k] for k in ("params", "opt", "assign")}


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


def stream_state_from_reference(tree: dict, extra: dict, *,
                                device: str | torch.device = "cuda"):
    """A port ``StreamSnapshot`` from a reference MutableIRLIIndex's
    ``state_dict()`` (numpy leaves, e.g. through ``jax.device_get``, or a
    checkpoint's ``restore``) and its ``meta()``. bf16 codes come widened
    to fp32, as the reference's ``store_to_arrays`` writes them."""
    from repro_torch.stream.mutable_index import snapshot_from_arrays
    return snapshot_from_arrays(tree, extra, resolve_device(device))


def stream_state_to_reference(midx) -> tuple[dict, dict]:
    """A port MutableIRLIIndex's state as numpy, in the reference's layout
    -> (``state_dict()`` tree, ``meta()``): what the reference's
    ``MutableIRLIIndex.load_state`` takes."""
    s = midx.snapshot

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        return t.detach().cpu().numpy()

    return host(midx.state_dict(s)), midx.meta(s)


# ------------------------------------------------- model params (LM, DIEN) --
def _model_leaf(x, dev) -> torch.Tensor:
    """A reference leaf (numpy or array-like; bf16 through ml_dtypes) ->
    a tensor of the same dtype on dev (bf16 exactly, by way of fp32)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def _model_host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only a bf16 leaf needs numpy's bfloat16
        return t.detach().float().cpu().numpy().astype(ml_dtypes.bfloat16)
    return t.detach().cpu().numpy()


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _host_tree(params):
    """A module or nested dict of tensors -> the same nesting of numpy
    arrays (bf16 leaves as ``ml_dtypes.bfloat16``)."""
    if isinstance(params, torch.Tensor):
        return _model_host(params)
    return {k: _host_tree(v) for k, v in params.items()}


def _lm_tree(params: dict, cfg, dev) -> dict:
    """The reference's stacked LM tree -> the port's nesting, "layers" a
    list of per-layer dicts."""
    n_groups = cfg.n_layers // cfg.period
    layers = [
        _map_tree(lambda a, g=g: _model_leaf(np.asarray(a)[g], dev),
                  params["layers"][f"sub{i}"])
        for g in range(n_groups) for i in range(cfg.period)]
    tree = {k: _map_tree(lambda a: _model_leaf(a, dev), v)
            for k, v in params.items() if k != "layers"}
    return {**tree, "layers": layers}


def lm_tree_from_reference(params: dict, cfg, *,
                           device: str | torch.device = "cuda") -> dict:
    """The reference's LM params (or a tree of that shape: a gradient, an
    AdamW moment) -> the plain nested dict a port train step takes
    (``models.module.tensor_tree`` of the ``LM``: layer g·period + i of
    the port, keyed str(g·period + i), is slice g of ``sub{i}``)."""
    from repro_torch.models.module import tensor_tree
    return tensor_tree(_lm_tree(params, cfg, resolve_device(device)))


def lm_params_from_reference(params: dict, cfg, *,
                             device: str | torch.device = "cuda"):
    """The reference's LM params (``repro.models.transformer.lm_init``'s
    tree, numpy or array leaves) -> the port's ``LM`` on ``device``. The
    reference stacks each layer leaf on a leading [n_layers // period]
    axis under ``layers/sub{i}/...``; layer g·period + i of the port is
    slice g of ``sub{i}``. An MoE layer's ``moe`` subtree comes across the
    same way: its router, its experts' stacks [n_groups, E, d, f] as the
    layer's [E, d, f] and its ``shared`` expert."""
    from repro_torch.models.transformer import LM
    return LM(cfg, _lm_tree(params, cfg, resolve_device(device)))


def lm_params_to_reference(model, cfg=None) -> dict:
    """The port's ``LM`` (or its ``tensor_tree``, or a tree of that shape
    such as a gradient or an AdamW moment, with ``cfg``) -> the
    reference's params tree as numpy (bf16 leaves as
    ``ml_dtypes.bfloat16``), each layer leaf restacked on a leading
    [n_layers // period] axis under ``layers/sub{i}``."""
    from repro_torch.models.module import layer_list
    cfg = cfg if cfg is not None else model.cfg
    n_groups = cfg.n_layers // cfg.period

    per_layer = [_host_tree(lp) for lp in layer_list(model["layers"])]

    def stack(i, *path):
        leaves = [per_layer[g * cfg.period + i] for g in range(n_groups)]
        for k in path:
            leaves = [leaf[k] for leaf in leaves]
        return np.stack(leaves)

    def restack(i, sub, path=()):
        return {k: (restack(i, v, path + (k,)) if isinstance(v, dict)
                    else stack(i, *path, k)) for k, v in sub.items()}

    out = {k: _host_tree(m) for k, m in model.items() if k != "layers"}
    out["layers"] = {f"sub{i}": restack(i, per_layer[i])
                     for i in range(cfg.period)}
    return out


def dien_params_from_reference(params: dict, *,
                               device: str | torch.device = "cuda"):
    """The reference's DIEN params (``repro.models.recsys.dien_init``'s
    tree: ``item_emb``/``cate_emb`` tables, ``gru1`` and ``augru``
    ``wx``/``wh``, ``att`` and ``top`` ``fc*``; numpy or array leaves) ->
    the port's ``nn.ModuleDict`` of the same nesting on ``device``."""
    from repro_torch.models.module import as_module
    dev = resolve_device(device)
    return as_module(_map_tree(lambda a: _model_leaf(a, dev), params))


def dien_params_to_reference(params) -> dict:
    """The port's DIEN params (module or nested dict) -> the reference's
    tree as numpy (bf16 leaves as ``ml_dtypes.bfloat16``)."""
    return _host_tree(params)


def tree_from_reference(params: dict, *,
                        device: str | torch.device = "cuda") -> dict:
    """A reference params tree (nested dicts, numpy or array leaves) ->
    the same nesting of tensors of the same dtypes on ``device``."""
    dev = resolve_device(device)
    return _map_tree(lambda a: _model_leaf(a, dev), params)


def tree_to_reference(params) -> dict:
    """A port params tree (module or nested dict) -> the same nesting as
    numpy (bf16 leaves as ``ml_dtypes.bfloat16``)."""
    return _host_tree(params)


# DLRM, BST, xDeepFM and SchNet keep the reference's nesting as it is
dlrm_params_from_reference = bst_params_from_reference = tree_from_reference
xdeepfm_params_from_reference = tree_from_reference
schnet_params_from_reference = tree_from_reference
dlrm_params_to_reference = bst_params_to_reference = tree_to_reference
xdeepfm_params_to_reference = schnet_params_to_reference = tree_to_reference


def adamw_state_from_reference(state: dict, tree_from=tree_from_reference,
                               *, device: str | torch.device = "cuda"
                               ) -> dict:
    """The reference's AdamW state over a nested params tree ({"step", "m",
    "v"[, "master"]}) -> the port's: the step a host int32, the moments
    through ``tree_from`` (``tree_from_reference``, or for an LM
    ``lambda t, device: lm_tree_from_reference(t, cfg, device=device)``)."""
    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32)}
    for k in ("m", "v", "master"):
        if k in state:
            out[k] = tree_from(state[k], device=device)
    return out


def adamw_state_to_reference(state: dict, tree_to=tree_to_reference
                             ) -> dict:
    """The port's AdamW state -> the reference's layout as numpy, the
    moments through ``tree_to`` (``tree_to_reference``, or for an LM
    ``lambda t: lm_params_to_reference(t, cfg)``)."""
    out = {"step": np.asarray(int(state["step"]), np.int32)}
    for k in ("m", "v", "master"):
        if k in state:
            out[k] = tree_to(state[k])
    return out


# ------------------------------------------------------------- KV caches --
def caches_from_reference(caches, *, device: str | torch.device = "cuda"
                          ) -> list[dict]:
    """The reference's decode caches (``init_cache`` / ``lm_decode_step``'s
    list of per-layer {"k", "v"}, numpy or array leaves) -> the port's: a
    list of {"k", "v"} tensors of the same dtype on ``device``, each its
    own memory (the port's decode writes them in place)."""
    dev = resolve_device(device)
    return [{n: _model_leaf(c[n], dev).clone() for n in ("k", "v")}
            for c in caches]


def caches_to_reference(caches) -> list[dict]:
    """The port's caches -> the reference's layout as numpy (bf16 as
    ``ml_dtypes.bfloat16``)."""
    return [{n: _model_host(c[n]) for n in ("k", "v")} for c in caches]
