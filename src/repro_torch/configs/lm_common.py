"""Shared machinery of the 5 LM-family architectures. Port of
``repro/configs/lm_common.py``.

Shapes (assigned):
  train_4k     seq 4096  global_batch 256   (train_step)
  prefill_32k  seq 32768 global_batch 32    (serve: prompt forward)
  decode_32k   ctx 32768 global_batch 128   (serve: 1 token + KV cache)
  long_500k    ctx 524288 global_batch 1    (serve: decode, sub-quadratic
               only)

Sharding: batch over ("pod", "data"); heads / ff / vocab over "model"; MoE
experts over "model" when E >= 16, else tensor-parallel over ff. KV caches:
kv-head dim over "model" when divisible, else the sequence dim.

The port's layers are unstacked (``layers/0/attn/q_proj/kernel``, where
the reference scans ``layers/sub0/attn/q_proj/kernel`` with a leading
group axis), so each layer rule here is the reference's spec without its
leading layer entry: ``P(None, None, "model")`` is ``(None, "model")``.
``abstract_params`` is the port's ``lm_init`` under ``FakeTensorMode``:
shapes and dtypes, no memory, even for llama4's 400B.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef, CellDef, abstract, dp, sds
from repro_torch.launch import steps as S
from repro_torch.models.module import ShardRules
from repro_torch.models.transformer import LMConfig, cache_specs, lm_init

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="serve"),
    "decode_32k": dict(seq=32768, batch=128, kind="serve"),
    "long_500k": dict(seq=524288, batch=1, kind="serve"),
}


def lm_rules(cfg: LMConfig, fsdp: bool = False) -> ShardRules:
    """Path-regex -> spec for the port's LM param tree (one entry a
    layer); the first match wins, in the reference's order. ``fsdp`` is
    accepted and unused, as in the reference."""
    del fsdp
    if cfg.moe is not None and cfg.moe.n_experts >= 16:
        # 2-D expert x tensor parallelism: experts over "model", d_ff over
        # "data"; the contractions stay weight-local
        expert_specs = [
            (r"moe/experts/(gate|up)", ("model", None, "data")),
            (r"moe/experts/down", ("model", "data", None)),
        ]
    else:
        expert_specs = [  # tensor parallel over ff inside each expert
            (r"moe/experts/(gate|up)", (None, None, "model")),
            (r"moe/experts/down", (None, "model", None)),
        ]
    rules = [
        (r"embed/table", ("model", None)),
        (r"lm_head/kernel", (None, "model")),
        (r"attn/(q|k|v)_proj/kernel", (None, "model")),
        (r"attn/o_proj/kernel", ("model", None)),
        (r"(mlp|moe/shared)/(gate|up)/kernel", (None, "model")),
        (r"(mlp|moe/shared)/down/kernel", ("model", None)),
        (r"moe/router/kernel", (None, None)),
        *expert_specs,
        (r"(scale|bias)$", ()),
    ]
    return ShardRules(rules, strict=False)


def _cache_sharding(cfg: LMConfig, mesh, model_size: int = 16):
    """Per-layer cache specs: kv-heads over "model" if divisible, else the
    sequence dim over "model"."""
    specs = []
    for _ in range(cfg.n_layers):
        if cfg.n_kv_heads % model_size == 0:
            spec = (dp(mesh), None, "model", None)
        else:
            spec = (dp(mesh), "model", None, None)
        specs.append({"k": spec, "v": spec})
    return specs


def _long_cache_sharding(cfg: LMConfig, mesh):
    """batch=1: the sequence dim over the whole (data, model) grid."""
    spec = (None, ("data", "model"), None, None)
    return [{"k": spec, "v": spec} for _ in range(cfg.n_layers)]


def _meta_caches(cfg: LMConfig, batch: int, context: int) -> list[dict]:
    return [{n: sds(shape, dt) for n, (shape, dt) in spec.items()}
            for spec in cache_specs(cfg, batch, context)]


def make_lm_arch(cfg: LMConfig, *, opt: str, opt_kw=None, fsdp: bool = False,
                 long_ctx_ok: bool = False, long_skip_reason: str = "",
                 micro_split: str = "strided", notes: str = "") -> ArchDef:
    opt_kw = opt_kw or {}

    def rules():
        return lm_rules(cfg, fsdp)

    cells: dict[str, CellDef] = {}

    # ---- train_4k --------------------------------------------------------
    sh = SHAPES["train_4k"]

    def train_inputs(mesh):
        return {"tokens": sds((sh["batch"], sh["seq"]), torch.int32),
                "labels": sds((sh["batch"], sh["seq"]), torch.int32)}

    def train_specs(mesh):
        return {"tokens": (dp(mesh), None), "labels": (dp(mesh), None)}

    cells["train_4k"] = CellDef(
        kind="train", inputs=train_inputs, in_specs=train_specs,
        step=lambda mesh: S.build_lm_train_step(cfg, opt, mesh=mesh,
                                                micro_split=micro_split,
                                                **opt_kw)[0],
        step_with_mesh=True)

    # ---- prefill_32k -----------------------------------------------------
    shp = SHAPES["prefill_32k"]

    def prefill_inputs(mesh):
        return {"tokens": sds((shp["batch"], shp["seq"]), torch.int32)}

    cells["prefill_32k"] = CellDef(
        kind="serve",
        inputs=prefill_inputs,
        in_specs=lambda mesh: {"tokens": (dp(mesh), None)},
        step=lambda: S.build_lm_prefill(cfg))

    # ---- decode_32k ------------------------------------------------------
    shd = SHAPES["decode_32k"]

    def decode_inputs(mesh):
        return {"token": sds((shd["batch"],), torch.int32),
                "pos": sds((shd["batch"],), torch.int32),
                "caches": _meta_caches(cfg, shd["batch"], shd["seq"])}

    def decode_specs(mesh):
        return {"token": (dp(mesh),), "pos": (dp(mesh),),
                "caches": _cache_sharding(cfg, mesh)}

    cells["decode_32k"] = CellDef(
        kind="serve", inputs=decode_inputs, in_specs=decode_specs,
        step=lambda: S.build_lm_decode(cfg, shd["seq"]))

    # ---- long_500k -------------------------------------------------------
    shl = SHAPES["long_500k"]
    if long_ctx_ok:
        def long_inputs(mesh):
            return {"token": sds((shl["batch"],), torch.int32),
                    "pos": sds((shl["batch"],), torch.int32),
                    "caches": _meta_caches(cfg, shl["batch"], shl["seq"])}

        def long_specs(mesh):
            return {"token": (), "pos": (),
                    "caches": _long_cache_sharding(cfg, mesh)}

        cells["long_500k"] = CellDef(
            kind="serve", inputs=long_inputs, in_specs=long_specs,
            step=lambda: S.build_lm_decode(cfg, shl["seq"]))
    else:
        cells["long_500k"] = CellDef(kind="serve", skip=long_skip_reason)

    return ArchDef(
        name=cfg.name, family="lm",
        abstract_params=lambda: abstract(lm_init, cfg, seed=0,
                                         device="cpu"),
        rules=rules, cells=cells, opt=opt, opt_kw=opt_kw,
        model_flops_per_token=6 * cfg.n_active_params, notes=notes)
