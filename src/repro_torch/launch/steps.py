"""Step builders of the LM and recsys families.

Port of ``repro/launch/steps.build_lm_prefill`` (``:137-148``): the
forward over a prompt batch, returning the last position's fp32 logits and
hidden state, plus the reply to each request, ``next_token`` (the greedy
argmax the reference's decode step takes, ``:155-161``); and of
``build_ctr_serve`` (``:179-182``): a CTR model's click probability; and of
``build_irli_serve`` (``:300-331``): the sharded-corpus IRLI query over
``core/distributed.make_production_search``. Each step runs on the model's
device, under ``torch.inference_mode``. The train, decode and other
families' steps wait (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.models.module import device_of


def next_token(logits):
    """Greedy next token of fp32 logits [B, V] -> int32 [B]; a tie goes to
    the smaller id (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_lm_prefill(cfg):
    """step(model, batch) -> {"logits" [B, V] fp32, "hidden" [B, d],
    "next_token" [B] int32} for batch["tokens"] [B, S] (cache emission
    elided, as in the reference)."""
    from repro_torch.models.transformer import _logits, lm_backbone

    def step(model, batch):
        with torch.inference_mode():
            tokens = torch.as_tensor(batch["tokens"], device=model.device)
            h, _ = lm_backbone(model, cfg, tokens)
            last = h[:, -1, :]
            logits = _logits(model, cfg, last)
            return {"logits": logits, "hidden": last,
                    "next_token": next_token(logits)}

    return step


def build_ctr_serve(apply_fn):
    """step(params, batch) -> {"prob": sigmoid(apply_fn(params, batch))}
    [B]; the batch's arrays (numpy or tensors) are moved to the params'
    device first."""

    def step(params, batch):
        with torch.inference_mode():
            dev = device_of(params)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            return {"prob": torch.sigmoid(apply_fn(params, batch))}

    return step


def build_irli_serve(mesh, m: int, tau: int, k: int, loss_kind="softmax_bce",
                     metric="angular", store_dtype: str = "fp32",
                     store_block: int = 32, refine_k: int = 0):
    """The production sharded-corpus IRLI query (paper §5.3): every rank is
    one paper "node" owning L/P vectors and its R-rep inverted index; one
    all-gather merge. step(params, batch) -> {"ids", "scores"} [Q, k] with
    global ids, the same on every rank.

    ``params`` holds this rank's shard: ``scorer`` (replicated), ``members``
    [R, B, ML], and ``base`` [L_loc, D] fp32, or with ``store_dtype="int8"``
    ``base_codes`` [L_loc, D] int8 + ``base_scales`` [L_loc, D/block] fp32
    (bf16: ``base_codes`` alone). ``batch["queries"]`` [Q, D] is
    replicated."""
    del loss_kind                   # serving is loss-agnostic
    from repro_torch.core.distributed import make_production_search
    from repro_torch.core.search_api import SearchParams
    from repro_torch.store.quantized import QuantizedStore

    search = make_production_search(
        mesh, SearchParams(m=m, tau=tau, k=k, metric=metric,
                           store_dtype=store_dtype, refine_k=refine_k))

    def step(params, batch):
        with torch.inference_mode():
            if store_dtype == "fp32":
                base = params["base"]
            else:
                base = QuantizedStore(
                    store_dtype, store_block, params["base_codes"],
                    params["base_scales"] if store_dtype == "int8" else None)
            res = search(params["scorer"], params["members"], base,
                         batch["queries"])
            return {"ids": res.ids, "scores": res.scores}

    return step
