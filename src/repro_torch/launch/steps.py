"""Step builders shared by the model families.

Port of ``repro/launch/steps.py``. A train step is
``step(state, batch) -> (state, metrics)`` with ``state = {"params",
"opt"}``, one eager ``torch.autograd`` forward and backward and the
optimizer's update in place (the reference jits it with the state
donated); a serve step is ``step(params, batch) -> outputs`` under
``torch.inference_mode``, on the params' device.

  * ``make_opt`` and ``build_train_step`` (``:54-76``), and the IRLI scorer's
    step ``build_irli_train_step`` (``:234``);
  * ``build_irli_fit_parts`` (``:249``): the fit engine's round as the
    fault-tolerant Trainer's step, on one device or on a (data × rep) mesh;
  * ``build_lm_prefill`` (``:137-148``): the forward over a prompt batch,
    returning the last position's fp32 logits and hidden state, plus
    ``next_token`` (the greedy argmax of the reference's decode step,
    ``:155-161``);
  * ``build_lm_decode`` (``:151-162``): one token against the KV caches,
    greedy next token;
  * ``build_ctr_serve`` (``:179-182``): a CTR model's click probability;
  * ``build_retrieval_serve`` (``:185``): the brute-force two-tower
    candidate scoring that IRLI accelerates, ``distance_topk`` on the card;
  * ``build_irli_serve`` (``:300-331``): the sharded-corpus IRLI query over
    ``core/distributed.make_production_search``.

The LM, GNN and CTR train steps and ``opt_state_specs`` wait (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.models.module import (device_of, flatten_with_paths,
                                       map_with_paths)
from repro_torch.optim.optimizers import make_optimizer


# ------------------------------------------------------------ generic step --
def make_opt(opt_kind: str, **kw):
    """``adamw``, ``adafactor``, or ``adamw_nomaster`` (AdamW without the
    fp32 master copy)."""
    if opt_kind == "adamw_nomaster":
        return make_optimizer("adamw", master_fp32=False, **kw)
    return make_optimizer(opt_kind, **kw)


def build_train_step(loss_fn, opt_kind: str, **opt_kw):
    """loss_fn(params, batch) -> (scalar, metrics dict) -> (step, opt):
    step(state, batch) -> (state, metrics) runs the forward and backward by
    autograd, then ``opt.update`` in place; metrics gain ``loss`` and the
    optimizer's own (``grad_norm``, ``lr``)."""
    opt = make_opt(opt_kind, **opt_kw)

    def step(state, batch):
        params, opt_state = state["params"], state["opt"]
        leaves = flatten_with_paths(params)
        with torch.enable_grad():
            for _, p in leaves:
                p.requires_grad_(True)
            try:
                loss, metrics = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, [p for _, p in leaves])
            finally:
                for _, p in leaves:
                    p.requires_grad_(False)
        by_path = {path: g for (path, _), g in zip(leaves, grads)}
        grads = map_with_paths(lambda path, _: by_path[path], params)
        params, opt_state, info = opt.update(params, grads, opt_state)
        metrics = dict(metrics, loss=loss.detach(), **info)
        return {"params": params, "opt": opt_state}, metrics

    return step, opt


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


def build_lm_decode(cfg, context_len: int):
    """step(model, batch) -> {"next_token" [B] int32, "caches", "logits"
    [B, V] fp32, "hidden" [B, d]} for batch["token"] [B], batch["pos"] [B]
    and batch["caches"] (``models.transformer.init_cache(cfg, B,
    context_len)``), which the step writes in place and returns. The
    logits and the final hidden state (the vocabulary head's input) come
    with the reference's two outputs. The caches carry their length, as
    in the reference, whose step does not read ``context_len`` either."""
    from repro_torch.models.transformer import _logits, decode_hidden
    del context_len

    def step(model, batch):
        with torch.inference_mode():
            dev = model.device
            token = torch.as_tensor(batch["token"], device=dev)
            pos = torch.as_tensor(batch["pos"], device=dev)
            caches = batch["caches"]
            h = decode_hidden(model, cfg, token, caches, pos)
            logits = _logits(model, cfg, h)
            return {"next_token": next_token(logits), "caches": caches,
                    "logits": logits, "hidden": h}

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


def build_retrieval_serve(k: int = 100):
    """Two-tower candidate scoring, the brute-force baseline the IRLI index
    accelerates (paper §5.3): step(params, batch) -> {"ids" [Bq, k] int32,
    "scores" [Bq, k] f32}, the top-k of batch["query"] [Bq, d] · params[
    "item_table"]["table"] [N, d]ᵀ, ties toward the smaller id as
    ``jax.lax.top_k`` breaks them. One ``distance_topk`` launch ("dot") on
    the card, which holds no [Bq, N] table; its plain version on the CPU."""
    from repro_torch.kernels import on_card
    from repro_torch.kernels.distance_topk.ops import distance_topk
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref

    def step(params, batch):
        with torch.inference_mode():
            table = params["item_table"]["table"].to(torch.float32)
            query = torch.as_tensor(batch["query"]).to(table.device,
                                                        torch.float32)
            every = torch.ones((1, table.shape[0]), dtype=torch.bool,
                               device=table.device)
            topk = distance_topk if on_card(query, table) \
                else distance_topk_ref
            vals, ids = topk(query, table, every, k=k, metric="dot")
            return {"ids": ids, "scores": vals}

    return step


# ----------------------------------------------------------------- IRLI -----
def build_irli_train_step(scorer_cfg, n_buckets: int,
                          opt_kind="adamw_nomaster", **opt_kw):
    """The IRLI scorer's train step (the paper's §5.3 system) on a batch
    {"x" [N, d], "label_ids" [N, k], "label_mask" [N, k], "assign" [R, L]}
    (numpy or tensors, moved to the params' device) -> (step, opt)."""
    from repro_torch.core.network import scorer_loss
    from repro_torch.core.partition import bucket_targets

    def loss_fn(params, batch):
        dev = device_of(params)
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        targets = bucket_targets(b["assign"], b["label_ids"],
                                 b["label_mask"], n_buckets)
        loss = scorer_loss(params, scorer_cfg, b["x"].float(), targets)
        return loss, {"bce": loss.detach()}

    return build_train_step(loss_fn, opt_kind, **opt_kw)


class FitParts(tuple):
    """``(step_fn, init_state, batch_fn)`` for ``Trainer(TrainerConfig(
    total_steps=<rounds>), *parts, ckpt_dir, sharded=parts.sharded)``;
    ``sharded`` holds a mesh fit's checkpoint hooks (None on one
    device)."""
    sharded = None


def build_irli_fit_parts(cfg, x, label_ids, label_mask=None, label_vecs=None,
                         *, mesh=None, data_seed: int = 0,
                         device: str | torch.device = "cuda") -> FitParts:
    """The IRLI fit engine as the fault-tolerant Trainer's parts: one
    Trainer step is ONE train / re-partition round, so a fit inherits
    auto-resume from atomic checkpoints, periodic and final checkpoints
    and straggler accounting.

    States are ``FitState`` dicts (checkpoint-flattenable), updated in
    place; ``init_state`` gives the state ``IRLIIndex(cfg, device)`` starts
    from (its params, AdamW state, hash partition and generator), and
    ``batch_fn`` is a pure function of the round index, so a restored run
    replays the exact batch sequence (bit-identical assign and losses).

    ``mesh``: a (data × rep) DeviceMesh (``launch/mesh.make_fit_mesh``)
    runs the sharded engine, every rank with its rep rows; ``sharded``
    then gathers the whole state for each checkpoint (rank 0 writes it)
    and gives each rank its rows of a restored one, so a fit checkpointed
    on one mesh shape resumes on another."""
    from repro_torch.core.network import ScorerConfig, scorer_init
    from repro_torch.core.partition import hash_init
    from repro_torch.fit.engine import FitData, FitEngine
    from repro_torch.fit.state import FitState
    from repro_torch.kernels import resolve_device

    dev = resolve_device(device)
    scorer_cfg = ScorerConfig(d_in=cfg.d, d_hidden=cfg.d_hidden,
                              n_buckets=cfg.n_buckets, n_reps=cfg.n_reps,
                              loss=cfg.loss)
    data = FitData.build(x, label_ids, label_mask, label_vecs,
                         n_labels=cfg.n_labels, chunk=cfg.affinity_chunk,
                         device=dev)
    engine = FitEngine(cfg, scorer_cfg)
    n = data.x.shape[0]

    def whole_state() -> FitState:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = scorer_init(scorer_cfg, gen)
        assign = hash_init(cfg.n_labels, cfg.n_buckets, cfg.n_reps,
                           cfg.seed, device=dev)
        return FitState.create(params, engine.opt.init(params), assign,
                               cfg.seed)

    def batch_fn(step):
        idx, w = engine.round_batches(n, data_seed, step)
        return {"idx": idx, "w": w}

    if mesh is None:
        return FitParts((engine.step_fn(data),
                         lambda: whole_state().as_dict(), batch_fn))

    import torch.distributed as dist

    from repro_torch.train.trainer import ShardedCheckpoint
    ax = engine.mesh_axes(mesh)
    rows = FitState(params={}, opt_state={}, assign=torch.empty(
        (ax.R_loc, cfg.n_labels), dtype=torch.int32, device="meta"),
        rng=None, round_idx=0, epoch_idx=0)

    def shard(sd):
        return engine.shard_state(FitState.from_dict(sd), mesh).as_dict()

    parts = FitParts((engine.sharded_step_fn(mesh, data, rows),
                      lambda: shard(whole_state().as_dict()), batch_fn))
    parts.sharded = ShardedCheckpoint(
        gather=lambda sd: engine.gather_state(FitState.from_dict(sd),
                                              mesh).as_dict(),
        shard=shard, writer=dist.get_rank() == 0, barrier=dist.barrier)
    return parts
