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
    ``core/distributed.make_production_search``;
  * ``opt_state_specs`` (``:25-48``): the optimizer state's specs, ZeRO
    style (``configs/base.zero_state_spec``) for AdamW, the factored
    moments' for Adafactor; ``place_train_state`` places a whole state on
    a mesh by them;
  * ``build_lm_train_step`` (``:80-134``): microbatched gradient
    accumulation in fp32 over ``models.transformer.lm_loss``, both of the
    reference's microbatch groupings, one optimizer update; on a mesh
    (``mesh=``) the same body on DTensors;
  * ``build_ctr_train_step`` (``:166-176``): the mean stable BCE of a CTR
    model's logits;
  * ``build_gnn_node_train`` (``:198``) and ``build_gnn_energy_train``
    (``:218``): SchNet's node classification and molecule energy
    regression.

Every train step's params are a plain nested dict of tensors
(``models.module.tensor_tree`` of a model module). Under a gradient no
kernel without a backward is launched (``models/attention.uses_kernel``,
``models/recsys.dien_apply``): the port's kernels stay on the serve
paths, but for the MoE's ``kchoice`` router, whose output is integer
assignments.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.module import (data_axes, device_of,
                                       flatten_with_paths, is_dtensor,
                                       is_row_sharded, local_block,
                                       map_with_paths, mesh_sizes,
                                       on_batch_rows, place, place_tree,
                                       rows_dtensor, sum_over_rows,
                                       unshard_dim)
from repro_torch.optim.optimizers import make_optimizer


# ---------------------------------------------------------------- states ----
def opt_state_specs(opt_kind: str, params_sds, param_specs, mesh):
    """The optimizer state's spec tree for params ``params_sds`` (anything
    with ``shape``: meta, fake or real tensors) under ``param_specs`` on
    ``mesh`` (a DeviceMesh or {axis: size}): AdamW's moments and master
    copy mirror the params' specs plus the "data" axis on the first
    divisible unsharded dimension (``zero_state_spec``), Adafactor's
    factored moments drop the last (rows) or the second-to-last (columns)
    dimension of the param's spec. The step counter is replicated
    (``()``)."""
    from repro_torch.configs.base import zero_state_spec
    dsize = mesh_sizes(mesh).get("data", 1)

    def zero():
        return map_with_paths(
            lambda path, s: zero_state_spec(_spec_at(param_specs, path),
                                            tuple(s.shape), "data", dsize),
            params_sds)

    if opt_kind == "adamw":
        z = zero()
        return {"step": (), "m": z, "v": z, "master": z}
    if opt_kind == "adamw_nomaster":
        z = zero()
        return {"step": (), "m": z, "v": z}
    if opt_kind == "adafactor":
        def leaf(path, s):
            sp = _spec_at(param_specs, path)
            spec = list(sp) + [None] * (len(s.shape) - len(sp))
            if len(s.shape) >= 2 and min(s.shape[-2:]) >= 128:
                return {"vr": tuple(spec[:-1]),
                        "vc": tuple(spec[:-2]) + (spec[-1],)}
            return {"v": tuple(spec)}
        return {"step": (), "v": map_with_paths(leaf, params_sds)}
    raise ValueError(opt_kind)


def _spec_at(specs, path: str):
    for k in path.split("/"):
        specs = specs[k]
    return specs


def place_train_state(state: dict, param_specs, opt_specs, mesh) -> dict:
    """A whole train state {"params", "opt"} (the same tensors on every
    rank) -> this rank's DTensors on ``mesh``: the params under
    ``param_specs`` (an arch's ``rules().specs(params)``), the optimizer
    state under ``opt_specs`` (``opt_state_specs``). The step counter
    stays a host tensor: the optimizer reads it on the host. On a
    one-rank mesh every DTensor holds its whole tensor's storage."""
    return {"params": place_tree(state["params"], param_specs, mesh),
            "opt": place_tree(state["opt"], dict(opt_specs, step=None),
                              mesh)}


# ------------------------------------------------------------ generic step --
def make_opt(opt_kind: str, **kw):
    """``adamw``, ``adafactor``, or ``adamw_nomaster`` (AdamW without the
    fp32 master copy)."""
    if opt_kind == "adamw_nomaster":
        return make_optimizer("adamw", master_fp32=False, **kw)
    return make_optimizer(opt_kind, **kw)


def grads_of(loss_fn, params, *args):
    """loss_fn(params, *args) -> (scalar, metrics); returns (loss, metrics,
    grads in params' nesting). The leaves require grad only inside the
    call; a leaf the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives it."""
    leaves = flatten_with_paths(params)
    tensors = [p for _, p in leaves]
    with torch.enable_grad():
        for p in tensors:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, *args)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in tensors:
                p.requires_grad_(False)
    by_path = {path: g for (path, _), g in zip(leaves, grads)}
    return loss.detach(), metrics, map_with_paths(
        lambda path, _: by_path[path], params)


def build_train_step(loss_fn, opt_kind: str, **opt_kw):
    """loss_fn(params, batch) -> (scalar, metrics dict) -> (step, opt):
    step(state, batch) -> (state, metrics) runs the forward and backward by
    autograd, then ``opt.update`` in place; metrics gain ``loss`` and the
    optimizer's own (``grad_norm``, ``lr``). On DTensor params each
    gradient is first redistributed to its param's placements and the
    metrics come back as plain tensors."""
    opt = make_opt(opt_kind, **opt_kw)

    def step(state, batch):
        params, opt_state = state["params"], state["opt"]
        loss, metrics, grads = grads_of(loss_fn, params, batch)
        if is_dtensor(flatten_with_paths(params)[0][1]):
            # on a mesh: each gradient reduced to its param's placements,
            # the metrics back as plain tensors
            grads = map_with_paths(lambda path, g: g.redistribute(
                g.device_mesh, _spec_at(params, path).placements), grads)
        params, opt_state, info = opt.update(params, grads, opt_state)
        metrics = dict(metrics, loss=loss, **info)
        metrics = {k: v.full_tensor() if is_dtensor(v) else v
                   for k, v in metrics.items()}
        return {"params": params, "opt": opt_state}, metrics

    return step, opt


def _on(params, batch: dict) -> dict:
    """The batch's arrays (numpy or tensors) on the params' device; a
    DTensor (a batch on a mesh) stays where it is, as ``_placed`` leaves
    it."""
    dev = device_of(params)
    return {k: v if is_dtensor(v) else torch.as_tensor(v).to(dev)
            for k, v in batch.items()}


# ------------------------------------------------------------------ LM ------
def split_micro(x, M: int, grouping: str = "strided"):
    """[GB, S] -> [M, GB / M, S], the reference's two groupings: "plain"
    takes consecutive rows a microbatch, "strided" every M-th row
    ([GB / M, M, S] with the micro axis moved first)."""
    GB, S = x.shape
    if grouping == "plain":
        return x.reshape(M, GB // M, S)
    return x.reshape(GB // M, M, S).transpose(0, 1)


def lm_grads(params, cfg, tokens, labels, n_micro: int,
             grouping: str = "strided"):
    """The LM step's gradient: the global batch [GB, S] in M = n_micro
    microbatches (M = 1 when GB % n_micro), each one forward and backward
    (``torch.autograd.grad``) accumulated into fp32 -> (mean loss, grads
    (fp32, params' nesting) / M). Only one microbatch's graph lives at a
    time."""
    from repro_torch.models.transformer import lm_loss
    GB = tokens.shape[0]
    M = n_micro if GB % n_micro == 0 else 1
    placed = is_dtensor(tokens)
    if placed:
        mesh, pl_t, pl_l = (tokens.device_mesh, tokens.placements,
                            labels.placements)
        if grouping == "plain":
            # consecutive rows a microbatch cross the data ranks' blocks,
            # and DTensor cannot unflatten a batch split more ways than
            # it has microbatches: the [GB, S] ids are gathered whole
            tokens, labels = unshard_dim(tokens, 0), unshard_dim(labels, 0)
    toks = split_micro(tokens, M, grouping)
    labs = split_micro(labels, M, grouping)
    acc = loss_sum = None
    for i in range(M):
        mt, ml = toks[i], labs[i]
        if placed:
            # each microbatch split over the data axes as the batch was
            mt = mt.redistribute(mesh, pl_t)
            ml = ml.redistribute(mesh, pl_l)
        loss, _, g = grads_of(
            lambda p, t, lb: lm_loss(p, cfg, t, lb), params, mt, ml)
        g = [t for _, t in flatten_with_paths(g)]
        if acc is None:
            acc = [t.to(torch.float32) for t in g]
            loss_sum = loss.to(torch.float32)
        else:
            for a, t in zip(acc, g):
                a.add_(t)
            loss_sum = loss_sum + loss
        del g
    for a in acc:
        a.div_(M)
    by_path = dict(zip((p for p, _ in flatten_with_paths(params)), acc))
    return loss_sum / M, map_with_paths(lambda path, _: by_path[path],
                                        params)


def build_lm_train_step(cfg, opt_kind: str, n_micro: int = 8, mesh=None,
                        micro_split: str = "strided", **opt_kw):
    """LM train step with gradient-accumulation microbatching -> (step,
    opt). step(state, batch) with batch {"tokens", "labels"} [GB, S]
    (numpy or tensors) -> (state, {"loss", "grad_norm", "lr"}): the fp32
    accumulated gradients (``lm_grads``) divided by M, then one
    ``opt.update``, in place. ``micro_split``: "strided" or "plain", the
    reference's two groupings (the mean loss is the same either way; the
    per-microbatch losses match the reference's only under the same
    grouping).

    ``mesh`` (a DeviceMesh): the reference partitions this step by jit's
    in and out shardings; here the same body runs on DTensors. The state
    arrives placed (``place_train_state`` by the arch's rules and
    ``opt_state_specs``), the batch as DTensors placed by the cell's
    in_specs (``data/loader.ShardedLoader``; a whole numpy or plain batch
    is split over the data axes here); each accumulated gradient is
    redistributed to its param's placements, and the in-place update
    keeps every state leaf's placements, as ``out_shardings=state_specs``
    does. The metrics come back as plain tensors. Where DTensor cannot
    carry the single-device code, the site changes on a mesh only:

      * ``transformer._embed``: the embedding lookup reads the row-sharded
        table on its blocks (``models/embedding.dtensor_lookup``: each
        rank looks up its ids in its own rows, the partial rows summed
        over "model"; no rank gathers the table, and DTensor's own masked
        lookup fails to reduce);
      * ``transformer.chunked_xent``: a chunk's logsumexp and gold logit
        from the vocabulary-sharded logits (``_lse_gold_sharded``: the
        max and the sum of exponentials reduced across ranks, each rank
        picking the labels in its vocabulary slice; the same masked
        gather fails);
      * ``layers.rope`` and ``attention.attend_train``: rope's
        frequencies and the default positions are replicated DTensors
        (DTensor refuses to mix plain tensors in);
      * ``attention._attend_mesh``: the attention runs on each rank's
        block from local tensors (its heads over "model", or with
        ``cfg.seq_shard_attn`` its block of q's sequence against the
        whole k and v): DTensor cannot carry ``_sdpa``'s grouped einsums
        over a sharded head dimension; ``attention._heads``: a head
        count the "model" axis does not divide gathers the projection's
        features whole first (DTensor will not unflatten an uneven
        split);
      * ``transformer._group_apply`` and the MoE: each branch's output
        and the residual are split over the data axes only
        (``models.module.pin_batch``, the reference's ``_pin_residual``),
        which keeps DTensor from reduce-scattering the activations;
      * ``moe._moe_tokens`` / ``_moe_rows``: routing (``core/topk.
        topk_stable``'s row writes, the ``kchoice`` kernel on local
        tensors) and the capacity scatter and combine run on local
        tensors: the flat block's whole on every rank (``models.module.
        on_whole``, what ``local_map`` does with replicated
        placements), the per-row dispatch's rows on their own data rank
        (``models.module.on_rows``); the expert products run on the
        sharded stacks;
      * ``moe._f32_bmm``: the fp32 matmul of upcast operands (DTensor
        has no rule for ``bmm`` with ``out_dtype``);
      * ``lm_grads``: each microbatch is split over the data axes again
        after the grouping; the "plain" grouping gathers the token ids
        whole first (a batch split over more data ranks than it has
        microbatches does not unflatten).

    The serve steps on a mesh (``build_lm_prefill``, ``build_lm_decode``)
    share these sites; the prefill's attention also runs the
    flash-attention kernel on each rank's block (``_attend_mesh``), and
    the decode writes and reads each rank's block of the DTensor caches
    (``attention._decode_mesh``) and takes the greedy token of the
    vocabulary-split logits (``next_token``).

    Without a mesh the step is the single-device one, unchanged."""
    opt = make_opt(opt_kind, **opt_kw)
    grouping = micro_split

    def step(state, batch):
        params, opt_state = state["params"], state["opt"]
        b = _on(params, batch) if mesh is None else _placed(params, batch,
                                                            mesh)
        loss, grads = lm_grads(params, cfg, b["tokens"], b["labels"],
                               n_micro, grouping)
        if mesh is not None:
            grads = map_with_paths(
                lambda path, g: g.redistribute(
                    g.device_mesh, _spec_at(params, path).placements),
                grads)
        params, opt_state, info = opt.update(params, grads, opt_state)
        metrics = dict(loss=loss, **info)
        if mesh is not None:
            metrics = {k: v.full_tensor() if is_dtensor(v) else v
                       for k, v in metrics.items()}
        return {"params": params, "opt": opt_state}, metrics

    return step, opt


def _placed(params, batch: dict, mesh) -> dict:
    """A train batch on a mesh: DTensor leaves as they are, any other leaf
    (the whole batch, the same on every rank) split over the data axes on
    its first dimension, on the params' device."""
    dev = device_of(params)
    return {k: v if is_dtensor(v) else place(
        torch.as_tensor(v).to(dev), (data_axes(mesh),), mesh)
        for k, v in batch.items()}


def next_token(logits):
    """Greedy next token of fp32 logits [B, V] -> int32 [B]; a tie goes to
    the smaller id (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does). DTensor logits (a mesh; the vocabulary split
    over "model") -> a DTensor [B] in their rows' layout: each rank's
    first maximum of its block, then the largest (value, -global id) pair
    across the ranks that split the vocabulary, packed in one int64 (the
    value's order-preserving bits high, 2^31 - 1 - id low) and
    all-reduced by max."""
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.module import reduce_over
    mesh = logits.device_mesh
    pl = list(logits.placements)
    local = logits.to_local()
    _, (_, v0) = local_block(logits.shape, mesh, pl)
    bits = local.amax(-1).to(torch.float32).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    ids = local.argmax(-1).to(torch.int64) + v0
    packed = key * (1 << 32) + (0x7FFFFFFF - ids)
    packed = reduce_over(packed, mesh, [i for i, p in enumerate(pl)
                                        if getattr(p, "dim", None) == 1],
                         "max")
    best = (0x7FFFFFFF - torch.remainder(packed, 1 << 32)).to(torch.int32)
    rows = [p if getattr(p, "dim", None) == 0 else Replicate() for p in pl]
    return DTensor.from_local(best, mesh, rows, run_check=False,
                              shape=logits.shape[:1], stride=(1,))


def build_lm_prefill(cfg):
    """step(model, batch) -> {"logits" [B, V] fp32, "hidden" [B, d],
    "next_token" [B] int32} for batch["tokens"] [B, S] (cache emission
    elided, as in the reference). ``model``: the LM module or its tensor
    tree; on a mesh a tree of DTensors (placed by the arch's rules) and
    DTensor tokens (by the cell's in_specs), each output a DTensor, the
    logits' vocabulary split as the head's."""
    from repro_torch.models.transformer import _logits, lm_backbone

    def step(model, batch):
        with torch.inference_mode():
            tokens = _on(model, batch)["tokens"]
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
    in the reference, whose step does not read ``context_len`` either. On
    a mesh the params, token, pos and caches are DTensors (the cell's
    specs: the caches' kv heads or sequence over "model"); each rank
    writes its block of the caches in place and the outputs are
    DTensors."""
    from repro_torch.models.transformer import _logits, decode_hidden
    del context_len

    def step(model, batch):
        with torch.inference_mode():
            b = _on(model, {k: batch[k] for k in ("token", "pos")})
            caches = batch["caches"]
            h = decode_hidden(model, cfg, b["token"], caches, b["pos"])
            logits = _logits(model, cfg, h)
            return {"next_token": next_token(logits), "caches": caches,
                    "logits": logits, "hidden": h}

    return step


def build_ctr_train_step(apply_fn, opt_kind: str = "adamw_nomaster",
                         **opt_kw):
    """apply_fn(params, batch) -> logit [B]; the label under
    batch["label"] -> (step, opt), the loss the mean
    ``stable_bce_with_logits``, metric ``bce``. The batch's arrays are
    moved to the params' device first.

    On DTensors (the registry's train_batch cells: params by the arch's
    ``rules()``, the batch's rows over the data axes) the model runs on
    each rank's rows (``models.module.on_batch_rows``; row-sharded tables
    read on their blocks, ``models/embedding``) and the loss is the
    all-reduced sum of the ranks' BCE sums over the global batch size."""
    from repro_torch.models.layers import stable_bce_with_logits

    def loss_fn(params, batch):
        b = _on(params, batch)
        logit, rows = on_batch_rows(apply_fn, params, b)
        if rows is None:
            loss = stable_bce_with_logits(logit, b["label"]).mean()
        else:
            mesh, pl, n = rows
            loss = sum_over_rows(stable_bce_with_logits(
                logit, b["label"].to_local()).sum() / n, mesh, pl)
        return loss, {"bce": loss.detach()}

    return build_train_step(loss_fn, opt_kind, **opt_kw)


def build_ctr_serve(apply_fn):
    """step(params, batch) -> {"prob": sigmoid(apply_fn(params, batch))}
    [B]; the batch's arrays (numpy or tensors) are moved to the params'
    device first. On DTensors each rank scores its own rows
    (``on_batch_rows``) and prob is a DTensor in the batch's layout."""

    def step(params, batch):
        with torch.inference_mode():
            logit, rows = on_batch_rows(apply_fn, params,
                                        _on(params, batch))
            prob = torch.sigmoid(logit)
            return {"prob": prob if rows is None
                    else rows_dtensor(prob, rows)}

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
    the card, which holds no [Bq, N] table; its plain version on the CPU.

    A DTensor table split on its rows (the retrieval_cand cells) is scored
    on each rank's block, one launch a rank (:func:`_retrieval_blocks`);
    every rank returns the same plain tensors."""

    def step(params, batch):
        with torch.inference_mode():
            table = params["item_table"]["table"]
            query = batch["query"]
            if is_dtensor(query):
                query = query.full_tensor()
            if is_row_sharded(table):
                return _retrieval_blocks(table, query, k)
            table = table.to(torch.float32)
            query = torch.as_tensor(query).to(table.device, torch.float32)
            vals, ids = _block_topk(query, table, k)
            return {"ids": ids, "scores": vals}

    return step


def _block_topk(query, table, k: int):
    """distance_topk ("dot", every row kept) of a query batch against a
    table: the kernel on the card, its plain version on the CPU."""
    import repro_torch.core.query  # noqa: F401  (before the kernel's ops,
    from repro_torch.kernels import on_card  # which core/query imports)
    from repro_torch.kernels.distance_topk.ops import distance_topk
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    every = torch.ones((1, table.shape[0]), dtype=torch.bool,
                       device=table.device)
    topk = distance_topk if on_card(query, table) else distance_topk_ref
    return topk(query, table, every, k=k, metric="dot")


def _retrieval_blocks(table, query, k: int) -> dict:
    """The retrieval top-k over a row-sharded DTensor table: each rank's
    ``distance_topk`` over its block (k' = min(k, its rows); a block of
    fewer rows pads with -inf and id -1), its ids made global, the [Q, k]
    winners of the table's blocks all-gathered in block order in one
    packed [Q, 2k] int32 buffer and merged by ``topk_stable``: equal
    scores go to the smaller position, which is the smaller global id
    (blocks ascend and each block's winners are in id order among equal
    scores), as ``core/distributed._merge_across_shards`` merges the
    sharded search."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.core.topk import topk_stable
    mesh = table.device_mesh
    local = table.to_local().to(torch.float32)
    (n_loc, _), (lo, _) = local_block(table.shape, mesh, table.placements)
    query = torch.as_tensor(query).to(local.device, torch.float32)
    Q = query.shape[0]
    kk = min(k, n_loc)
    vals, ids = _block_topk(query, local, kk)
    ids = (ids.to(torch.int64) + int(lo)).to(torch.int32)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((Q, k - kk), -torch.inf)], 1)
        ids = torch.cat([ids, ids.new_full((Q, k - kk), -1)], 1)
    packed = torch.cat([vals.contiguous().view(torch.int32), ids], 1)[None]
    blocks = math.prod(int(mesh.mesh.shape[i])
                       for i, p in enumerate(table.placements)
                       if getattr(p, "dim", None) == 0)
    every = DTensor.from_local(
        packed, mesh, table.placements, run_check=False,
        shape=(blocks, Q, 2 * k), stride=(Q * 2 * k, 2 * k, 1)).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()   # [P, Q, 2k]
    every = every.permute(1, 0, 2)                       # [Q, P, 2k]
    scores = every[..., :k].contiguous().view(torch.float32).reshape(Q, -1)
    best, pos = topk_stable(scores, k)
    merged = torch.gather(every[..., k:].reshape(Q, -1), 1, pos)
    return {"ids": merged, "scores": best}


# ----------------------------------------------------------------- GNN ------
def build_gnn_node_train(cfg, opt_kind="adamw_nomaster", **opt_kw):
    """SchNet node classification -> (step, opt): the NLL of the fp32
    ``log_softmax`` over ``cfg.n_out`` classes on all nodes, or weighted by
    batch["node_mask"] (sum / max(sum(mask), 1)); metric ``nll``. On
    DTensors (nodes and edges split over the mesh, or whole on every
    rank) ``schnet_apply`` runs on each rank's blocks and the masked
    mean's numerator and denominator are each summed over the ranks
    before the division."""
    from repro_torch.models.gnn import schnet_apply

    def loss_fn(params, batch):
        b = _on(params, batch)
        out = schnet_apply(params, cfg, b["feats"], b["src"], b["dst"],
                           b["dist"])
        rows = out.placements if is_dtensor(out) else None
        if rows is not None:
            mesh = out.device_mesh
            out, b = out.to_local(), {k: v.to_local() for k, v in b.items()}
        logp = torch.log_softmax(out.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, 1, b["labels"].long()[:, None])[:, 0]
        if rows is not None:
            m = b.get("node_mask", torch.ones_like(nll))
            loss = sum_over_rows(torch.sum(nll * m), mesh, rows) / \
                torch.clamp(sum_over_rows(m.sum(), mesh, rows), min=1.0)
        elif "node_mask" in b:
            m = b["node_mask"]
            loss = torch.sum(nll * m) / torch.clamp(m.sum(), min=1.0)
        else:
            loss = nll.mean()
        return loss, {"nll": loss.detach()}

    return build_train_step(loss_fn, opt_kind, **opt_kw)


def build_gnn_energy_train(cfg, n_graphs: int, opt_kind="adamw_nomaster",
                           **opt_kw):
    """SchNet molecule energy regression -> (step, opt): the MSE of the
    per-graph sums (batch["graph_ids"]) against batch["energy"]; metric
    ``mse``. On DTensors the per-graph sums come back whole on every rank
    (``schnet_apply``'s all-reduced readout), and so does the loss."""
    from repro_torch.models.gnn import schnet_apply

    def loss_fn(params, batch):
        b = _on(params, batch)
        e = schnet_apply(params, cfg, b["types"], b["src"], b["dst"],
                         b["dist"], graph_ids=b["graph_ids"],
                         n_graphs=n_graphs)
        energy = b["energy"]
        if is_dtensor(e):
            e, energy = e.to_local(), energy.full_tensor()
        loss = torch.mean((e[:, 0] - energy) ** 2)
        return loss, {"mse": loss.detach()}

    return build_train_step(loss_fn, opt_kind, **opt_kw)


# ----------------------------------------------------------------- IRLI -----
def build_irli_train_step(scorer_cfg, n_buckets: int,
                          opt_kind="adamw_nomaster", **opt_kw):
    """The IRLI scorer's train step (the paper's §5.3 system) on a batch
    {"x" [N, d], "label_ids" [N, k], "label_mask" [N, k], "assign" [R, L]}
    (numpy or tensors, moved to the params' device) -> (step, opt).

    On DTensors (the irli-deep1b train cell: params placed by
    ``configs/irli_deep1b.rules()``, the R axis over "model"; the batch by
    the cell's in_specs, rows over the data axes and ``assign`` over
    ("model", ("data",))) the step runs :func:`irli_mesh_loss` on each
    rank's blocks, each gradient is reduced to its param's placements and
    the optimizer updates in place, every state leaf keeping its
    placements. The metrics come back as plain tensors."""
    from repro_torch.core.network import scorer_loss
    from repro_torch.core.partition import bucket_targets

    def loss_fn(params, batch):
        if is_dtensor(params["w1"]):
            loss = irli_mesh_loss(params, scorer_cfg, batch, n_buckets)
            return loss, {"bce": loss.detach()}
        b = _on(params, batch)
        targets = bucket_targets(b["assign"], b["label_ids"],
                                 b["label_mask"], n_buckets)
        loss = scorer_loss(params, scorer_cfg, b["x"].float(), targets)
        return loss, {"bce": loss.detach()}

    return build_train_step(loss_fn, opt_kind, **opt_kw)


def irli_mesh_loss(params, scorer_cfg, batch, n_buckets: int):
    """The scorer's BCE on a mesh, each rank on its own blocks: its reps'
    scorer (the R axis over "model"), its rows (over the data axes) and
    its block of ``assign`` [R_loc, L_loc] (labels over "data").

    ``bucket_targets`` reads ``assign`` at each row's label ids, which
    lie anywhere in L. No rank gathers ``assign``: every rank takes the
    [N, k] label ids whole (an all-gather over the data axes), looks up
    the labels its block holds (0 for the others) -> [R_loc, N, k]
    buckets, a partial sum over "data" (exactly one data rank holds each
    label), which a reduce-scatter over "data" sums into each rank's rows.
    The rank then builds its [R_loc, N_loc, B] targets and its loss sum
    from local tensors, the params' local shards taken with gradients
    that are partial over the data axes; the loss is the all-reduced sum
    / (R · N), the meshless ``scorer_loss`` (unit weights)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.network import scorer_loss_parts
    w1 = params["w1"]
    mesh = w1.device_mesh
    names = list(mesh.mesh_dim_names)
    dax = data_axes(mesh)
    assign = batch["assign"]
    a_loc = assign.to_local()
    R, N = w1.shape[0], batch["x"].shape[0]
    k = batch["label_ids"].shape[1]
    lo = mesh.get_local_rank("data") * a_loc.shape[1]
    ids = batch["label_ids"].full_tensor().long()                 # [N, k]
    inside = (ids >= lo) & (ids < lo + a_loc.shape[1])
    part = torch.where(inside[None], a_loc[:, torch.where(
        inside, ids - lo, 0)], 0)                           # [R_loc, N, k]
    src = [Shard(0) if a == "model" else Partial() if a == "data"
           else Replicate() for a in names]
    dst = [Shard(0) if a == "model" else Shard(1) if a in dax
           else Replicate() for a in names]
    buckets = DTensor.from_local(
        part, mesh, src, run_check=False, shape=(R, N, k),
        stride=(N * k, k, 1)).redistribute(mesh, dst).to_local()
    mask = batch["label_mask"].to_local().to(torch.float32)
    R_loc, n_loc = buckets.shape[0], buckets.shape[1]
    targets = torch.zeros((R_loc, n_loc, n_buckets), dtype=torch.float32,
                          device=a_loc.device).scatter_reduce_(
        2, buckets.long(), mask[None].expand(R_loc, n_loc, k),
        reduce="amax", include_self=True)

    def local(p):
        return p.to_local(grad_placements=[
            Partial() if a in dax else pl
            for a, pl in zip(names, p.placements)])

    s, _ = scorer_loss_parts({n: local(p) for n, p in params.items()},
                             scorer_cfg,
                             batch["x"].to_local().to(torch.float32),
                             targets)
    return DTensor.from_local(s / (R * N), mesh,
                              [Partial()] * len(names),
                              run_check=False).full_tensor()


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
