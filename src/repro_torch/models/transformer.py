"""The LM family's transformer stack: GQA attention and a GLU MLP or an
MoE block per layer, tied or untied head, and the decode step with its KV
caches.

Port of ``repro/models/transformer.py:24-205`` for the forward and
``:256-314`` for decode. The model
is an ``nn.Module`` (:class:`LM`) whose parameter names follow the
reference's paths with the layer axis unstacked: the reference's
``layers/sub{i}/attn/q_proj/kernel`` [n_layers // period, d, H·D] is the
port's ``layers.{g·period + i}.attn.q_proj.kernel`` [d, H·D] (the
reference's [d_in, d_out] kernel layout; ``convert.lm_params_from_
reference`` carries weights across). The reference scans the layers with
remat; the forward's numbers are the same as a Python loop's. An MoE
layer (``cfg.moe``) holds ``moe`` (``models/moe.py``: the router and the
stacked [E, d, f] experts) where a dense one holds ``mlp``.

Decode: ``init_cache`` gives one {"k", "v"} pair a layer ([B, Sc, Kv, D],
Sc the context, or a ring of min(window, context) slots on an SWA layer),
``cache_specs`` their shapes and dtypes, and ``lm_decode_step`` one token
against them. It writes each layer's new K and V into the caches it is
given, in place, and returns them: the reference returns functional
copies, and copying a 15 GB cache each step would cost more than the step
(ROADMAP, the deliberate divergences).

Training (``:159-255``): ``lm_backbone`` takes the module or its
``models.module.tensor_tree`` (the form a train step's state holds, its
layers keyed "0", "1", ...); under a gradient it recomputes each period
group of layers in the backward when ``cfg.remat`` is set
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` over the
scan body), and each attention takes the reference's chunked ``_sdpa``
(``models/attention.py``). ``chunked_xent`` is the reference's sequence-
chunked cross-entropy, each chunk's fp32 logits recomputed in the
backward; ``lm_loss`` adds 0.01 · the MoE aux loss.

On a mesh the same code runs on DTensors (``launch/steps.
build_lm_train_step(mesh=)``, ``build_lm_prefill``, ``build_lm_decode``).
Four sites here differ: the embedding lookup reads the row-sharded table
on its blocks (``_embed``: ``models/embedding.dtensor_lookup``, each
rank's ids looked up in its own rows and the partial rows summed; no rank
gathers the table, and DTensor's own masked lookup does not reduce),
``decode_hidden`` pins each branch's output to the tokens' layout and
writes the DTensor caches on each rank's block (``attention.
_decode_mesh``), ``chunked_xent`` takes a chunk's
logsumexp and gold logit from the vocabulary-sharded logits without
gathering them (``_lse_gold_sharded``: the same masked gather fails),
and ``_group_apply`` pins each branch's output and the residual to the
batch split (``models.module.pin_batch``, the reference's
``_pin_residual``). ``seq_shard_attn`` is the reference's opt-in
context-parallel attention (``AttnConfig.seq_shard``, for configs whose
head count is not a multiple of 16).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import (AttnConfig, attend_decode,
                                          attend_train, attn_init,
                                          decode_cache_len)
from repro_torch.models.embedding import dtensor_lookup
from repro_torch.models.module import (as_module, grad_asked, is_dtensor,
                                       is_row_sharded, layer_list, pin_batch,
                                       unshard_dim)
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"                 # geglu => act="gelu", swiglu => "silu"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False          # gemma scales embeddings by sqrt(d)
    logit_cap: float = 0.0
    # attention pattern: tuple of layer kinds, repeated every len(pattern)
    attn_pattern: tuple[str, ...] = ("full",)
    window: int = 4096
    chunk: int = 8192
    nope_on_full: bool = False         # NoPE on 'full' layers (llama4)
    moe: Optional[MoEConfig] = None    # MoE (None => dense GLU MLP)
    param_dtype: str = "bfloat16"
    q_chunk: int = 1024
    ce_chunk: int = 8192               # tokens a chunked-CE step
    remat: bool = True                 # recompute each group in backward
    seq_shard_attn: bool = False       # opt-in context-parallel attention

    @property
    def period(self) -> int:
        return len(self.attn_pattern)

    def attn_cfg(self, kind_idx: int) -> AttnConfig:
        kind = self.attn_pattern[kind_idx]
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim, kind=kind,
            window=self.window, chunk=self.chunk,
            use_rope=not (self.nope_on_full and kind == "full"),
            qk_norm=self.qk_norm, rope_theta=self.rope_theta,
            q_chunk=self.q_chunk, logit_cap=self.logit_cap,
            # opt-in only, as the reference (measured worse for llama4 on
            # its mesh): heads that split over a 16-wide "model" axis
            # keep the head layout
            seq_shard=self.seq_shard_attn and self.n_heads % 16 != 0)

    def _attn_params(self) -> int:
        return (self.d_model * self.n_heads * self.head_dim * 2
                + self.d_model * self.n_kv_heads * self.head_dim * 2)

    def _total(self, mlp: int) -> int:
        d, V = self.d_model, self.vocab
        head = 0 if self.tie_embeddings else V * d
        return self.n_layers * (self._attn_params() + mlp + 2 * d) \
            + V * d + head + d

    @property
    def n_params(self) -> int:
        d = self.d_model
        if self.moe is None:
            return self._total(3 * d * self.d_ff)
        mlp = 3 * d * self.moe.d_ff * self.moe.n_experts \
            + d * self.moe.n_experts
        return self._total(mlp + 3 * d * self.moe.d_ff
                           * self.moe.n_shared_experts)

    @property
    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        mlp = 3 * d * self.moe.d_ff * (self.moe.top_k
                                       + self.moe.n_shared_experts)
        return self._total(mlp + d * self.moe.n_experts)


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class LM(nn.ModuleDict):
    """The LM's parameters, nested as the reference's tree: ``embed``,
    ``layers`` (one entry a layer), ``ln_final`` and, untied,
    ``lm_head``; ``cfg`` is its config. Calling it runs
    :func:`lm_backbone`."""

    def __init__(self, cfg: LMConfig, tree: dict):
        order = ("embed", "layers", "ln_final", "lm_head")
        super().__init__({k: as_module(tree[k]) for k in order if k in tree})
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self["embed"]["table"].device

    def forward(self, tokens):
        return lm_backbone(self, self.cfg, tokens)


# ------------------------------------------------------------------ init ----
def _layer_init(gen: torch.Generator, cfg: LMConfig, kind_idx: int) -> dict:
    dt = _dtype(cfg)
    p = {"ln_attn": L.rmsnorm_init(cfg.d_model, dt, gen.device),
         "attn": attn_init(gen, cfg.attn_cfg(kind_idx), dt),
         "ln_mlp": L.rmsnorm_init(cfg.d_model, dt, gen.device)}
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, cfg.moe, dt)
    else:
        p["mlp"] = L.glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def lm_init(cfg: LMConfig, *, seed: int = 0,
            device: str | torch.device = "cuda") -> LM:
    """Random weights on ``device`` from a ``torch.Generator`` seeded
    ``seed``: dense kernels normal / sqrt(d_in), the embedding normal /
    sqrt(d), norm scales 0 (the reference's distributions; not its
    numbers)."""
    if cfg.n_layers % cfg.period:
        raise ValueError(f"n_layers {cfg.n_layers} % pattern period "
                         f"{cfg.period} != 0")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _dtype(cfg)
    tree = {"embed": L.embedding_init(gen, cfg.vocab, cfg.d_model, dt),
            "layers": [_layer_init(gen, cfg, i % cfg.period)
                       for i in range(cfg.n_layers)],
            "ln_final": L.rmsnorm_init(cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dt,
                                       use_bias=False)
    return LM(cfg, tree)


# --------------------------------------------------------------- forward ----
def _embed(params, cfg: LMConfig, tokens):
    table = params["embed"]["table"]
    if is_row_sharded(table):
        # on a mesh each rank looks up its ids in its block of the table,
        # the partial rows summed (DTensor's masked lookup, MaskPartial,
        # fails to reduce; gathering the table costs 1.6 GB for gemma)
        x = dtensor_lookup(table, tokens)
    else:
        x = L.embedding_apply(params["embed"], tokens)
    if cfg.embed_scale:
        # rounded to the activation dtype first, as the reference does:
        # sqrt(3072) = 55.4256 is 55.5 in bf16
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _ffn(lp, cfg: LMConfig, h):
    """A layer's MLP or MoE block -> (y, aux loss)."""
    if cfg.moe is not None:
        return moe_apply(lp["moe"], cfg.moe, h)
    return L.glu_mlp_apply(lp["mlp"], h, cfg.act), None


def _group_apply(group, cfg: LMConfig, x):
    """One period group of layers (the reference's ``_group_apply_train``)
    -> (x, the group's aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(group):
        # on a mesh each branch's output and the residual stay split over
        # the data axes only (``pin_batch``, the reference's _pin_residual)
        x = pin_batch(x)
        h = L.rmsnorm_apply(lp["ln_attn"], x)
        x = x + pin_batch(attend_train(lp["attn"], cfg.attn_cfg(i), h))
        h = L.rmsnorm_apply(lp["ln_mlp"], x)
        y, a = _ffn(lp, cfg, h)
        if a is not None:
            aux = aux + a
        x = pin_batch(x + pin_batch(y))
    return x, aux


def lm_backbone(params, cfg: LMConfig, tokens):
    """tokens [B, S] -> (final hidden [B, S, d], aux loss: the MoE layers'
    load-balance losses summed, 0 for a dense model). Every layer's
    attention is one ``attend_train`` call (the flash-attention kernel on
    the card for the full-attention configs when no gradient is asked).
    Under a gradient with ``cfg.remat``, each period group is recomputed
    in the backward; under ``no_grad``/``inference_mode`` nothing is."""
    layers = layer_list(params["layers"])
    x = _embed(params, cfg, tokens)
    remat = cfg.remat and grad_asked(params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g0 in range(0, len(layers), cfg.period):
        group = layers[g0:g0 + cfg.period]
        if remat:
            x, a = checkpoint(_group_apply, group, cfg, x,
                              use_reentrant=False)
        else:
            x, a = _group_apply(group, cfg, x)
        aux = aux + a
    x = L.rmsnorm_apply(params["ln_final"], x)
    return x, aux


def _logits(params, cfg: LMConfig, h):
    """fp32 logits of hidden states h [..., d]."""
    if cfg.tie_embeddings:
        out = L.embedding_attend(params["embed"], h)
    else:
        out = torch.matmul(h.to(torch.float32),
                           params["lm_head"]["kernel"].to(torch.float32))
    if cfg.logit_cap > 0:
        out = cfg.logit_cap * torch.tanh(out / cfg.logit_cap)
    return out


def _vocab_split(logits) -> bool:
    """Whether DTensor logits' last (vocabulary) dimension is split across
    more than one rank."""
    if not is_dtensor(logits):
        return False
    mesh, last = logits.device_mesh, logits.ndim - 1
    return any(getattr(p, "dim", None) == last and mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def _lse_gold_sharded(logits, labels):
    """The logsumexp and the gold logit of DTensor logits [B, Cs, V] whose
    vocabulary is split across ranks (the head over "model"), without
    gathering the vocabulary: the max and the sum of exponentials reduce
    across ranks ([B, Cs] each), and each rank picks the labels that fall
    in its own vocabulary slice, a Partial sum. (DTensor's masked gather
    from sharded logits fails to reduce.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.module import local_block
    mesh = logits.device_mesh
    mx = logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - mx).sum(-1)) + mx[..., 0]
    shape, offset = local_block(logits.shape, mesh, logits.placements)
    rows = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in logits.placements]
    lab = labels.redistribute(mesh, rows).to_local().long()
    ids = torch.arange(offset[-1], offset[-1] + shape[-1],
                       device=lab.device)
    pick = DTensor.from_local(lab[..., None] == ids, mesh, logits.placements,
                              run_check=False, shape=logits.shape,
                              stride=logits.stride())
    return lse, torch.where(pick, logits, 0.0).sum(-1)


def chunked_xent(params, cfg: LMConfig, h, labels, mask):
    """Cross-entropy without the [B, S, V] logits at once: h [B, S, d],
    labels [B, S] int, mask [B, S] -> the masked mean of -log p(label).

    The sequence is cut into chunks of Cs = max(1, min(ce_chunk // B, S))
    positions (one chunk when S % Cs or S // Cs <= 1), the batch dim kept
    whole, as the reference does; each chunk's fp32 logits -> logsumexp ->
    the gold logit run under a checkpoint, so the backward recomputes them
    and only one chunk's logits live at a time. The sum is divided by
    max(sum(mask), 1)."""
    B, S, _ = h.shape
    mask = mask.to(torch.float32)
    Cs = max(1, min(cfg.ce_chunk // max(B, 1), S))
    if S % Cs != 0 or S // Cs <= 1:
        Cs = S

    def chunk_loss(hc, lc, mc):
        logits = _logits(params, cfg, hc)                  # [B, Cs, V] fp32
        if _vocab_split(logits):
            lse, gold = _lse_gold_sharded(logits, lc)
        else:
            logits = unshard_dim(logits, -1)   # whole on each rank already
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return torch.sum((lse - gold) * mc)

    grad = grad_asked(h, params)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, Cs):
        args = (h[:, s0:s0 + Cs], labels[:, s0:s0 + Cs], mask[:, s0:s0 + Cs])
        total = total + (checkpoint(chunk_loss, *args, use_reentrant=False)
                         if grad else chunk_loss(*args))
    return total / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params, cfg: LMConfig, tokens, labels, mask=None):
    """tokens, labels [B, S] (mask [B, S], default all ones) -> (ce + 0.01
    · aux, {"ce", "aux"})."""
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    h, aux = lm_backbone(params, cfg, tokens)
    ce = chunked_xent(params, cfg, h, labels, mask)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------- decode ----
def cache_specs(cfg: LMConfig, batch: int, context_len: int,
                dtype: torch.dtype | None = None) -> list[dict]:
    """The caches' shapes and dtypes without their memory: one {"k":
    (shape, dtype), "v": (shape, dtype)} a layer, shape [batch, Sc,
    n_kv_heads, head_dim] with Sc = ``decode_cache_len`` of the layer's
    attention (the reference's ShapeDtypeStructs)."""
    dtype = dtype or _dtype(cfg)
    out = []
    for layer in range(cfg.n_layers):
        Sc = decode_cache_len(cfg.attn_cfg(layer % cfg.period), context_len)
        spec = ((batch, Sc, cfg.n_kv_heads, cfg.head_dim), dtype)
        out.append({"k": spec, "v": spec})
    return out


def init_cache(cfg: LMConfig, batch: int, context_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device = "cuda") -> list[dict]:
    """Zero KV caches on ``device``, one {"k", "v"} pair of separate
    tensors a layer (``lm_decode_step`` writes them in place), ring buffers
    on the SWA layers."""
    dev = resolve_device(device)
    return [{n: torch.zeros(shape, dtype=dt, device=dev)
             for n, (shape, dt) in spec.items()}
            for spec in cache_specs(cfg, batch, context_len, dtype)]


def decode_hidden(params, cfg: LMConfig, token, caches, pos):
    """One decode step up to the final norm: token [B], caches (written in
    place), pos [B] -> final hidden [B, d]. The layers run in a Python loop
    (an SWA ring buffer and a full cache differ in shape). On DTensors each
    branch's output and the residual keep the tokens' layout (split over
    the data axes, or whole at B = 1), as ``_group_apply`` pins them."""
    with torch.inference_mode():
        x = _embed(params, cfg, token).unsqueeze(1)
        rows = x.placements if is_dtensor(x) else None

        def pin(t):
            return t if rows is None else t.redistribute(t.device_mesh, rows)

        for layer, lp in enumerate(layer_list(params["layers"])):
            acfg = cfg.attn_cfg(layer % cfg.period)
            c = caches[layer]
            h = L.rmsnorm_apply(lp["ln_attn"], x)
            out, _, _ = attend_decode(lp["attn"], acfg, h, c["k"], c["v"],
                                      pos)
            x = pin(x + pin(out))
            y = _ffn(lp, cfg, L.rmsnorm_apply(lp["ln_mlp"], x))[0]
            x = pin(x + pin(y))
        return L.rmsnorm_apply(params["ln_final"], x).squeeze(1)


def lm_decode_step(params, cfg: LMConfig, token, caches, pos):
    """One decode step. token [B], caches a list of per-layer {"k", "v"},
    pos [B] -> (logits [B, V] fp32, caches). The new K and V are written
    into the given caches in place, under ``torch.inference_mode``; the
    returned caches are those tensors."""
    h = decode_hidden(params, cfg, token, caches, pos)
    return _logits(params, cfg, h), caches
