"""The fit's train / re-partition round on one device.
Port of the single-device parts of ``repro/fit/engine.py``.

  fit_round(state, idx, w) -> (state', metrics)
    - ``epochs_per_round`` epochs over pre-permuted fixed-size batches
      (``idx`` / ``w`` [S, bs] index and weight matrices; the tail batch is
      padded with zero-weight rows, so nothing is dropped and nothing
      biases the gradient): per batch the multi-hot targets, the loss
      normalised by ``R · max(Σw, 1)`` (the ``bce_logits`` kernel for
      ``sigmoid_bce``), autograd, the global-norm clip over all gradients
      and one AdamW step, all in place;
    - the streaming top-K affinity (fit/affinity.py: ``irli_topk`` once a
      label chunk in ANN mode, no [R, chunk, B] block), power-of-K
      re-assignment (one ``kchoice`` launch for all reps in exact mode),
      and the re-assignment / load diagnostics.

The reference compiles the round into one jitted program with donated
state; here it is a plain Python function (no ``jit``) that runs eagerly
and overwrites the state's tensors. The (data × rep) mesh round waits for
the port of ``core/distributed.py``.

Random streams: the batch order is a pure function of (n, data_seed,
round_idx), each epoch's permutation drawn from a ``torch.Generator``
seeded from those three and the epoch; the insertion orders of the
re-partition come from the state's generator, advanced once a round. Both
can be injected (``idx`` / ``w``, ``orders``) to replay the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import partition as PT
from repro_torch.core import repartition as RP
from repro_torch.core.network import scorer_loss_parts
from repro_torch.fit.affinity import (affinity_topk_ann_chunks,
                                      affinity_topk_xml_chunks, ann_chunks,
                                      chunk_xml_pairs)
from repro_torch.fit.state import FitState
from repro_torch.optim.optimizers import (apply_clip, global_norm_sq,
                                          make_optimizer)


def make_fit_optimizer(cfg):
    """The fit's optimizer: AdamW without weight decay or master copy; its
    own clip is disabled because the round clips over the global norm of
    all gradients itself."""
    return make_optimizer("adamw", lr=cfg.lr, weight_decay=0.0,
                          master_fp32=False, clip_norm=float("inf"))


def _as(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=dtype)


@dataclasses.dataclass
class FitData:
    """Training inputs on the fit's device, prepared once per fit. ANN mode
    carries ``label_vecs`` (Def. 2); XML mode the pre-bucketed incidence
    pairs (Def. 1, see fit/affinity.chunk_xml_pairs)."""
    x: torch.Tensor              # [N, d]
    label_ids: torch.Tensor      # [N, k] int32
    label_mask: torch.Tensor     # [N, k] float32
    label_vecs: Any = None       # [L, d] | None  (ANN mode)
    xml_pairs: Any = None        # (points, locs, w) | None (XML mode)
    xml_chunk: int = 0           # label-chunk width of the pairs

    @classmethod
    def build(cls, x, label_ids, label_mask=None, label_vecs=None, *,
              n_labels: int = 0, chunk: int = 4096,
              device: str | torch.device = "cpu") -> "FitData":
        x = _as(x, torch.float32, device)
        label_ids = _as(label_ids, torch.int32, device)
        label_mask = (torch.ones(label_ids.shape, dtype=torch.float32,
                                 device=device) if label_mask is None
                      else _as(label_mask, torch.float32, device))
        if label_vecs is not None:
            return cls(x, label_ids, label_mask,
                       label_vecs=_as(label_vecs, torch.float32, device))
        if n_labels <= 0:
            raise ValueError("XML mode (label_vecs=None) needs n_labels > 0 "
                             "to bucket the incidence pairs")
        N, k = label_ids.shape
        pts = np.repeat(np.arange(N), k)
        labs = label_ids.cpu().numpy().reshape(-1)
        keep = label_mask.cpu().numpy().reshape(-1) > 0
        pairs, xml_chunk = chunk_xml_pairs(pts[keep], labs[keep], n_labels,
                                           chunk)
        return cls(x, label_ids, label_mask,
                   xml_pairs=tuple(t.to(device) for t in pairs),
                   xml_chunk=xml_chunk)


def _epoch_seed(data_seed: int, round_idx: int, epoch: int) -> int:
    s = np.random.SeedSequence([data_seed, round_idx, epoch])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


class FitEngine:
    """The fit rounds for one (IRLIConfig, ScorerConfig), single device."""

    def __init__(self, cfg, scorer_cfg, *, clip_norm: float = 1.0):
        self.cfg = cfg
        self.scorer_cfg = scorer_cfg
        self.clip_norm = clip_norm
        self.opt = make_fit_optimizer(cfg)

    # ------------------------------------------------------------ batching -
    def batch_plan(self, n: int) -> tuple[int, int, int]:
        """(steps_per_round, batch_size, batches_per_epoch). The tail batch
        is padded up, never dropped."""
        bs = min(self.cfg.batch_size, n)
        nb = -(-n // bs)
        return self.cfg.epochs_per_round * nb, bs, nb

    def round_batches(self, n: int, data_seed: int, round_idx: int):
        """Pre-permuted fixed-size batches for one round: (idx int64,
        w f32) [S, bs], on the CPU. A pure function of (n, data_seed,
        round_idx). Padding rows point at row 0 with weight 0: a placement
        and gradient no-op."""
        S, bs, nb = self.batch_plan(n)
        E = self.cfg.epochs_per_round
        pad = nb * bs - n
        idx = []
        for e in range(E):
            gen = torch.Generator().manual_seed(
                _epoch_seed(data_seed, round_idx, e))
            idx.append(torch.cat([torch.randperm(n, generator=gen),
                                  torch.zeros(pad, dtype=torch.int64)]))
        idx = torch.stack(idx).reshape(S, bs)
        w = torch.cat([torch.ones(n), torch.zeros(pad)])
        w = w.expand(E, nb * bs).reshape(S, bs).clone()
        return idx, w

    # ----------------------------------------------------------- affinity --
    @torch.no_grad()
    def affinity_topk(self, params: dict, data: FitData):
        """Streaming top-K affinity -> (vals, ids) [R, L, K]."""
        cfg = self.cfg
        if data.label_vecs is not None:
            L = data.label_vecs.shape[0]
            xs, _ = ann_chunks(data.label_vecs, cfg.affinity_chunk)
            vals, idxs = affinity_topk_ann_chunks(params, xs, cfg.K,
                                                  cfg.loss)
        else:
            L = cfg.n_labels
            vals, idxs = affinity_topk_xml_chunks(
                params, data.x, data.xml_pairs, data.xml_chunk, cfg.K,
                cfg.loss)
        return vals[:, :L], idxs[:, :L]

    # ---------------------------------------------------------- train step -
    def train_step(self, params: dict, opt_state: dict,
                   assign: torch.Tensor, data: FitData, sel: torch.Tensor,
                   wt: torch.Tensor):
        """One batch, in place: params and opt_state take the AdamW step.
        sel [bs] int64 rows, wt [bs] f32 weights, both on the CPU ->
        (loss of the batch, 0-d tensor; Σw, a float; the pre-clip global
        gradient norm, 0-d tensor)."""
        cfg, scfg = self.cfg, self.scorer_cfg
        dev = data.x.device
        wsum = float(wt.sum())
        denom = scfg.n_reps * max(wsum, 1.0)
        sel_d = sel.to(dev)
        targets = PT.bucket_targets(assign, data.label_ids[sel_d],
                                    data.label_mask[sel_d], cfg.n_buckets)
        keys = sorted(params)
        with torch.enable_grad():
            for k in keys:
                params[k].requires_grad_(True)
            part, _ = scorer_loss_parts(params, scfg, data.x[sel_d], targets,
                                        wt.to(dev), scale=1.0 / denom)
            del targets
            grads = torch.autograd.grad(part, [params[k] for k in keys])
            for k in keys:
                params[k].requires_grad_(False)
        grads = dict(zip(keys, grads))
        norm = torch.sqrt(global_norm_sq(grads))
        apply_clip(grads, norm, self.clip_norm)
        self.opt.update(params, grads, opt_state)
        return part.detach(), wsum, norm

    # ---------------------------------------------------------- round body -
    def round_body(self, state: FitState, idx: torch.Tensor,
                   w: torch.Tensor, data: FitData, orders=None):
        """One round: train, affinity, re-partition -> (state, metrics).
        ``state`` is updated in place and returned; metrics are 0-d device
        tensors (``epoch_loss`` and ``step_loss`` 1-d). ``orders`` [R, L]
        injects the re-partition's insertion orders."""
        cfg = self.cfg
        R, B = self.scorer_cfg.n_reps, cfg.n_buckets
        E = cfg.epochs_per_round
        nb = idx.shape[0] // E
        assign = state.assign
        params, opt_state = state.params, state.opt_state
        losses, wsums, norms = [], [], []
        for s in range(idx.shape[0]):
            part, wsum, norm = self.train_step(params, opt_state, assign,
                                               data, idx[s], w[s])
            losses.append(part)
            wsums.append(wsum)
            norms.append(norm)
        losses = torch.stack(losses)
        # per-epoch weighted means (weights = real rows per batch), then
        # the per-round mean of per-epoch means
        le = losses.reshape(E, nb)
        we = torch.tensor(wsums, dtype=torch.float32,
                          device=losses.device).reshape(E, nb)
        epoch_loss = (torch.sum(le * we, 1)
                      / torch.clamp(torch.sum(we, 1), min=1.0))

        vals, idxs = self.affinity_topk(params, data)
        gen = state.generator()
        if orders is None and cfg.repartition_mode == "exact":
            orders = RP.insertion_orders(R, idxs.shape[1], idxs.device, gen)
        new_assign = RP.repartition_topk(vals, idxs, B,
                                         cfg.repartition_mode, orders,
                                         slack=cfg.parallel_slack)
        del vals, idxs
        n_re = torch.sum(new_assign != assign)
        ld = PT.loads(new_assign, B).float()
        lstd = torch.sum(torch.std(ld, dim=1, correction=0)) / R
        # the paper's load-balance summary of the NEW partition: bucket
        # min / max across reps and the mean per-rep KL(p || uniform)
        p = ld / torch.clamp(torch.sum(ld, dim=1, keepdim=True), min=1.0)
        kl = torch.where(p > 0, p * torch.log(p * B), torch.zeros_like(p))
        metrics = {"loss": torch.mean(epoch_loss), "epoch_loss": epoch_loss,
                   "step_loss": losses, "n_reassigned": n_re,
                   "load_std": lstd, "grad_norm": torch.mean(torch.stack(
                       norms)), "load_min": torch.min(ld),
                   "load_max": torch.max(ld), "load_kl": torch.sum(kl) / R}
        state.assign = new_assign
        state.rng = gen.get_state()
        state.round_idx += 1
        state.epoch_idx += E
        return state, metrics

    def make_fit_round(self, data: FitData):
        """fit_round(state, idx, w, orders=None) -> (state, metrics): the
        round body bound to ``data``. A plain function, not compiled: it
        runs eagerly and updates the state in place."""
        return lambda state, idx, w, orders=None: self.round_body(
            state, idx, w, data, orders)
