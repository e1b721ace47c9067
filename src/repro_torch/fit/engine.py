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
and overwrites every tensor of the state in place (params, AdamW moments
and step, assign, the generator state): the contract
``fit.round_donates_state`` below holds it to that.

Mesh version (``make_sharded_fit_round``): the reference's ``shard_map``
over a ("data", "rep") mesh becomes one process a mesh position, each
running the same round on its block (``_round_body`` with axes):
  - batch COLUMNS split over "data": each data rank takes its contiguous
    1/d_size of every batch's rows; the loss part and every gradient are
    all-reduced over "data" (Σw, the loss's normaliser, is the row sum of
    the replicated batch weights, which every rank holds whole);
  - the R reps split over "rep": params, AdamW moments and assign hold
    rows r0 to r0 + R_loc (``shard_state`` / ``gather_state``); the
    global-norm clip's squared norm is all-reduced over "rep";
  - the affinity's label chunks split over "data" when they divide, then
    one all-gather of each of the [R_loc, L/d_size, K] values and ids;
    otherwise every rank computes them all, as the reference falls back;
  - the diagnostics summed over "rep" (n_reassigned, load_std, load_kl)
    and load_min / load_max taken with MIN / MAX reductions;
  - the insertion orders: every rank draws all R rows from the state's
    generator and keeps its own, so a rank's rows are the single-device
    engine's and the generator advances alike everywhere. A 1 × 1 mesh is
    bit-equal to ``make_fit_round``.

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
import torch.distributed as dist

from repro_torch.core import partition as PT
from repro_torch.core import repartition as RP
from repro_torch.core.distributed import (AxisGroup, all_gather_cat,
                                          axis_group)
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


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """A (data × rep) fit mesh as one rank sees it: the two axes' groups
    and this rank's rep rows r0 to r0 + R_loc of R."""
    data: AxisGroup
    rep: AxisGroup
    R: int
    R_loc: int

    @property
    def r0(self) -> int:
        return self.rep.index * self.R_loc


def _map_reps(tree, fn):
    """``fn`` on every tensor leaf with a leading rep axis (ndim >= 1) of a
    nested dict; 0-d leaves (the AdamW step) kept as they are."""
    if isinstance(tree, dict):
        return {k: _map_reps(v, fn) for k, v in tree.items()}
    return fn(tree) if tree.ndim >= 1 else tree


def _sum_(t: torch.Tensor, grp: AxisGroup,
          op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce a tensor of any shape (0-d included) over ``grp``."""
    flat = t.reshape(-1).contiguous()
    dist.all_reduce(flat, op=op, group=grp.group)
    return flat.reshape(t.shape)


class FitEngine:
    """The fit rounds for one (IRLIConfig, ScorerConfig): on one device
    (``make_fit_round``) or on a (data × rep) mesh of ranks
    (``make_sharded_fit_round``)."""

    def __init__(self, cfg, scorer_cfg, *, data_axis: str = "data",
                 rep_axis: str = "rep", clip_norm: float = 1.0):
        self.cfg = cfg
        self.scorer_cfg = scorer_cfg
        self.data_axis = data_axis
        self.rep_axis = rep_axis
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
    def affinity_topk(self, params: dict, data: FitData,
                      axes: MeshAxes | None = None):
        """Streaming top-K affinity for the reps of ``params`` -> (vals,
        ids) [R_loc, L, K]. On a mesh the label chunks are split over the
        data axis when their count divides by it (each data rank scores a
        contiguous 1/d_size of them, then one all-gather of the values and
        one of the ids reassemble them: the same per-chunk computations as
        the unsplit path); otherwise every rank computes them all."""
        cfg = self.cfg
        if data.label_vecs is not None:
            L = data.label_vecs.shape[0]
            xs, _ = ann_chunks(data.label_vecs, cfg.affinity_chunk)
            n_chunks = xs.shape[0]

            def reduce(lo, hi):
                return affinity_topk_ann_chunks(params, xs[lo:hi], cfg.K,
                                                cfg.loss)
        else:
            L = cfg.n_labels
            n_chunks = data.xml_pairs[0].shape[0]

            def reduce(lo, hi):
                return affinity_topk_xml_chunks(
                    params, data.x, tuple(t[lo:hi] for t in data.xml_pairs),
                    data.xml_chunk, cfg.K, cfg.loss)
        d = axes.data if axes is not None else None
        if d is not None and d.size > 1 and n_chunks % d.size == 0:
            loc = n_chunks // d.size
            vals, idxs = reduce(d.index * loc, (d.index + 1) * loc)
            vals = all_gather_cat(vals, d.group, dim=1)
            idxs = all_gather_cat(idxs, d.group, dim=1)
        else:
            vals, idxs = reduce(0, n_chunks)
        return vals[:, :L], idxs[:, :L]

    # ---------------------------------------------------------- train step -
    def train_step(self, params: dict, opt_state: dict,
                   assign: torch.Tensor, data: FitData, sel: torch.Tensor,
                   wt: torch.Tensor, axes: MeshAxes | None = None,
                   wsum: float | None = None):
        """One batch, in place: params and opt_state take the AdamW step.
        sel [bs] int64 rows, wt [bs] f32 weights, both on the CPU ->
        (loss of the batch, 0-d tensor; Σw, a float; the pre-clip global
        gradient norm, 0-d tensor). On a mesh, ``sel``/``wt`` are this data
        rank's columns, ``wsum`` the whole batch's Σw, the returned loss
        this rank's part; the gradients are summed over "data" and the
        norm's square over "rep"."""
        cfg, scfg = self.cfg, self.scorer_cfg
        dev = data.x.device
        wsum = float(wt.sum()) if wsum is None else wsum
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
        if axes is None:
            norm = torch.sqrt(global_norm_sq(grads))
        else:
            for k in keys:
                dist.all_reduce(grads[k], group=axes.data.group)
            norm = torch.sqrt(_sum_(global_norm_sq(grads), axes.rep))
        apply_clip(grads, norm, self.clip_norm)
        self.opt.update(params, grads, opt_state)
        return part.detach(), wsum, norm

    # ---------------------------------------------------------- round body -
    def round_body(self, state: FitState, idx: torch.Tensor,
                   w: torch.Tensor, data: FitData, orders=None,
                   axes: MeshAxes | None = None):
        """One round: train, affinity, re-partition -> (state, metrics).
        ``state`` is updated in place and returned; metrics are 0-d device
        tensors (``epoch_loss`` and ``step_loss`` 1-d). ``orders`` [R, L]
        injects the re-partition's insertion orders. With ``axes`` (a
        mesh) ``state`` holds this rank's rep rows, ``idx``/``w`` and
        ``orders`` are whole, and every metric is the mesh-wide value."""
        cfg = self.cfg
        R, B = self.scorer_cfg.n_reps, cfg.n_buckets
        E = cfg.epochs_per_round
        nb = idx.shape[0] // E
        assign = state.assign
        params, opt_state = state.params, state.opt_state
        cols = slice(None)
        if axes is not None:
            d = axes.data
            bs = idx.shape[1]
            if bs % d.size:
                raise ValueError(f"batch size {bs} not divisible by "
                                 f"{self.data_axis}={d.size}")
            cols = slice(d.index * (bs // d.size),
                         (d.index + 1) * (bs // d.size))
        losses, wsums, norms = [], [], []
        for s in range(idx.shape[0]):
            part, wsum, norm = self.train_step(
                params, opt_state, assign, data, idx[s, cols], w[s, cols],
                axes, wsum=float(w[s].sum()))
            losses.append(part)
            wsums.append(wsum)
            norms.append(norm)
        losses = torch.stack(losses)
        if axes is not None:
            losses = _sum_(_sum_(losses, axes.data), axes.rep)
        # per-epoch weighted means (weights = real rows per batch), then
        # the per-round mean of per-epoch means
        le = losses.reshape(E, nb)
        we = torch.tensor(wsums, dtype=torch.float32,
                          device=losses.device).reshape(E, nb)
        epoch_loss = (torch.sum(le * we, 1)
                      / torch.clamp(torch.sum(we, 1), min=1.0))

        vals, idxs = self.affinity_topk(params, data, axes)
        gen = state.generator()
        if orders is None and cfg.repartition_mode == "exact":
            # all R rows on every rank: the stream advances alike
            orders = RP.insertion_orders(R, idxs.shape[1], "cpu", gen)
        if axes is not None and orders is not None \
                and orders.shape[0] == R:
            orders = orders[axes.r0:axes.r0 + axes.R_loc]
        new_assign = RP.repartition_topk(vals, idxs, B,
                                         cfg.repartition_mode, orders,
                                         slack=cfg.parallel_slack)
        del vals, idxs
        n_re = torch.sum(new_assign != assign)
        ld = PT.loads(new_assign, B).float()
        std_sum = torch.sum(torch.std(ld, dim=1, correction=0))
        # the paper's load-balance summary of the NEW partition: bucket
        # min / max across reps and the mean per-rep KL(p || uniform)
        p = ld / torch.clamp(torch.sum(ld, dim=1, keepdim=True), min=1.0)
        kl = torch.where(p > 0, p * torch.log(p * B), torch.zeros_like(p))
        kl_sum, lmin, lmax = torch.sum(kl), torch.min(ld), torch.max(ld)
        if axes is not None:
            n_re = _sum_(n_re, axes.rep)
            std_sum, kl_sum = _sum_(torch.stack([std_sum, kl_sum]),
                                    axes.rep)
            lmin, neg_max = _sum_(torch.stack([lmin, -lmax]), axes.rep,
                                  dist.ReduceOp.MIN)
            lmax = -neg_max
        metrics = {"loss": torch.mean(epoch_loss), "epoch_loss": epoch_loss,
                   "step_loss": losses, "n_reassigned": n_re,
                   "load_std": std_sum / R, "grad_norm": torch.mean(
                       torch.stack(norms)), "load_min": lmin,
                   "load_max": lmax, "load_kl": kl_sum / R}
        # the state is donated: every tensor leaf is overwritten in place
        state.assign.copy_(new_assign)
        state.rng.copy_(gen.get_state())
        state.round_idx += 1
        state.epoch_idx += E
        return state, metrics

    def make_fit_round(self, data: FitData):
        """fit_round(state, idx, w, orders=None) -> (state, metrics): the
        round body bound to ``data``. A plain function, not compiled: it
        runs eagerly and updates the state in place."""
        return lambda state, idx, w, orders=None: self.round_body(
            state, idx, w, data, orders)

    def step_fn(self, data: FitData):
        """The single-device round over dict states (``FitState.as_dict``),
        the step of ``repro_torch.train.trainer.Trainer`` (through
        ``launch/steps.build_irli_fit_parts``): step(state_dict, {"idx",
        "w"[, "orders"]}) -> (state_dict, metrics), the state updated in
        place. ``orders`` [R, L] injects the insertion orders."""
        return _dict_step(self.make_fit_round(data))

    # --------------------------------------------------------- mesh round --
    def mesh_axes(self, mesh) -> MeshAxes:
        """This rank's view of a (data × rep) mesh
        (``launch/mesh.make_fit_mesh``)."""
        names = getattr(mesh, "mesh_dim_names", None)
        if names is None:
            raise TypeError(
                f"mesh= takes a torch.distributed DeviceMesh with axes "
                f"({self.data_axis!r}, {self.rep_axis!r}) (launch/mesh."
                f"make_fit_mesh), got {type(mesh).__name__}")
        if self.data_axis not in names or self.rep_axis not in names:
            raise ValueError(f"the fit mesh needs axes {self.data_axis!r} "
                             f"and {self.rep_axis!r}, got {names}")
        d = axis_group(mesh, self.data_axis)
        r = axis_group(mesh, self.rep_axis)
        R = self.scorer_cfg.n_reps
        if R % r.size:
            raise ValueError(f"n_reps={R} not divisible by "
                             f"{self.rep_axis}={r.size}")
        return MeshAxes(d, r, R, R // r.size)

    def shard_state(self, state: FitState, mesh) -> FitState:
        """This rank's rep rows of a whole state: params, AdamW moments and
        assign, and the generator state (copies; params and moments are the
        state's own when the rep axis has size 1). The rounds overwrite
        the result in place, so the caller's assign and generator state
        stay as they were until ``gather_state``."""
        ax = self.mesh_axes(mesh)
        if ax.rep.size == 1:
            return dataclasses.replace(state, assign=state.assign.clone(),
                                       rng=state.rng.clone())
        rows = slice(ax.r0, ax.r0 + ax.R_loc)

        def take(t):
            return t[rows].clone()

        return FitState(params=_map_reps(state.params, take),
                        opt_state=_map_reps(state.opt_state, take),
                        assign=take(state.assign), rng=state.rng.clone(),
                        round_idx=state.round_idx,
                        epoch_idx=state.epoch_idx)

    def gather_state(self, state: FitState, mesh) -> FitState:
        """The whole state on every rank from each rank's rep rows: one
        all-gather over "rep" a leaf (the state itself when the rep axis
        has size 1)."""
        ax = self.mesh_axes(mesh)
        if ax.rep.size == 1:
            return state

        def whole(t):
            return all_gather_cat(t, ax.rep.group, dim=0)

        return FitState(params=_map_reps(state.params, whole),
                        opt_state=_map_reps(state.opt_state, whole),
                        assign=whole(state.assign), rng=state.rng,
                        round_idx=state.round_idx,
                        epoch_idx=state.epoch_idx)

    def make_sharded_fit_round(self, mesh, data: FitData, state: FitState):
        """The mesh round: fit_round(state, idx, w, orders=None) ->
        (state, metrics), called by every rank of ``mesh`` in lockstep with
        the same ``idx``/``w`` (and ``orders``, if injected) and its own
        rep rows as ``state`` (``shard_state``); ``state`` here is that
        template, checked for its row count. Updates in place, as
        ``make_fit_round``."""
        ax = self.mesh_axes(mesh)
        if state.assign.shape[0] != ax.R_loc:
            raise ValueError(
                f"the mesh round takes this rank's {ax.R_loc} rep rows, got "
                f"{state.assign.shape[0]}: shard_state(state, mesh) first")
        return lambda state, idx, w, orders=None: self.round_body(
            state, idx, w, data, orders, ax)

    def sharded_step_fn(self, mesh, data: FitData, state: FitState):
        """The mesh round over dict states (``FitState.as_dict``) of this
        rank's rep rows, the step of ``repro_torch.train.trainer.Trainer``
        on a (data × rep) mesh (through ``launch/steps.
        build_irli_fit_parts(mesh=)``, whose checkpoint hooks gather the
        whole state and shard it again): step(state_dict, {"idx", "w"[,
        "orders"]}) -> (state_dict, metrics), called by every rank in
        lockstep."""
        return _dict_step(self.make_sharded_fit_round(mesh, data, state))


def _dict_step(round_fn):
    """A round over FitStates -> the same round over their dict views."""
    def step(sd, batch):
        ns, m = round_fn(FitState.from_dict(sd), batch["idx"], batch["w"],
                         batch.get("orders"))
        return ns.as_dict(), m
    return step


# ------------------------------------------------------- static contracts --
# The round's scalability and state-handling invariants, as registered
# contracts (audited by repro_torch.launch.audit): no [.., L, B] dense
# affinity, the state overwritten in place (the reference's donation), one
# argument signature a round structure, and a bounded collective schedule
# on the ("data", "rep") mesh path.
from repro_torch.analysis import contracts as _C  # noqa: E402


def _fit_round_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.fit_round()


def _fit_dense_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.fit_round_dense_control()


def _fit_sweep_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.fit_round_sweep()


def _sharded_round_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.sharded_fit_round()


_C.register(_C.Contract(
    id="fit.round_no_dense_affinity",
    site="repro_torch.fit.engine.FitEngine.make_fit_round",
    description="the whole train+affinity+re-partition round never "
                "materializes [.., L, B] (the 100M-label guarantee); the "
                "streamed [R, chunk, B] block (held on chip by irli_topk on "
                "the card) and the running [R, L, K] carry must BOTH be "
                "sighted (non-vacuity); the seed-style dense path is the "
                "control",
    fixture=_fit_round_fixture,
    checks=[
        _C.forbid_dims("L", "B"),
        _C.require_dims("chunk", "B", on_chip="irli_topk"),
        _C.require_dims("L", "K"),
    ],
    control=_fit_dense_control,
))

_C.register(_C.Contract(
    id="fit.round_donates_state",
    site="repro_torch.fit.engine.FitEngine.make_fit_round "
         "(state overwritten in place)",
    description="every FitState tensor leaf holds, after the round, the "
                "storage of a leaf of the returned state (no second copy "
                "of the state); the control runs the round on cloned "
                "leaves and must alias none of the originals",
    fixture=_fit_round_fixture,
    checks=[_C.require_donated()],
))

_C.register(_C.Contract(
    id="fit.round_compiles_once",
    site="repro_torch.fit.engine.FitEngine.make_fit_round",
    description="two rounds over fresh same-structure states run one "
                "argument signature — a second means the state or batch "
                "structure drifted between rounds",
    fixture=_fit_sweep_fixture,
    checks=[_C.max_trace_count(1)],
))

_C.register(_C.Contract(
    id="fit.sharded_round_collectives",
    site="repro_torch.fit.engine.FitEngine.make_sharded_fit_round",
    description="the (data x rep) mesh round speaks only all-reduce (grad "
                "sums, scalar diagnostics) and all-gather (split-affinity "
                "reassembly) within a generous byte ceiling — no "
                "all-to-all / reduce-scatter / point-to-point may appear "
                "on the fit path",
    fixture=_sharded_round_fixture,
    checks=[_C.allowed_collectives({
        "all-reduce": 1 << 24, "all-gather": 1 << 24,
    })],
    min_devices=4,
))
