"""IRLIIndex — the end-to-end orchestrator (Alg. 1 + Alg. 2).
Port of ``repro/core/index.py``.

fit():    init partitions (2-universal hash) -> loop: train R scorers for
          ``epochs_per_round`` epochs -> streaming top-K affinities ->
          power-of-K re-partition, until re-assignments stop or ``rounds``
          run out -> rebuild the inverted index. ANN mode (labels are the
          corpus vectors; Def. 2) and XML mode (label sets; Def. 1).
search(): Alg. 2 (top-m multiprobe + frequency filter + rerank).

Not yet ported: the (data × rep) mesh fit (``mesh=``) and the metric
registry (``registry=``).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import partition as PT
from repro_torch.core import search_api as SA
from repro_torch.core.network import ScorerConfig, scorer_init
from repro_torch.fit.engine import FitData, FitEngine, make_fit_optimizer
from repro_torch.fit.state import FitState
from repro_torch.kernels import resolve_device
from repro_torch.store.quantized import QuantizedStore


@dataclasses.dataclass
class IRLIConfig:
    d: int
    n_labels: int
    n_buckets: int = 256
    n_reps: int = 8
    d_hidden: int = 256
    K: int = 10                    # power-of-K choices
    parallel_slack: float = 2.0    # capacity slack for repartition_mode=parallel
    rounds: int = 5                # train/re-partition alternations
    epochs_per_round: int = 5
    batch_size: int = 512
    lr: float = 1e-3
    loss: str = "softmax_bce"
    repartition_mode: str = "exact"   # exact | parallel
    max_load_slack: float = 2.0       # member-matrix pad factor over L/B
    affinity_chunk: int = 4096        # label-chunk width of the affinity
    seed: int = 0


@dataclasses.dataclass
class FitStats:
    round_idx: list
    n_reassigned: list
    load_std: list
    train_loss: list      # per round: mean of that round's per-epoch means
    epoch_loss: list = dataclasses.field(default_factory=list)  # per round:
    #                     the [epochs_per_round] per-epoch mean losses


class IRLIIndex:
    """Scorer + assignment + inverted index on one device. Runs on ``cuda``
    unless the caller passes ``device="cpu"``; raises without a card."""

    def __init__(self, cfg: IRLIConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scorer_cfg = ScorerConfig(
            d_in=cfg.d, d_hidden=cfg.d_hidden, n_buckets=cfg.n_buckets,
            n_reps=cfg.n_reps, loss=cfg.loss)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params = scorer_init(self.scorer_cfg, gen)
        self.opt = make_fit_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)
        self.rng = torch.Generator().manual_seed(cfg.seed).get_state()
        self.assign = PT.hash_init(cfg.n_labels, cfg.n_buckets, cfg.n_reps,
                                   cfg.seed, device=self.device)
        self.index: PT.InvertedIndex | None = None
        self.epoch = 0

    # ---------------------------------------------------------------- fit --
    def fit(self, x_train, label_ids, label_mask=None, label_vecs=None,
            verbose: bool = False, log=None) -> FitStats:
        """x_train [N, d]; label_ids [N, k] (ANN: k exact neighbours; XML:
        padded label sets); label_mask [N, k] (1 for real labels);
        label_vecs [L, d] selects Def. 2 affinity (ANN mode). Numpy arrays
        or tensors.

        Runs ``cfg.rounds`` rounds of :class:`repro_torch.fit.engine.
        FitEngine` with one host sync a round (for the paper's "until
        re-assignments converge" stop), then ``build_index``. The index's
        params, optimizer state and assignment are updated in place. ``log``
        (anything with ``log(row, step=)``) gets one row a round: what
        :meth:`_record_fit_round` returns."""
        cfg = self.cfg
        data = FitData.build(x_train, label_ids, label_mask, label_vecs,
                             n_labels=cfg.n_labels, chunk=cfg.affinity_chunk,
                             device=self.device)
        engine = FitEngine(cfg, self.scorer_cfg)
        round_fn = engine.make_fit_round(data)
        state = FitState(params=self.params, opt_state=self.opt_state,
                         assign=self.assign, rng=self.rng, round_idx=0,
                         epoch_idx=0)
        n = data.x.shape[0]
        stats = FitStats([], [], [], [], [])
        for rnd in range(cfg.rounds):
            idx, w = engine.round_batches(n, cfg.seed, rnd)
            t0 = time.perf_counter()
            state, met = round_fn(state, idx, w)
            met = {k: v.cpu() for k, v in met.items()}   # one host sync
            dt = time.perf_counter() - t0
            self.assign, self.rng = state.assign, state.rng
            n_re = int(met["n_reassigned"])
            loss = float(met["loss"])
            lstd = float(met["load_std"])
            stats.round_idx.append(rnd)
            stats.n_reassigned.append(n_re)
            stats.load_std.append(lstd)
            stats.train_loss.append(loss)
            stats.epoch_loss.append([float(v) for v in met["epoch_loss"]])
            row = self._record_fit_round(rnd, met, dt)
            if log is not None:
                log.log(row, step=rnd)
            if verbose:
                print(f"[irli] round {rnd}: loss={loss:.4f} "
                      f"reassigned={n_re} load_std={lstd:.2f}")
            if n_re == 0:
                break
        self.build_index()
        return stats

    def _record_fit_round(self, rnd: int, met: dict, seconds: float) -> dict:
        """One round's metrics as a flat row: loss, re-assignments and churn
        (re-assignments per (rep, label) slot), and the load-balance family
        (std / min / max / KL-vs-uniform, the paper's §4 balance metric)."""
        cfg = self.cfg
        row = {"round": rnd, "seconds": seconds,
               "loss": float(met["loss"]),
               "n_reassigned": int(met["n_reassigned"]),
               "churn": float(met["n_reassigned"])
               / float(cfg.n_reps * cfg.n_labels),
               "load_std": float(met["load_std"])}
        for key in ("grad_norm", "load_min", "load_max", "load_kl"):
            if key in met:
                row[key] = float(met[key])
        return row

    def build_index(self):
        max_load = int(self.cfg.max_load_slack
                       * max(1, self.cfg.n_labels // self.cfg.n_buckets))
        self.index = PT.build_inverted_index(self.assign, self.cfg.n_buckets,
                                             max_load)

    def search(self, queries, base,
               params: SA.SearchParams) -> SA.SearchResult:
        """Candidate generation + true-distance re-rank over ``base``: the
        raw fp32 [L, d] corpus or a QuantizedStore over it (pass
        ``SearchParams(store_dtype=...)`` to match). -> SearchResult with
        ids [Q, k] int32 (-1 pad), scores [Q, k] f32, n_candidates [Q]
        int32, epoch and the resolved mode."""
        if self.index is None:
            raise RuntimeError("build_index() first")
        SA.check_params("IRLIIndex.search", params)
        SA.check_store("IRLIIndex.search", params, base)
        if isinstance(base, QuantizedStore):
            if base.device != self.device:
                raise ValueError(f"store on {base.device}, index on "
                                 f"{self.device}")
        else:
            base = torch.as_tensor(base, dtype=torch.float32,
                                   device=self.device)
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        resolved = params.resolve(int(base.shape[0]), int(queries.shape[0]))
        ids, scores, n_cand = resolved.pipeline().search(
            self.params, self.index.members, base, queries)
        return SA.SearchResult(ids=ids, scores=scores, n_candidates=n_cand,
                               epoch=self.epoch, mode=resolved.mode)

    def as_searcher(self, base) -> SA.Searcher:
        """Bind this index to its corpus as a ``Searcher``."""
        return SA.as_searcher(lambda q, p: self.search(q, base, p))
