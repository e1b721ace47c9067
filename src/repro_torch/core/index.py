"""IRLIIndex — the serving side of the orchestrator (Alg. 2).
Port of ``repro/core/index.py``; the fit (Alg. 1) is not part of this slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import partition as PT
from repro_torch.core import search_api as SA
from repro_torch.core.network import ScorerConfig, scorer_init
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
        self.assign = PT.hash_init(cfg.n_labels, cfg.n_buckets, cfg.n_reps,
                                   cfg.seed, device=self.device)
        self.index: PT.InvertedIndex | None = None
        self.epoch = 0

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
