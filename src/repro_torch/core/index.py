"""IRLIIndex — the end-to-end orchestrator (Alg. 1 + Alg. 2).
Port of ``repro/core/index.py``.

fit():    init partitions (2-universal hash) -> loop: train R scorers for
          ``epochs_per_round`` epochs -> streaming top-K affinities ->
          power-of-K re-partition, until re-assignments stop or ``rounds``
          run out -> rebuild the inverted index. ANN mode (labels are the
          corpus vectors; Def. 2) and XML mode (label sets; Def. 1).
search(): Alg. 2 (top-m multiprobe + frequency filter + rerank), through
          the shared ``search_api.PipelineCache``.
install_artifact(): the frozen index's swap to a sealed IndexArtifact.

``fit(mesh=)`` runs the rounds on a (data × rep) mesh of ranks
(``launch/mesh.make_fit_mesh``), each rank on its rep rows, and gathers the
reps on every rank at the end.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import partition as PT
from repro_torch.core import query as Q
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
            verbose: bool = False, mesh=None, registry=None,
            log=None) -> FitStats:
        """x_train [N, d]; label_ids [N, k] (ANN: k exact neighbours; XML:
        padded label sets); label_mask [N, k] (1 for real labels);
        label_vecs [L, d] selects Def. 2 affinity (ANN mode). Numpy arrays
        or tensors.

        Runs ``cfg.rounds`` rounds of :class:`repro_torch.fit.engine.
        FitEngine` with one host sync a round (for the paper's "until
        re-assignments converge" stop), then ``build_index``. The index's
        params, optimizer state and assignment are updated in place. ``log``
        (anything with ``log(row, step=)``) gets one row a round: what
        :meth:`_record_fit_round` returns, which ``registry`` (a
        MetricRegistry) also gets as ``fit_*`` gauges and counters.

        ``mesh``: a (data × rep) DeviceMesh (``launch/mesh.make_fit_mesh``)
        runs the rounds across its ranks. Every rank calls ``fit`` with the
        same index (same cfg and seed) and data; each trains and
        re-partitions its rep rows, with the batch columns split over
        "data" (``FitEngine.make_sharded_fit_round``). At the end every rank
        gathers the R reps, so params, optimizer state and assign are whole
        on each, as the reference's global arrays are (a mesh fit replaces
        the index's assign and generator state at the end only, so ``log``
        sees them as they were at entry)."""
        cfg = self.cfg
        data = FitData.build(x_train, label_ids, label_mask, label_vecs,
                             n_labels=cfg.n_labels, chunk=cfg.affinity_chunk,
                             device=self.device)
        engine = FitEngine(cfg, self.scorer_cfg)
        state = FitState(params=self.params, opt_state=self.opt_state,
                         assign=self.assign, rng=self.rng, round_idx=0,
                         epoch_idx=0)
        if mesh is None:
            round_fn = engine.make_fit_round(data)
        else:
            state = engine.shard_state(state, mesh)
            round_fn = engine.make_sharded_fit_round(mesh, data, state)
        n = data.x.shape[0]
        stats = FitStats([], [], [], [], [])
        for rnd in range(cfg.rounds):
            idx, w = engine.round_batches(n, cfg.seed, rnd)
            t0 = time.perf_counter()
            state, met = round_fn(state, idx, w)
            met = {k: v.cpu() for k, v in met.items()}   # one host sync
            dt = time.perf_counter() - t0
            if mesh is None:        # a mesh rank holds its rep rows only
                self.assign, self.rng = state.assign, state.rng
            n_re = int(met["n_reassigned"])
            loss = float(met["loss"])
            lstd = float(met["load_std"])
            stats.round_idx.append(rnd)
            stats.n_reassigned.append(n_re)
            stats.load_std.append(lstd)
            stats.train_loss.append(loss)
            stats.epoch_loss.append([float(v) for v in met["epoch_loss"]])
            row = self._record_fit_round(rnd, met, dt, registry)
            if log is not None:
                log.log(row, step=rnd)
            if verbose:
                print(f"[irli] round {rnd}: loss={loss:.4f} "
                      f"reassigned={n_re} load_std={lstd:.2f}")
            if n_re == 0:
                break
        if mesh is not None:
            state = engine.gather_state(state, mesh)
        self.params, self.opt_state = state.params, state.opt_state
        self.assign, self.rng = state.assign, state.rng
        self.build_index()
        return stats

    def _record_fit_round(self, rnd: int, met: dict, seconds: float,
                          registry=None) -> dict:
        """One round's metrics as a flat row: loss, re-assignments and churn
        (re-assignments per (rep, label) slot), and the load-balance family
        (std / min / max / KL-vs-uniform, the paper's §4 balance metric).
        With a ``registry`` the row is mirrored as ``fit_*`` gauges, with
        the ``fit_rounds_total`` counter and ``fit_round_seconds``."""
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
        if registry is not None:
            registry.counter("fit_rounds_total").inc()
            registry.gauge("fit_round_seconds").set(seconds)
            for key, val in row.items():
                if key in ("round", "seconds"):
                    continue
                registry.gauge(f"fit_{key}" if not key.startswith("fit_")
                               else key).set(val)
        return row

    def build_index(self):
        max_load = int(self.cfg.max_load_slack
                       * max(1, self.cfg.n_labels // self.cfg.n_buckets))
        self.index = PT.build_inverted_index(self.assign, self.cfg.n_buckets,
                                             max_load)

    # -------------------------------------------------------------- query --
    def query(self, queries, m: int = 5, tau: int = 1):
        """The dense candidate set -> (cand_mask [Q, L] bool, freq [Q, L]
        f32, n_candidates [Q] int32), through ``query.query_index``."""
        if self.index is None:
            raise RuntimeError("fit() or build_index() first")
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        return Q.query_index(self.params, self.index, queries, m=m, tau=tau,
                             L=self.cfg.n_labels, loss_kind=self.cfg.loss)

    def search(self, queries, base, params: SA.SearchParams | None = None,
               *, cache: SA.PipelineCache | None = None, staged: bool = False,
               m=None, tau=None, k=None, metric=None, mode=None, topC=None):
        """Candidate generation + true-distance re-rank over ``base``: the
        raw fp32 [L, d] corpus or a QuantizedStore over it (pass
        ``SearchParams(store_dtype=...)`` to match).

        Typed path: ``search(queries, base, SearchParams(...))`` ->
        SearchResult with ids [Q, k] int32 (-1 pad), scores [Q, k] f32,
        n_candidates [Q] int32, epoch and the resolved mode. The pipeline
        comes from ``cache`` (default: ``search_api.DEFAULT_CACHE``).
        ``staged=True`` serves through the per-stage debug mode (each stage
        fenced and timed into the cache's registry under
        ``serve_stage_seconds{stage=...}``), bit-identical. The bare
        ``m=/tau=/k=/metric=/mode=/topC=`` kwargs are a deprecated shim
        returning the old ``(ids, n_candidates)`` tuple."""
        if self.index is None:
            raise RuntimeError("fit() or build_index() first")
        if params is None:
            params = SA.params_from_legacy_kwargs(
                "IRLIIndex.search", m=m, tau=tau, k=k, metric=metric,
                mode=mode, topC=topC)
            res = self._search_typed(queries, base, params, cache,
                                     staged=staged)
            return res.ids, res.n_candidates
        SA.check_params("IRLIIndex.search", params)
        if any(v is not None for v in (m, tau, k, metric, mode, topC)):
            raise TypeError("pass either SearchParams or legacy kwargs, "
                            "not both")
        return self._search_typed(queries, base, params, cache, staged=staged)

    def _search_typed(self, queries, base, params: SA.SearchParams,
                      cache: SA.PipelineCache | None, *,
                      staged: bool = False) -> SA.SearchResult:
        cache = cache if cache is not None else SA.DEFAULT_CACHE
        if isinstance(base, QuantizedStore):
            if base.device != self.device:
                raise ValueError(f"store on {base.device}, index on "
                                 f"{self.device}")
        else:
            base = torch.as_tensor(base, dtype=torch.float32,
                                   device=self.device)
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        return cache.search(params, self.params, self.index.members, base,
                            queries, epoch=self.epoch, staged=staged)

    # ----------------------------------------------------- artifact swap --
    def install_artifact(self, artifact) -> None:
        """Swap in a sealed :class:`repro_torch.artifact.IndexArtifact`.

        The frozen-index flavour of the swap: params, assignment and
        members are replaced wholesale and ``epoch`` jumps to the artifact
        version, so every later ``SearchResult.epoch`` names the artifact
        that produced it. Stale versions (``version <= self.epoch``) are
        rejected. Tombstoned rows are dropped from the rebuilt member
        matrix; the corpus is not stored here (searches keep passing
        ``base``). The artifact's tensors move to this index's device."""
        from repro_torch.artifact import rebuild_members
        cfg = self.cfg
        md = artifact.meta_dict
        for key, want in (("d", cfg.d), ("n_buckets", cfg.n_buckets),
                          ("n_reps", cfg.n_reps)):
            if key in md and int(md[key]) != int(want):
                raise ValueError(
                    f"artifact {key}={md[key]} != index {key}={want}")
        if int(artifact.version) <= int(self.epoch):
            raise ValueError(
                f"stale artifact: version {artifact.version} <= serving "
                f"epoch {self.epoch}")
        L = cfg.n_labels
        if int(artifact.n_total) < L:
            raise ValueError(
                f"artifact covers {artifact.n_total} labels < index "
                f"n_labels={L}")
        dev = self.device
        assign = artifact.assign[:, :L].to(dev, copy=True)
        max_load = int(artifact.members.shape[-1])
        members, load = rebuild_members(
            assign, artifact.tombstone[:L].to(dev), B=cfg.n_buckets,
            max_load=max_load)
        # copies (assign above too): a later fit() updates the index's
        # params and assign in place, and the sealed artifact must keep its
        # content
        self.params = {k: v.to(dev, copy=True)
                       for k, v in artifact.params.items()}
        self.assign = assign
        self.index = PT.InvertedIndex(members=members, load=load,
                                      max_load=max_load)
        self.epoch = int(artifact.version)

    def as_searcher(self, base, cache: SA.PipelineCache | None = None
                    ) -> SA.Searcher:
        """Bind this index to its corpus as a ``Searcher`` (one-arg
        ``search(queries, params)`` like every other backend)."""
        return SA.as_searcher(
            lambda q, p: self._search_typed(q, base, p, cache))
