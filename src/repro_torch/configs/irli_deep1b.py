"""irli-deep1b — the paper's own production configuration (§5.3): 100M
(padded to 2^27 ≈ 134M) 96-d vectors, B=20000 buckets, R=32 scorer
repetitions, hidden 1024. Port of ``repro/configs/irli_deep1b.py``, value
for value.

``rules()`` is the reference's ``_rules`` (``:93-100``): the R axis over
"model". ``get_arch`` holds the reference's two cells:

  train_scorers   the scorer's BCE train step on 32k-query batches
                  (``launch/steps.build_irli_train_step``)
  serve_query     the sharded multiprobe search, 4096 queries, int8
                  tiered store (``launch/steps.build_irli_serve``)

The serve cell's ``params(mesh)`` declares the global arrays, a leading
shard axis of the mesh's size over every mesh axis; each rank's step
takes its own shard, that axis dropped. ``fit_config()`` carries the
FitEngine hyperparameters: full size for a deployment, ``reduced=True``
for the CPU tests.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.network import ScorerConfig

D = 96
B_BUCKETS = 20000
R = 32
HIDDEN = 1024
N_CORPUS = 1 << 27           # 134,217,728 (assigned 100M padded to 2^27)
K_NEIGH = 100                 # paper: 100 exact NNs as labels
MAX_LOAD = 2 * (N_CORPUS // (256 * B_BUCKETS))  # per-shard bucket load bound
# quantized tiered store: fp32 base vectors are 2^27·96·4 ≈ 51.5 GB, int8
# block-scaled codes + per-32-block scales about 3.7x smaller
STORE_DTYPE = "int8"
STORE_BLOCK = 32
N_SCALE_BLOCKS = D // STORE_BLOCK

SCORER_CFG = ScorerConfig(d_in=D, d_hidden=HIDDEN, n_buckets=B_BUCKETS,
                          n_reps=R, loss="softmax_bce")

# fit-engine hyperparameters: the paper's Alg. 1 alternation
FIT_K = 10                    # power-of-K re-partition choices
FIT_ROUNDS = 5
FIT_EPOCHS_PER_ROUND = 5
FIT_BATCH = 1 << 15           # matches the train_scorers cell
FIT_AFFINITY_CHUNK = 1 << 16  # label-chunk width of the streaming top-K


def rules():
    """The scorer's sharding rules: the R axis of w1 [R, d, H], b1 [R, H],
    w2 [R, H, B] and b2 [R, B] over "model"."""
    from repro_torch.models.module import ShardRules
    return ShardRules([
        (r"w1", ("model", None, None)),
        (r"b1", ("model", None)),
        (r"w2", ("model", None, None)),
        (r"b2", ("model", None)),
    ])


def fit_config(*, reduced: bool = False):
    """The IRLIConfig of a full fit; ``reduced=True`` shrinks every shape
    for the CPU tests while keeping the same code paths."""
    from repro_torch.core.index import IRLIConfig
    if reduced:
        return IRLIConfig(d=16, n_labels=500, n_buckets=32, n_reps=4,
                          d_hidden=32, K=4, rounds=FIT_ROUNDS,
                          epochs_per_round=2, batch_size=128, lr=2e-3,
                          affinity_chunk=128, seed=0)
    return IRLIConfig(d=D, n_labels=N_CORPUS, n_buckets=B_BUCKETS, n_reps=R,
                      d_hidden=HIDDEN, K=FIT_K, rounds=FIT_ROUNDS,
                      epochs_per_round=FIT_EPOCHS_PER_ROUND,
                      batch_size=FIT_BATCH, lr=1e-3,
                      affinity_chunk=FIT_AFFINITY_CHUNK, seed=0)


def fit_affinity_bytes(chunk: int = FIT_AFFINITY_CHUNK) -> dict:
    """Byte accounting of the re-partition affinity at paper scale: the
    dense [R, L, B] table against the streaming reducer's live set (one
    [R, chunk, B] block + the running [R, L, K] carry)."""
    dense = R * N_CORPUS * B_BUCKETS * 4
    streaming = R * chunk * B_BUCKETS * 4 + R * N_CORPUS * FIT_K * (4 + 4)
    return {"dense_RLB": dense, "streaming": streaming,
            "ratio": dense / streaming}


def serve_store_bytes(n_shards: int) -> dict:
    """Per-shard byte accounting of the serve cell's vector payload."""
    l_loc = N_CORPUS // n_shards
    return {
        "l_loc": l_loc,
        "fp32_per_shard": l_loc * D * 4,
        "int8_per_shard": l_loc * D * 1 + l_loc * N_SCALE_BLOCKS * 4,
        "members_per_shard": R * B_BUCKETS
        * (2 * max(1, l_loc // B_BUCKETS)) * 4,
    }


def _abstract_params():
    from repro_torch.configs.base import abstract
    from repro_torch.core.network import scorer_init
    return abstract(lambda: scorer_init(
        SCORER_CFG, torch.Generator(device="cpu").manual_seed(0)))


def _train_cell():
    from repro_torch.configs.base import CellDef, dp, sds
    from repro_torch.launch import steps as S
    # 32k queries a step: the BCE targets are [R, batch, B], streamed
    # minibatches as the paper trains
    BATCH = 1 << 15

    def inputs(mesh):
        return {"x": sds((BATCH, D)),
                "label_ids": sds((BATCH, K_NEIGH), torch.int32),
                "label_mask": sds((BATCH, K_NEIGH)),
                "assign": sds((R, N_CORPUS), torch.int32)}

    def in_specs(mesh):
        ax = dp(mesh)
        return {"x": (ax, None), "label_ids": (ax, None),
                "label_mask": (ax, None),
                "assign": ("model", ("data",))}

    return CellDef(
        kind="train", inputs=inputs, in_specs=in_specs,
        step=lambda: S.build_irli_train_step(SCORER_CFG, B_BUCKETS)[0])


def _mesh_size(mesh) -> int:
    from repro_torch.models.module import mesh_sizes
    return math.prod(mesh_sizes(mesh).values())


def _serve_cell():
    from repro_torch.configs.base import CellDef, sds
    from repro_torch.launch import steps as S
    from repro_torch.models.module import map_with_paths
    QBATCH = 4096

    def params_for(mesh):
        n_shards = _mesh_size(mesh)
        l_loc = N_CORPUS // n_shards
        max_load = 2 * max(1, l_loc // B_BUCKETS)
        return {
            "scorer": _abstract_params(),
            "members": sds((n_shards, R, B_BUCKETS, max_load), torch.int32),
            # the int8 tiered store is the declared vector payload: no
            # fp32 base array exists anywhere in the serve cell
            "base_codes": sds((n_shards, l_loc, D), torch.int8),
            "base_scales": sds((n_shards, l_loc, N_SCALE_BLOCKS)),
        }

    def param_specs(mesh, params_sds):
        axes = tuple(mesh.mesh_dim_names)
        return {
            "scorer": map_with_paths(lambda p, _: (), params_sds["scorer"]),
            "members": (axes, None, None, None),
            "base_codes": (axes, None, None),
            "base_scales": (axes, None, None),
        }

    return CellDef(
        kind="serve",
        inputs=lambda mesh: {"queries": sds((QBATCH, D))},
        in_specs=lambda mesh: {"queries": ()},
        params=params_for, param_specs=param_specs,
        step=lambda mesh: S.build_irli_serve(
            mesh, m=5, tau=2, k=10, store_dtype=STORE_DTYPE,
            store_block=STORE_BLOCK),
        step_with_mesh=True,
        note="every chip = one paper node; sorted-frequency candidate path; "
             "int8 block-scaled store + fp32 refine of the top-k' "
             "survivors; single [Q,P*k] all_gather merge")


def get_arch():
    from repro_torch.configs.base import ArchDef
    return ArchDef(
        name="irli-deep1b", family="irli",
        abstract_params=_abstract_params, rules=rules,
        cells={"train_scorers": _train_cell(), "serve_query": _serve_cell()},
        opt="adamw_nomaster",
        notes="the paper's own 100M-point distributed config (§5.3)")
