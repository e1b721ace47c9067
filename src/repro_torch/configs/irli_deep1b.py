"""irli-deep1b — the paper's own production configuration (§5.3): 100M
(padded to 2^27 ≈ 134M) 96-d vectors, B=20000 buckets, R=32 scorer
repetitions, hidden 1024. Port of ``repro/configs/irli_deep1b.py``'s
constants and functions (``:23-79``, ``:138-151``), value for value.

``rules()`` is the reference's ``_rules`` (``:93-100``): the R axis over
"model". The reference's two cells (``train_scorers``, ``serve_query``)
are ``CellDef``/``ArchDef`` mesh machinery and wait for ``dryrun``; the
``serve_query`` cell's step is ``launch/steps.build_irli_serve``, which is
ported. ``fit_config()`` carries the FitEngine hyperparameters: full size
for a deployment, ``reduced=True`` for the CPU tests.
"""
from __future__ import annotations

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
