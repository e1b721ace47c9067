"""The inputs of a run, made on the device from ``--seed``: the corpus, the
queries, the scorer's weights and the partition. The same seed gives the
same inputs; every seed gives the same sizes. Both sides (the program and
the plain reference) are handed these tensors; neither makes its own.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

#: the 2-universal hash's prime (paper §3.1): h(x) = ((a·x + b) mod p) mod B
HASH_PRIME = 2_147_483_647


def subseed(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of a run: the run's seed and the
    stream's keys, hashed, so that streams never share draws."""
    text = ":".join(str(k) for k in (seed,) + keys).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *keys))


def unit_rows(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """n unit-norm Gaussian rows [n, d] f32 (the deep1b recipe)."""
    x = torch.randn((n, d), generator=gen, device=gen.device)
    return x.div_(x.norm(dim=1, keepdim=True))


def noisy_copies(gen: torch.Generator, corpus: torch.Tensor, n: int,
                 noise: float) -> torch.Tensor:
    """n queries [n, d]: corpus rows drawn uniformly, plus Gaussian noise of
    scale ``noise``, renormalised to unit length."""
    src = torch.randint(0, corpus.shape[0], (n,), generator=gen,
                        device=gen.device)
    q = corpus[src] + noise * torch.randn((n, corpus.shape[1]),
                                          generator=gen, device=gen.device)
    return q.div_(q.norm(dim=1, keepdim=True))


def clustered_nonneg(gen: torch.Generator, n: int, centers: torch.Tensor,
                     weights: torch.Tensor, spread: float) -> torch.Tensor:
    """n non-negative rows [n, d] (the SIFT-like recipe): a cluster drawn
    by ``weights`` (a power law), its centre plus Gaussian noise of scale
    ``spread``, clipped at 0. Made in blocks of 2^20 rows."""
    out = torch.empty((n, centers.shape[1]), device=gen.device)
    for s in range(0, n, 1 << 20):
        m = min(1 << 20, n - s)
        c = torch.multinomial(weights, m, replacement=True, generator=gen)
        out[s:s + m] = (centers[c] + spread * torch.randn(
            (m, centers.shape[1]), generator=gen, device=gen.device)
        ).clamp_min_(0.0)
    return out


def sift_like(gen: torch.Generator, n_base: int, n_queries: int, d: int,
              n_clusters: int, scale: float, spread: float, zipf: float):
    """(corpus [n_base, d], queries [n_queries, d]) from one clustered,
    non-negative distribution; the queries are fresh draws, not corpus
    rows (as ann-benchmarks' held-out queries)."""
    centers = scale * torch.rand((n_clusters, d), generator=gen,
                                 device=gen.device).pow_(2)
    weights = torch.arange(1, n_clusters + 1, device=gen.device,
                           dtype=torch.float32).pow_(-zipf)
    corpus = clustered_nonneg(gen, n_base, centers, weights, spread)
    queries = clustered_nonneg(gen, n_queries, centers, weights, spread)
    return corpus, queries


def scorer_weights(gen: torch.Generator, R: int, d: int, H: int,
                   B: int) -> dict:
    """The R stacked scorers' weights: w1 [R, d, H] and w2 [R, H, B]
    normal, scaled by 1/sqrt(fan-in); zero biases. fp32, on the device, in
    two large draws."""
    dev = gen.device
    return {
        "w1": torch.randn((R, d, H), generator=gen, device=dev).mul_(d ** -.5),
        "b1": torch.zeros((R, H), device=dev),
        "w2": torch.randn((R, H, B), generator=gen, device=dev).mul_(H ** -.5),
        "b2": torch.zeros((R, B), device=dev),
    }


def hash_partition(seed: int, L: int, B: int, R: int, max_load: int,
                   device) -> torch.Tensor:
    """A seeded 2-universal hash partition, assign [R, L] int32: per rep,
    a in [1, p), b in [0, p) from the seed and h(x) = ((a·x + b) mod p)
    mod B, computed on the device in int64. A rep whose fullest bucket
    would pass ``max_load`` (an a whose multiples fall into few residues of
    B, about one rep in 200) draws again from the same stream, so every
    seed gives a partition of the same member width."""
    rng = np.random.default_rng(subseed(seed, "hash"))
    x = torch.arange(L, device=device, dtype=torch.int64)
    out = torch.empty((R, L), dtype=torch.int32, device=device)
    for r in range(R):
        while True:
            a, b = (int(v) for v in rng.integers((1, 0), HASH_PRIME, 2))
            h = (a * x + b) % HASH_PRIME % B
            if int(torch.bincount(h, minlength=B).max()) <= max_load:
                break
        out[r] = h.to(torch.int32)
    return out


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """Every input a cell of configuration ``cfg`` needs, from ``seed``:
    corpus [L, D], the query pool of the configuration's kind, the scorer
    weights and the partition."""
    gen = generator(device, seed, "inputs")
    L, D = cfg["n_labels"], cfg["d"]
    data = cfg["data"]
    if data["kind"] == "unit_noisy":
        corpus = unit_rows(gen, L, D)
        pool = None
    elif data["kind"] == "sift_like":
        corpus, pool = sift_like(gen, L, data["n_queries"], D,
                                 data["n_clusters"], data["scale"],
                                 data["spread"], data["zipf"])
    else:
        raise ValueError(f"unknown data kind {data['kind']!r}")
    weights = scorer_weights(gen, cfg["n_reps"], D, cfg["d_hidden"],
                             cfg["n_buckets"])
    B = cfg["n_buckets"]
    assign = hash_partition(seed, L, B, cfg["n_reps"],
                            int(cfg["max_load_slack"] * max(1, L // B)),
                            device)
    return {"corpus": corpus, "pool": pool, "weights": weights,
            "assign": assign}


def query_batch(cfg: dict, inputs: dict, seed: int, stream: str, i: int,
                n: int) -> torch.Tensor:
    """Batch ``i`` of ``n`` queries of one stream: noisy copies of corpus
    rows (deep1b), or the configuration's fixed query set (ann-benchmarks'
    10,000), drawn the same for every call."""
    data = cfg["data"]
    if data["kind"] == "unit_noisy":
        gen = generator(inputs["corpus"].device, seed, stream, i)
        return noisy_copies(gen, inputs["corpus"], n, data["noise"])
    pool = inputs["pool"]
    if n > pool.shape[0]:
        raise ValueError(f"a batch of {n} from a set of {pool.shape[0]}")
    return pool[:n]
