"""Candidate lists shared by the kchoice tests on the CPU
(test_torch_fit.py) and on the card (test_torch_cuda.py). Imports no jax:
the card's machine has none."""
import numpy as np


def candidate_lists(rng, kind, G, L, K, B):
    """[G, L, K] int32 bucket ids < B drawn from the numpy generator rng:
    "same" one K-list a rep for every label (the worst case: every label
    waits on the one before); "zipf" drawn without replacement with
    Zipf(1.0) popularity; any other kind K distinct uniform ids a label."""
    if kind == "same":
        topk = np.stack([np.broadcast_to(rng.choice(B, K, replace=False),
                                         (L, K)) for _ in range(G)])
    elif kind == "zipf":
        logp = -np.log(np.arange(1, B + 1))
        topk = np.stack([np.argsort(-(logp + rng.gumbel(size=(L, B))),
                                    axis=1)[:, :K] for _ in range(G)])
    else:
        topk = np.stack([[rng.choice(B, K, replace=False) for _ in range(L)]
                         for _ in range(G)])
    return np.ascontiguousarray(topk, np.int32)
