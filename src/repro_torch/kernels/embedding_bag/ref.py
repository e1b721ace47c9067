"""Plain PyTorch version of the EmbeddingBag kernel: a torch copy of the
reference's ``embedding_bag_ref`` (take + masked weighted sum).

ids [N, P] (a negative id is a pad), weights [N, P], table [V, D] ->
[N, D]: each row the weighted sum of its bag's table rows, in fp32, cast
to the table's dtype. Holds the gathered [N, P, D] rows in fp32.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(ids, weights, table):
    safe = ids.clamp_min(0).long()
    rows = table[safe].float()                                  # [N, P, D]
    w = torch.where(ids >= 0, weights, torch.zeros_like(weights)).float()
    return torch.einsum("npd,np->nd", rows, w).to(table.dtype)
