"""Scorer, partition, query pipeline, search API and the index; the
partitioning baselines and the IRLI vocabulary head."""
from repro_torch.core import baselines, vocab_head  # noqa: F401
