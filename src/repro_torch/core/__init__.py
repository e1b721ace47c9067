"""Scorer, partition, query pipeline, search API and the index."""
