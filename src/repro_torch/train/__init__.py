"""The fault-tolerant trainer and elastic restore."""
