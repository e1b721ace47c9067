"""repro_torch.serve — the micro-batching server (port of ``repro/serve``)."""
