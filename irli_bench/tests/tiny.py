"""Each cell of the benchmark cut to a size the CPU runs in seconds: the
same files, widths and counts shrunk in place."""
from __future__ import annotations

from irli_bench import harness

#: the configuration's widths at the tiny size
CONFIG = dict(d=32, n_labels=6000, n_buckets=64, n_reps=4, d_hidden=64,
              store_block=16)
#: each cell's traffic at the tiny size
TRAFFIC = {
    "deep1b-batch": dict(queries_per_call=256),
    "sift1m-batch": dict(queries_per_call=500),
    "deep1b-served": dict(rate_per_s=40.0, max_batch=64, check_requests=64),
}


def cell(name: str) -> dict:
    """The cell ``name`` from its files, cut to the tiny size."""
    c = harness.load_cell(name)
    c["config"].update(CONFIG)
    if c["config"]["data"]["kind"] == "sift_like":
        c["config"]["data"].update(n_queries=500, n_clusters=30)
    c["traffic"].update(TRAFFIC[name])
    return c
