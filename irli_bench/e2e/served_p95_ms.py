"""served_p95_ms: the 95th percentile, by nearest rank, of every request
sent in the window, each timed from when it was due to its result. A
request that failed or never came lies beyond it; a tail that reaches one
reads as the latest an answer could have come (the window and the wait
after it)."""
from irli_bench.measure import nearest_rank


def read(readings: dict):
    lat = readings.get("latency_s")
    if not lat:
        return None
    return 1e3 * min(nearest_rank(lat, 0.95),
                     readings["window_s"] + readings["late_s"])
