"""gen_lag_p95_ms.served: how late the load generator sent its requests,
the 95th percentile of (sent - due) over the window, by nearest rank."""
from irli_bench.measure import nearest_rank


def read(readings: dict):
    lag = readings.get("gen_lag_s")
    if not lag:
        return None
    return 1e3 * nearest_rank(lag, 0.95)
