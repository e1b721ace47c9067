"""idle_share: the share of the traced sub-window in which no operation ran
on the card (``idle_share.<cells>`` for each group of cells)."""


def read(readings: dict):
    tr = readings.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])
