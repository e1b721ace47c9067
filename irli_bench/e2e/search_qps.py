"""search_qps: the queries a closed loop completed in the measured window
over the window's seconds, all the work over all the time."""


def read(readings: dict):
    if "completed" not in readings or readings["window_s"] <= 0:
        return None
    return readings["completed"] / readings["window_s"]
