"""setup_s: process start to the end of warm-up: imports, inputs, the
index, and every shape the cell uses warmed."""


def read(readings: dict):
    return readings.get("setup_s")
