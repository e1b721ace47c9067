"""batch_rows.served: the server's mean batch, requests over batches in the
measured window (its counters serve_requests_total and
serve_batches_total)."""


def read(readings: dict):
    srv = readings.get("server")
    if not srv or not srv["batches"]:
        return None
    return srv["requests"] / srv["batches"]
