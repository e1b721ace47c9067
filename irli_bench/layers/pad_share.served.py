"""pad_share.served: the share of the padded rows the server searched that
were padding (serve_pad_waste_total over requests plus padding) in the
measured window."""


def read(readings: dict):
    srv = readings.get("server")
    if not srv or not srv["requests"]:
        return None
    return 100.0 * srv["pad_waste"] / (srv["requests"] + srv["pad_waste"])
