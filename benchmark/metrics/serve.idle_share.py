"""Share of the traced serving window in which no operation ran on the card."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "serve_qps"


def read(res, peaks):
    if res.trace is None or "dispatches" not in res.info or res.window_s <= 0:
        return None
    return 100.0 * (1.0 - res.trace.busy_s / res.window_s)
