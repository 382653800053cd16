"""Share of the traced training window in which no operation ran on the card."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    if res.trace is None or not res.info.get("epochs") or res.window_s <= 0:
        return None
    return 100.0 * (1.0 - res.trace.busy_s / res.window_s)
