"""Model operations of the traced epochs (``work.train_step_model_flops`` of
each step's real edges and triplets) over the traced window's time, as a
share of the card's dense bf16 peak."""

from benchmark.work import train_step_model_flops

UNIT = "%"
LAYER = "whole step"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    info = res.info
    if res.trace is None or not info.get("epochs") or res.window_s <= 0:
        return None
    flops = info["epochs"] * sum(
        train_step_model_flops(e, r, info["negatives"], info["dim"], info["layers"])
        for e, r in zip(info["edges_per_step"], info["real_per_step"]))
    return 100.0 * flops / res.window_s / peaks.bf16_flops
