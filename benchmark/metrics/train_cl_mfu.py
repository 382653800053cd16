"""Model operations of the traced XSimGCL epochs (``work_cl.
train_step_cl_model_flops``: LightGCN's count of each step's real edges and
triplets, plus the InfoNCE of its distinct users and items) over the traced
window's time, as a share of the card's dense bf16 peak."""

from benchmark.work_cl import train_step_cl_model_flops

UNIT = "%"
LAYER = "whole step"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    info = res.info
    rows = info.get("window_cl_rows")
    if res.trace is None or not rows or res.window_s <= 0:
        return None
    per_epoch = list(zip(info["edges_per_step"], info["real_per_step"]))
    shapes = per_epoch * info["epochs"]
    if len(shapes) != len(rows):
        return None
    flops = sum(train_step_cl_model_flops(e, r, info["negatives"], info["dim"],
                                          info["layers"], u, i)
                for (e, r), (u, i) in zip(shapes, rows))
    return 100.0 * flops / res.window_s / peaks.bf16_flops
