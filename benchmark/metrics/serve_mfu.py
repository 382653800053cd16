"""Model operations of the traced dispatches (2·Q·N·d each) over the traced
window's time, as a share of the card's dense bf16 peak."""

from benchmark.work import dispatch_model_flops

UNIT = "%"
LAYER = "whole dispatch"
SOURCE = "device_trace"
MOVES = "serve_qps"


def read(res, peaks):
    info = res.info
    if res.trace is None or "dispatches" not in info or res.window_s <= 0:
        return None
    flops = dispatch_model_flops(info["queries"], info["items"], info["dim"]) * info["dispatches"]
    return 100.0 * flops / res.window_s / peaks.bf16_flops
