"""Device time per step of the ops launched by the optimizer's update (clip
by global norm and Adam over both tables), told apart by the benchmark's
span around the epoch's update call (ms)."""

UNIT = "ms"
LAYER = "training/train.py::make_optimizer (clip + Adam)"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    steps = res.info.get("steps")
    if res.trace is None or not steps:
        return None
    s, count = res.trace.time_of(lambda op: op.annotation == "bench.optimizer")
    return s * 1e3 / steps if count else None
