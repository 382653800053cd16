"""The fused InfoNCE's share of its roofline: the model's operations of the
traced steps' InfoNCEs (``work_cl.infonce_flops`` of each step's distinct
users and items, which the traffic counts at set-up) at the dense bf16
peak, over the device time of the kernels that implement the op
(``kernels/infonce.json``)."""

from benchmark.work import kernel_map, matches
from benchmark.work_cl import infonce_flops

UNIT = "%"
LAYER = "ops/cuda_infonce.py::infonce -> csrc/infonce.cu"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    rows = res.info.get("window_cl_rows")
    if res.trace is None or not rows:
        return None
    names = kernel_map("infonce")["kernels"]
    s, count = res.trace.time_of(lambda op: matches(op.name, names))
    if not count:
        return None
    d = res.info["dim"]
    flops = sum(infonce_flops(u, d) + infonce_flops(i, d) for u, i in rows)
    return 100.0 * flops / peaks.bf16_flops / s
