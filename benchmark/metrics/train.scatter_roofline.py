"""The row sums' share of their roofline: the compulsory bytes of the
traced steps' sums (``work.row_sums_bytes`` over the step shapes the
traffic reports: the triplet rows' gradients, and in the full-node cell the
propagation's sums too) at the memory peak, over the device time of the
kernels that implement them (``kernels/row_sums.json``)."""

from benchmark.work import kernel_map, matches, row_sums_bytes

UNIT = "%"
LAYER = "ops/cuda_scatter.py::sorted_index_add -> csrc/sorted_index_add.cu"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    info = res.info
    if res.trace is None or not info.get("epochs") or "row_sums" not in info:
        return None
    names = kernel_map("row_sums")["kernels"]
    s, count = res.trace.time_of(lambda op: matches(op.name, names))
    if not count:
        return None
    byts = info["epochs"] * sum(row_sums_bytes(e, r, info["dim"], n)
                                for e, r, n in info["row_sums"])
    return 100.0 * byts / peaks.hbm_bytes_s / s
