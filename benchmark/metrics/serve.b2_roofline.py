"""The masked score op's share of its roofline: the least time of its work
(``work.masked_score_work``: 2·Q·N·d operations at the bf16 peak, or its
compulsory bytes at the memory peak, whichever is longer) over the device
time of the kernels that implement it (``kernels/masked_score.json``)."""

from benchmark.work import bound_s, kernel_map, masked_score_work, matches

UNIT = "%"
LAYER = "csrc/score_chunkmax.cu (B2)"
SOURCE = "device_trace"
MOVES = "serve_qps"


def read(res, peaks):
    info = res.info
    if res.trace is None or "queries" not in info:
        return None
    names = kernel_map("masked_score")["kernels"]
    s, count = res.trace.time_of(lambda op: matches(op.name, names))
    if not count:
        return None
    flops, byts = masked_score_work(info["queries"], info["items"], info["dim"])
    return 100.0 * bound_s(flops, byts, peaks) * count / s
