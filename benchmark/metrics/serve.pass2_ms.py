"""Device time per dispatch of every op the dispatch launched other than the
masked score op (B2): the mask row gather, the normalisation and casts, and
pass 2's chunk ranking and selection (ms)."""

from benchmark.work import kernel_map, matches

UNIT = "ms"
LAYER = "ops/cuda_mips.py::mips_topk_fused pass 2"
SOURCE = "device_trace"
MOVES = "serve_qps"


def read(res, peaks):
    n = res.info.get("dispatches")
    if res.trace is None or not n:
        return None
    b2 = kernel_map("masked_score")["kernels"]
    s, count = res.trace.time_of(
        lambda op: op.annotation == "bench.dispatch" and not matches(op.name, b2))
    return s * 1e3 / n if count else None
