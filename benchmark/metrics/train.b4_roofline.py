"""One remainder hop's compulsory bytes (``work.remainder_hop_bytes``) at the
memory peak, times the hops the trace holds, over the device time of the
kernels that implement the hop (``kernels/remainder_hop.json``)."""

from benchmark.work import kernel_map, matches, remainder_hop_bytes

UNIT = "%"
LAYER = "ops/cuda_spmm.py::spmm_ell_cuda -> csrc/ell_spmm.cu (B4)"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    rem = res.info.get("remainder")
    if res.trace is None or not rem:
        return None
    names = kernel_map("remainder_hop")["kernels"]
    s, count = res.trace.time_of(lambda op: matches(op.name, names))
    if not count:
        return None
    hop = remainder_hop_bytes(rem["edges"], rem["rows"], rem["num_src"], rem["num_nodes"],
                              res.info["dim"])
    return 100.0 * hop * count / peaks.hbm_bytes_s / s
