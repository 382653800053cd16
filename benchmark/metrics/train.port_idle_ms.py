"""Idle card time per epoch while the host is inside the port's epoch span
and not in its closing wait: the card's gaps between ops that overlap the
host's own work, lined up with the trace by the ``bench.epoch`` span
around each epoch (ms). The idle time during the wait is the card's own."""

from benchmark import port_spans

UNIT = "ms"
LAYER = "training epoch functions, host side with launch back-pressure: make_fullgraph_epoch_fn, make_epoch_fn"
SOURCE = "device_trace"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    st = port_spans.of_run(res, port_spans.EPOCH, "epochs")
    if st is None:
        return None
    idle = port_spans.idle_overlap_us(res, st, st.host_ns(), "bench.epoch")
    return None if idle is None else idle * 1e-3 / len(st.outer)
