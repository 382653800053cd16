"""Host time per step in the port's epoch span (``fullgraph.epoch`` or
``train.epoch``) less the closing wait span inside it, where the host blocks
until the card ends the epoch (mean over the traced epochs, ms).

It is the host's work of enqueueing the steps together with the time it is
blocked in launch calls while the launch queue is full (launch
back-pressure). So while the card paces the epoch it is bounded by the
card's time a step, and a faster kernel lowers it as well; it falls clearly
below the card's time a step only where the host has time to spare."""

from benchmark import port_spans

UNIT = "ms"
LAYER = "training epoch functions, host side with launch back-pressure: make_fullgraph_epoch_fn, make_epoch_fn"
SOURCE = "program_span"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    st = port_spans.of_run(res, port_spans.EPOCH, "epochs")
    if st is None:
        return None
    steps_per_epoch = res.info["steps"] / res.info["epochs"]
    host = sum(b - a for a, b in st.host_ns())
    return host * 1e-6 / (steps_per_epoch * len(st.outer))
