"""Host syncs per epoch of the XSimGCL cell: the port's ``host_sync``
counter inside its traced ``fullgraph.epoch`` spans. 1 is the epoch's
closing read of the mean loss: the step's distinct-row selection and its
InfoNCE then wait for the card nowhere."""

from benchmark import port_spans

UNIT = "count"
LAYER = "models/xsimgcl.py, ops/distinct.py, ops/cuda_infonce.py (host side)"
SOURCE = "program_counter"
MOVES = "train_pairs_per_s"


def read(res, peaks):
    st = port_spans.of_run(res, ("fullgraph.epoch",), "epochs")
    if st is None:
        return None
    return st.counted("host_sync") / len(st.outer)
