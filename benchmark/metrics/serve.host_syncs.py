"""Blocking host-card waits per dispatch: the port's ``host_sync`` counter
inside its ``serving.batch_recommend`` spans (mean over the traced
dispatches)."""

from benchmark import port_spans

UNIT = "count"
LAYER = "serving/recommend.py::ServingIndex.batch_recommend (host side)"
SOURCE = "program_counter"
MOVES = "serve_p95_ms"


def read(res, peaks):
    st = port_spans.of_run(res, port_spans.DISPATCH, "dispatches")
    if st is None:
        return None
    return st.counted("host_sync") / len(st.outer)
