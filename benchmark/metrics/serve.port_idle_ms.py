"""Idle card time per dispatch while the host is inside the port's
``serving.batch_recommend``: the card's gaps between ops that overlap the
port's spans, lined up with the trace by the ``bench.dispatch`` span around
each (ms)."""

from benchmark import port_spans

UNIT = "ms"
LAYER = "serving/recommend.py::ServingIndex.batch_recommend (host side)"
SOURCE = "device_trace"
MOVES = "serve_qps"


def read(res, peaks):
    st = port_spans.of_run(res, port_spans.DISPATCH, "dispatches")
    if st is None:
        return None
    idle = port_spans.idle_overlap_us(res, st, [(o.t0_ns, o.t1_ns) for o in st.outer],
                                      "bench.dispatch")
    return None if idle is None else idle * 1e-3 / len(st.outer)
