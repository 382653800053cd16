"""Host time per dispatch in the port's ``serving.ids`` span: the users'
ids converted and range-checked, and their two blocking copies onto the card
(mean over the traced dispatches, ms)."""

from benchmark import port_spans

UNIT = "ms"
LAYER = "serving/recommend.py::ServingIndex.batch_recommend (host side)"
SOURCE = "program_span"
MOVES = "serve_p95_ms"


def read(res, peaks):
    st = port_spans.of_run(res, port_spans.DISPATCH, "dispatches")
    if st is None:
        return None
    return st.total_ns("serving.ids") * 1e-6 / len(st.outer)
