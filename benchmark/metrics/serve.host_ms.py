"""Host time of one dispatch's call into the port: from the call of
``ServingIndex.batch_recommend`` to its return, before the copy of the
answers waits on the card (mean over the traced dispatches, ms)."""

UNIT = "ms"
LAYER = "serving/recommend.py::ServingIndex.batch_recommend (host side)"
SOURCE = "host_clock"
MOVES = "serve_p95_ms"


def read(res, peaks):
    host = res.info.get("host_ms")
    return sum(host) / len(host) if host else None
