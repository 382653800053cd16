"""Host time per step in the port's XSimGCL spans (``xsimgcl.perturb``,
``xsimgcl.distinct``, ``xsimgcl.infonce``, ``xsimgcl.infonce_bwd``) inside
the traced ``fullgraph.epoch`` spans (ms): the host's work of enqueueing the
noise, the distinct rows and the InfoNCE, with any launch back-pressure."""

from benchmark import port_spans

UNIT = "ms"
LAYER = "models/xsimgcl.py, ops/distinct.py, ops/cuda_infonce.py (host side)"
SOURCE = "program_span"
MOVES = "train_pairs_per_s"
SPANS = ("xsimgcl.perturb", "xsimgcl.distinct", "xsimgcl.infonce", "xsimgcl.infonce_bwd")


def read(res, peaks):
    st = port_spans.of_run(res, ("fullgraph.epoch",), "epochs")
    if st is None:
        return None
    host = sum(st.total_ns(name) for name in SPANS)
    if not host:
        return None
    steps_per_epoch = res.info["steps"] / res.info["epochs"]
    return host * 1e-6 / (steps_per_epoch * len(st.outer))
