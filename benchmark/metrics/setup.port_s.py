"""Host seconds of the port's own set-up builds in this run (the serving
index, or the full-graph training set with its hybrid blocks and ELL), from
the benchmark's spans around them."""

UNIT = "s"
LAYER = "port set-up builds"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(res, peaks):
    s = res.info.get("setup_port_s")
    return s if s else None
