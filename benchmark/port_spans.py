"""The port's own spans and counters, lined up with the reduced device trace,
for the per-layer metrics that read them.

While a profiler records, the port keeps a record of each span and each
counter event in memory (``utils/observability.py`` of the port:
``span_records()``, each record ``(name, t0_ns, t1_ns, wait, n)`` on the Unix
clock). A reader takes the last N outer spans of the traced stretch (N the
``dispatches`` or ``epochs`` of ``res.info``) and every record inside them.

The reduced trace (``trace.py``) keeps the benchmark's spans on the trace's
own clock and not its base time, so the records are shifted onto it by the
benchmark's span around each outer port span (``bench.dispatch``,
``bench.epoch``): a port span starts a few µs after it, and the least of
those differences is the shift (the trace's base plus that residual). The
card's idle intervals are the gaps between the trace's device ops, as
``Trace.idle_gaps`` finds them.

A port older than these records has no ``span_records``: there the metrics
that read them are left out of the result line, with a line on stderr
(:func:`_leave_out_where_the_port_keeps_none`). Where the port keeps records
but recorded no outer span, a reader returns None and the traced run gives
no result, as for any other metric.
"""

from __future__ import annotations

import bisect
import importlib
import sys
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

from benchmark import harness

PORT_OBSERVABILITY = "movie_recommender_system_with_gnns_tpu_torch.utils.observability"
#: the per-layer metrics that read the port's records
METRICS = ("serve.ids_ms", "serve.host_syncs", "serve.port_idle_ms", "train.host_ms",
           "train.port_idle_ms")
#: the port's outer span of a dispatch, and of an epoch of either trainer
DISPATCH = ("serving.batch_recommend",)
EPOCH = ("fullgraph.epoch", "train.epoch")

Interval = Tuple[float, float]


def port_keeps_records() -> bool:
    """Whether the port's observability module has ``span_records``."""
    return hasattr(importlib.import_module(PORT_OBSERVABILITY), "span_records")


def port_records() -> Optional[list]:
    """The port's records, oldest first; None where the port keeps none."""
    if not port_keeps_records():
        return None
    return list(importlib.import_module(PORT_OBSERVABILITY).span_records())


class Stretch(NamedTuple):
    """The last N outer spans, by start, and the records inside each."""

    outer: list
    inside: List[list]

    def total_ns(self, name: str) -> int:
        """Host ns in the spans named ``name`` inside the outer spans."""
        return sum(r.t1_ns - r.t0_ns for rs in self.inside for r in rs
                   if r.name == name and not r.n)

    def counted(self, name: str) -> int:
        """What the counter ``name`` counted inside the outer spans."""
        return sum(r.n for rs in self.inside for r in rs if r.name == name)

    def host_ns(self) -> List[Tuple[int, int]]:
        """Each outer span's time less the wait spans inside it, as
        intervals of the Unix clock (ns)."""
        out = []
        for o, rs in zip(self.outer, self.inside):
            holes = sorted((r.t0_ns, r.t1_ns) for r in rs if r.wait and not r.n)
            out += subtract((o.t0_ns, o.t1_ns), holes)
        return out


def stretch(records: Sequence, outer_names: Iterable[str], n: int) -> Optional[Stretch]:
    """The last ``n`` spans named in ``outer_names`` and the records inside
    each; None where there is none."""
    names = set(outer_names)
    outer = sorted((r for r in records if r.name in names and not r.n),
                   key=lambda r: r.t0_ns)[-n:] if n > 0 else []
    if not outer:
        return None
    starts = [o.t0_ns for o in outer]
    inside: List[list] = [[] for _ in outer]
    for r in records:
        i = bisect.bisect_right(starts, r.t0_ns) - 1
        if i >= 0 and r is not outer[i] and r.t1_ns <= outer[i].t1_ns:
            inside[i].append(r)
    return Stretch(outer, inside)


def of_run(res, outer_names: Iterable[str], count_key: str) -> Optional[Stretch]:
    """The traced run's stretch: the last ``res.info[count_key]`` outer
    spans of the port's records."""
    records = port_records()
    n = res.info.get(count_key) or 0
    return stretch(records, outer_names, n) if records else None


def shift_ns(outer: Sequence, trace, bench_span: str) -> Optional[int]:
    """Unix ns less trace ns: the least difference between each outer port
    span's start and the start of the benchmark span around it (paired from
    the end, one each)."""
    bench = sorted(s.start_us for s in trace.spans if s.name == bench_span)
    m = min(len(bench), len(outer))
    if not m:
        return None
    return min(o.t0_ns - round(b * 1e3) for o, b in zip(outer[-m:], bench[-m:]))


def idle_intervals(trace) -> List[Interval]:
    """The gaps between the trace's device ops (µs), as ``Trace.idle_gaps``
    finds them, in order."""
    iv = sorted((op.start_us, op.start_us + op.dur_us) for op in trace.ops)
    gaps: List[Interval] = []
    if not iv:
        return gaps
    end = iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    return gaps


def subtract(span: Tuple[int, int], holes: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """``span`` less the sorted ``holes`` (as intervals)."""
    out, cur = [], span[0]
    for s, e in holes:
        if s > cur:
            out.append((cur, min(s, span[1])))
        cur = max(cur, e)
    if cur < span[1]:
        out.append((cur, span[1]))
    return [iv for iv in out if iv[1] > iv[0]]


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two lists of disjoint, sorted
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_overlap_us(res, st: Stretch, host_ns: List[Tuple[int, int]],
                    bench_span: str) -> Optional[float]:
    """Idle card µs of the traced run inside the host intervals ``host_ns``
    (Unix ns, sorted), shifted onto the trace by :func:`shift_ns`."""
    if res.trace is None:
        return None
    shift = shift_ns(st.outer, res.trace, bench_span)
    if shift is None:
        return None
    host = [((a - shift) / 1e3, (b - shift) / 1e3) for a, b in host_ns]
    return overlap(host, idle_intervals(res.trace))


def _leave_out_where_the_port_keeps_none() -> None:
    """A port with no ``span_records`` cannot give these metrics: leave them
    out of each cell's list, and say so on stderr, so that its traced run's
    line goes without them rather than fail. A port that has it is held to
    them as to any other metric. ``harness.read_per_layer`` loads the
    readers, and with them this module, before it asks for a cell's list."""
    names = harness._per_layer_names
    if getattr(names, "port_spans", False):
        return

    def per_layer_names(cell, e2e, root):
        out = names(cell, e2e, root)
        if port_keeps_records():
            return out
        left = [m for m in out if m in METRICS]
        if left:
            print(f"port_spans: {PORT_OBSERVABILITY} has no span_records; "
                  f"{', '.join(left)} left out of {cell}", file=sys.stderr)
        return [m for m in out if m not in METRICS]

    per_layer_names.port_spans = True
    harness._per_layer_names = per_layer_names


_leave_out_where_the_port_keeps_none()
