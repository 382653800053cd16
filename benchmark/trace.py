"""The device trace of a traced run, reduced to what the per-layer metrics
read: the device operations with their times, which host annotation (the
benchmark's spans, ``torch.profiler.record_function``) launched each, the
busy time, and the idle gaps with what the host was doing during each.

The profiler's trace is exported as Chrome JSON into ``$TMPDIR``, read once
and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    dur_us: float
    annotation: Optional[str]   # the innermost benchmark span around its launch


class Span(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    ops: List[DeviceOp]
    spans: List[Span]
    busy_s: float

    def time_of(self, pred) -> Tuple[float, int]:
        """(seconds, count) of the device ops for which ``pred(op)`` holds."""
        sel = [op.dur_us for op in self.ops if pred(op)]
        return sum(sel) * 1e-6, len(sel)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by[op.name[:160]] += op.dur_us * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps between device ops, each named by the
        innermost benchmark span the host was in at the gap's middle."""
        iv = sorted((op.start_us, op.start_us + op.dur_us) for op in self.ops)
        gaps = []
        end = iv[0][1] if iv else 0.0
        for s, e in iv[1:]:
            if s > end:
                gaps.append((s - end, (s + end) / 2))
            end = max(end, e)
        gaps.sort(reverse=True)
        return [[_innermost(self.spans, mid) or "host outside any span", g * 1e-6]
                for g, mid in gaps[:n]]


def _innermost(spans: List[Span], t: float) -> Optional[str]:
    best = None
    for sp in spans:
        if sp.start_us <= t <= sp.end_us and (
                best is None or sp.end_us - sp.start_us < best.end_us - best.start_us):
            best = sp
    return best.name if best else None


def _union_s(iv: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def reduce_events(events: List[dict], prefix: str = "bench.") -> Trace:
    """Reduce Chrome trace events to a :class:`Trace`. Only annotations whose
    name starts with ``prefix`` count as spans."""
    launch_ts: Dict[int, float] = {}
    spans: List[Span] = []
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(prefix):
            spans.append(Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    spans.sort(key=lambda s: s.start_us)
    starts = [s.start_us for s in spans]
    ops = []
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        t = launch_ts.get(corr)
        ann = None
        if t is not None:
            # innermost span containing the launch: scan the spans that start before it
            best = None
            for sp in spans[:bisect.bisect_right(starts, t)]:
                if sp.end_us >= t and (best is None or sp.start_us >= best.start_us):
                    best = sp
            ann = best.name if best else None
        ops.append(DeviceOp(str(e.get("name", "")), float(e["ts"]), float(e["dur"]), ann))
    ops.sort(key=lambda o: o.start_us)
    return Trace(ops, spans, _union_s([(o.start_us, o.start_us + o.dur_us) for o in ops]))


class Profiled:
    """``with Profiled() as p: ...`` runs the block under ``torch.profiler``
    (host and CUDA activity); ``p.trace`` is the reduced trace afterwards."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.trace = reduce_events(events)
        return False
