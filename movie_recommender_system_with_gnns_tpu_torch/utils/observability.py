"""Observability: structured metrics logging, the port's spans and counters,
profiler hooks (JAX package ``utils/observability.py``).

  * :class:`MetricsLogger`: append-only JSONL metrics stream, one
    ``{"step", "ts", **metrics}`` record a line (the JAX package's layout, so
    one reader takes the files of both), and in-memory histories;
  * :func:`trace_span` and :func:`count`: the port's spans and counters.
    They record only while tracing is on: while a ``torch.profiler`` session
    records (:func:`profile_to`, or any other), or inside :func:`tracing`.
    A span is then a profiler range of its name, so it is in the profiler's
    trace, and a :class:`Record` in an in-process ring of the newest
    ``RING_SIZE`` records (:func:`span_records`), on the clock the trace is
    stamped with. Off, a span reads two flags and returns a shared null
    context;
  * :func:`profile_to`: a ``torch.profiler`` trace written to a directory.
    On a CUDA device it records the card's activity or raises; it never
    quietly records the host alone.

Span and counter names are a contract: the benchmark's per-layer metrics
read them (``PERF.md`` lists which metric reads which).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Any, Deque, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from .device import DeviceLike

#: records the ring keeps; the oldest fall out first
RING_SIZE = 1 << 18


class Record(NamedTuple):
    """One span or one counter event, timed by ``time.time_ns()``: the Unix
    clock in ns, on which a profiler trace's event starts at its Chrome
    ``ts`` + ``baseTimeNanoseconds`` / 1000 (µs).

    A span (``n == 0``): the host was inside ``name`` from ``t0_ns`` to
    ``t1_ns``; ``wait`` marks a span in which it blocked until the card had
    run everything queued so far. A counter event: ``n`` added to the
    counter ``name`` at ``t0_ns == t1_ns``."""

    name: str
    t0_ns: int
    t1_ns: int
    wait: bool = False
    n: int = 0


_RING: Deque[Record] = collections.deque(maxlen=RING_SIZE)
_COUNTS: collections.Counter = collections.Counter()
#: depth of the open :func:`tracing` blocks
_forced = 0
# A torch profiler started from Python (``torch.profiler``,
# ``torch.autograd.profiler``, ``emit_nvtx``, ``emit_itt``) sets
# ``_autograd_profiler._is_profiler_enabled`` while it records. Spans read
# that flag rather than call ``torch.autograd._profiler_enabled()``: with
# tracing off, the call cost a serving dispatch about 8 µs of host time more,
# its code being cold there (``PERF.md`` §6).
#: the profiler range a recorded span enters: the profiler's fast range,
#: which the trace shows as a ``cpu_op`` event of the span's name, at about a
#: quarter of ``record_function``'s host cost on the card (``PERF.md`` §6);
#: ``record_function`` (a ``user_annotation``) where torch has none
_range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class MetricsLogger:
    """Append-only JSONL metrics with per-key history access."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._hist: Dict[str, List[Any]] = {}
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "ts": time.time(), **metrics}
        for k, v in metrics.items():
            self._hist.setdefault(k, []).append(v)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")

    def history(self, key: str) -> List[Any]:
        return list(self._hist.get(key, []))

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


class _Span:
    """A :func:`trace_span` that times its block: recorded (a profiler range
    and a ring record) while tracing is on, logged where asked."""

    __slots__ = ("name", "wait", "logger", "step", "verbose", "record", "_range", "_t0")

    def __init__(self, name: str, wait: bool, logger: Optional[MetricsLogger], step: int,
                 verbose: bool, record: bool):
        self.name, self.wait, self.logger, self.step = name, wait, logger, step
        self.verbose, self.record = verbose, record

    def __enter__(self) -> None:
        if self.record:
            self._range = _range(self.name)
            self._range.__enter__()
        self._t0 = time.time_ns()

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        if self.record:
            self._range.__exit__(*exc)
            _RING.append(Record(self.name, self._t0, t1, self.wait))
        dt = (t1 - self._t0) * 1e-9
        if self.logger is not None:
            self.logger.log(self.step, **{f"span/{self.name}_s": dt})
        if self.verbose:
            print(f"[trace] {self.name}: {dt:.3f}s")
        return False


_OFF = contextlib.nullcontext()


def trace_span(name: str, logger: Optional[MetricsLogger] = None, step: int = 0,
               verbose: bool = False, wait: bool = False):
    """A span over the block. While tracing is on it is a profiler range
    named ``name`` (an event of the profiler's trace) and, timed just inside
    that range, a :class:`Record` in the ring; ``wait=True`` marks a block in
    which the host waits for the card. With a ``logger`` the block's host
    seconds are logged as ``span/<name>_s``, and ``verbose`` prints them,
    whether tracing is on or not. The host clock times the enqueue: work
    queued on the card is not waited for unless the block waits."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        return _Span(name, wait, logger, step, verbose, True)
    if logger is None and not verbose:
        return _OFF
    return _Span(name, wait, logger, step, verbose, False)


def count(name: str, n: int = 1) -> None:
    """While tracing is on, add ``n`` to the counter ``name`` and put the
    event in the ring; nothing otherwise."""
    if n and (_forced or _autograd_profiler._is_profiler_enabled):
        _COUNTS[name] += n
        t = time.time_ns()
        _RING.append(Record(name, t, t, False, n))


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record spans and counters inside the block, with no profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def span_records() -> List[Record]:
    """The ring, oldest first. A span goes in when it closes, so an inner
    span comes before the span around it."""
    return list(_RING)


def counts() -> Dict[str, int]:
    """Each counter's total since the process began, or since :func:`clear`."""
    return dict(_COUNTS)


def clear() -> None:
    """Empty the ring and the counters."""
    _RING.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def profile_to(log_dir: str, device: DeviceLike = "cuda") -> Iterator[None]:
    """Record the block under ``torch.profiler`` and write a Chrome trace to
    ``log_dir/trace.json``. For a CUDA device the CUDA activity is recorded;
    a trace that holds no device event raises ``RuntimeError``. The port's
    spans and counters record inside the block."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_to: CUDA is not available; pass device='cpu' "
                               "to record the host alone")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev.type == "cuda" and not any(
            getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError("profile_to: the trace holds no CUDA activity")
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")
