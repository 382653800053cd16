"""Observability: structured metrics logging, wall-clock tracing, profiler
hooks (JAX package ``utils/observability.py``).

  * :class:`MetricsLogger`: append-only JSONL metrics stream, one
    ``{"step", "ts", **metrics}`` record a line (the JAX package's layout, so
    one reader takes the files of both), and in-memory histories;
  * :func:`trace_span`: wall-clock span timer that feeds the logger;
  * :func:`device_memory_stats`: ``torch.cuda.memory_stats`` of one device;
  * :func:`profile_to`: a ``torch.profiler`` trace written to a directory.
    On a CUDA device it records the card's activity or raises; it never
    quietly records the host alone.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from .device import DeviceLike


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


@contextlib.contextmanager
def trace_span(name: str, logger: Optional[MetricsLogger] = None,
               step: int = 0, verbose: bool = False) -> Iterator[None]:
    """Time the block on the host clock; log it as ``span/<name>_s``. Work
    queued on the card is not waited for: end the block with a synchronise
    to time it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if logger is not None:
            logger.log(step, **{f"span/{name}_s": dt})
        if verbose:
            print(f"[trace] {name}: {dt:.3f}s")


def device_memory_stats(device: DeviceLike = "cuda") -> Dict[str, Any]:
    """``{str(device): {bytes_in_use, peak_bytes_in_use, bytes_reserved}}``
    from ``torch.cuda.memory_stats`` of a CUDA device; ``{}`` for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {str(dev): {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_reserved": stats.get("reserved_bytes.all.current"),
    }}


@contextlib.contextmanager
def profile_to(log_dir: str, device: DeviceLike = "cuda") -> Iterator[None]:
    """Record the block under ``torch.profiler`` and write a Chrome trace to
    ``log_dir/trace.json``. For a CUDA device the CUDA activity is recorded;
    a trace that holds no device event raises ``RuntimeError``."""
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
