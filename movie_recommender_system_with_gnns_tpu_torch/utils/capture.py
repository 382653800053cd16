"""A step captured once as a CUDA graph and replayed: the port's counterpart
of one compiled ``lax.scan`` over an epoch's steps.

:class:`StepGraph` runs a body of no arguments ``n`` times. The body reads
and writes only tensors whose addresses stay fixed (the state's tables and
moments, the stacked inputs, and static buffers that the caller refills
between epochs, a device step counter among them), so each replay is the
next step. A capture that fails raises: there is no eager fall-back on the
card.
"""

from __future__ import annotations

from typing import Callable, Hashable, Optional

import torch

from .observability import count, trace_span


def tensor_key(*tensors: torch.Tensor) -> tuple:
    """The addresses, shapes and dtypes of ``tensors``: what a captured graph
    binds. Two calls with equal keys may replay the same graph."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


class StepGraph:
    """``run(body, key, n)`` runs ``body()`` ``n`` times on the current CUDA
    device.

    With a new ``key`` the first of the ``n`` bodies runs eagerly on a side
    stream (the warm-up: kernels built and loaded, the autograd engine's
    device threads and the allocator's blocks made before any capture), the
    body is then captured as one CUDA graph, and the graph is replayed
    ``n - 1`` times. With the key of the last capture, the graph is replayed
    ``n`` times. ``key`` names what the body's graph binds
    (:func:`tensor_key` of the tensors it reads and writes); a new key drops
    the old graph before the capture.

    While tracing is on (``utils/observability.py``) a run is a
    ``graph.run`` span, and the ``graph.capture`` and ``graph.replay``
    counters count its captures and replays: a replay calls no Python, so
    ``ops/_build.py::LAUNCHES`` counts a captured launch once, at capture."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key: Optional[Hashable] = None

    def run(self, body: Callable[[], None], key: Hashable, n: int) -> None:
        if n <= 0:
            return
        with trace_span("graph.run"):
            if self.graph is not None and key == self.key:
                for _ in range(n):
                    self.graph.replay()
                count("graph.replay", n)
                return
            self.graph = self.key = None
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                body()
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                body()
            count("graph.capture")
            self.graph, self.key = graph, key
            for _ in range(n - 1):
                graph.replay()
            count("graph.replay", n - 1)
