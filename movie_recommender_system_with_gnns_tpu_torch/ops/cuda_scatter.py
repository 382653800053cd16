"""Deterministic row scatter for the compact step: ``index_add_``'s sum in an
order fixed by the data, from a hand-written CUDA kernel.

On the card, ``index_add_`` and the backward of ``index_select`` sum repeated
rows with float atomics, so two steps on the same inputs differ in their last
bits. Here every scatter is given its rows' lists up front (a stable order of
the index and its row starts, :func:`sort_rows`), and the kernel,
``csrc/sorted_index_add.cu``, sums each row over its list in order:

  * :func:`sorted_index_add` is the kernel's wrapper. It takes the plain
    version, :func:`sorted_index_add_plain` (``index_add_``, sequential on the
    CPU), only for tensors on the CPU; for CUDA tensors it launches the kernel
    or raises. ``LAUNCHES["sorted_index_add"]`` counts launches.
  * :func:`gather_rows` is ``table.index_select(0, idx)`` whose backward is
    :func:`sorted_index_add`; :func:`scatter_rows` is the adjoint pair, a
    :func:`sorted_index_add` whose backward is the gather.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._build import LAUNCHES

MAX_DIM = 512   # a warp's lanes stride over d with at most 16 elements each


def sort_rows(idx: torch.Tensor, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, starts)`` of an index array with values in ``[0, rows]``:
    ``order`` (int32) lists the entries stably by value, and ``starts``
    (int32, ``rows + 1``) gives where each row's run begins, so row ``r``'s
    entries are ``order[starts[r]:starts[r + 1]]`` in ascending entry order.
    A value equal to ``rows`` lands after ``starts[rows]``: a sentinel.

    The sort is a radix sort over all the key's bits, so values that fit 16
    bits are sorted as int16 keys (offset by 2**15): half the passes of int32
    keys, the same stable order."""
    keys = idx.reshape(-1)
    lo = 0
    if rows < 2 ** 16:
        lo = -2 ** 15
        keys = (keys - 2 ** 15).to(torch.int16)
    keys, order = torch.sort(keys, stable=True)
    starts = torch.searchsorted(
        keys, torch.arange(lo, lo + rows + 1, dtype=keys.dtype, device=keys.device),
        out_int32=True)
    return order.to(torch.int32), starts


def sort_rows_np(keys: np.ndarray, rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`sort_rows` for lists built once on the host:
    (stable order, row starts), int32."""
    order = np.argsort(keys, kind="stable")
    starts = np.searchsorted(keys[order], np.arange(rows + 1), side="left")
    return order.astype(np.int32), starts.astype(np.int32)


def sorted_index_add_plain(x: torch.Tensor, order: torch.Tensor,
                           starts: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain PyTorch version: ``zeros(rows, d).index_add_`` over the listed
    entries, row by row in list order (sequential on the CPU)."""
    lo, hi = int(starts[0]), int(starts[rows])
    counts = (starts[1:] - starts[:-1]).long()
    row_of = torch.repeat_interleave(torch.arange(rows, device=x.device), counts)
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, row_of, x.index_select(0, order[lo:hi].long()))


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("sorted_index_add")
    fn = lib.sorted_index_add
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 4 + [ctypes.c_int] * 3 + [p]
        fn.restype = ctypes.c_int
        lib.sorted_index_add_error_string.argtypes = [ctypes.c_int]
        lib.sorted_index_add_error_string.restype = ctypes.c_char_p
    return lib


def sorted_index_add(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """``out (rows, d)``: ``out[r]`` is the sum, in list order, of
    ``x[order[starts[r]:starts[r + 1]]]``; a row with no entries is zero.

    x (n, d) contiguous float32 or bfloat16; order (int32, indices into x) and
    starts (int32, ``rows + 1``, non-decreasing) as :func:`sort_rows` gives
    them. The index values are not checked on the device."""
    if x.device.type == "cpu":
        return sorted_index_add_plain(x, order, starts, rows)
    if x.device.type != "cuda":
        raise ValueError(f"sorted_index_add runs on cuda or cpu tensors, got {x.device}")
    if (x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16)
            or not x.is_contiguous()):
        raise ValueError(f"x must be contiguous 2-D float32 or bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    d = x.shape[1]
    if not 0 < d <= MAX_DIM:
        raise ValueError(f"sorted_index_add needs 0 < d <= {MAX_DIM}, got d={d}")
    for name, t, n in (("order", order, None), ("starts", starts, rows + 1)):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != x.device or (n is not None and t.shape[0] != n)):
            raise ValueError(f"{name} must be contiguous int32 1-D"
                             f"{'' if n is None else f' ({n},)'} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sorted_index_add(x.data_ptr(), order.data_ptr(), starts.data_ptr(),
                                   out.data_ptr(), rows, d,
                                   int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"sorted_index_add launch failed: cudaError {err} "
                           f"({lib.sorted_index_add_error_string(err).decode()})")
    LAUNCHES["sorted_index_add"] += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, order, starts):
        ctx.save_for_backward(order, starts)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        order, starts = ctx.saved_tensors
        return sorted_index_add(g.contiguous(), order, starts, ctx.rows), None, None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, order, starts, rows):
        ctx.save_for_backward(idx)
        return sorted_index_add(x.contiguous(), order, starts, rows)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.index_select(0, idx), None, None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, order: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, idx)`` whose gradient is summed by
    :func:`sorted_index_add`; ``(order, starts) = sort_rows(idx, len(table))``."""
    return _GatherRows.apply(table, idx, order, starts)


def scatter_rows(x: torch.Tensor, idx: torch.Tensor, order: torch.Tensor,
                 starts: torch.Tensor, rows: int) -> torch.Tensor:
    """``zeros(rows, d).index_add(0, idx, x)`` summed by
    :func:`sorted_index_add` (``(order, starts) = sort_rows(idx, rows)``);
    its gradient is the gather ``g.index_select(0, idx)``."""
    return _ScatterRows.apply(x, idx, order, starts, rows)
