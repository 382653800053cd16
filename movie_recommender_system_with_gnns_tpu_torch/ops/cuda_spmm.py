"""LightGCN propagation ``out = Â·E`` over the degree-bucketed ELL layout with a
hand-written CUDA kernel.

:func:`spmm_ell_cuda` is the counterpart of the JAX package's
``ops/pallas_spmm.py::spmm_ell_pallas``: one persistent launch of
``csrc/ell_spmm.cu`` per hop over every bucket, exact f32 products and sums
for f32 or bf16 tables, each row written straight to its node's place (no
inverse-permutation pass). It takes the plain version, ``ops/spmm.py::spmm_ell``,
only for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES["ell_spmm"]`` counts kernel launches: one per hop.

The launch walks a work list, :class:`EllSchedule`, built once per graph on
the host by :func:`ell_schedule` and kept on the ``DeviceELL``: runs of whole
rows of a bucket, and slot segments of the rows wider than an item's slot
budget, each item about the same number of live slots, one side of a
bipartite graph before the other. A split row's segments are summed in
segment order by the warp that finishes its last segment, so the result is
bit-equal from run to run. Tables whose d is no multiple of 4 (or whose rows
are not aligned for vector loads) take the kernel's scalar-load
instantiation; d is at most 512.

The kernel has no backward kernel, as the TPU kernel has none: a call that
needs a gradient raises and names what is missing.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from ._build import LAUNCHES
from .cuda_mips import _num_sms
from .spmm import DeviceELL, spmm_ell

MAX_DIM = 512        # widest table row the kernel's per-lane registers hold
MAX_BUCKETS = 32     # bucket descriptors the launch carries as parameters
#: live slots per work item (of 128, 256, 512 and 1024 the fastest on the
#: full graph: PERF.md, the tuning of B4)
SLOT_BUDGET = 256


@dataclass(frozen=True)
class EllSchedule:
    """The kernel's work list over one ELL graph's buckets.

    ``items`` (n_items, 4) int32: ``(bucket, row0, row1, 0)`` for a run of
    whole rows ``row0 .. row1 - 1``; ``(-1 - i, segment, slot0, slot1)`` for
    one slot segment of split row ``i``. ``split_rows`` (n_split, 4) int32:
    ``(bucket, row, first scratch row, segments)``. ``item_side`` is 0 for an
    item whose rows read higher node ids than their own (users, in a
    users-first bipartite graph) and 1 otherwise. The host arrays have device
    copies; ``counters`` (1 + n_split) int32 deal the items and count each
    split row's finished segments, and are zero between calls, so launches
    over one schedule run one at a time (on one stream)."""

    items: np.ndarray
    split_rows: np.ndarray
    item_side: np.ndarray
    budget: int
    device_items: torch.Tensor
    device_split_rows: torch.Tensor
    counters: torch.Tensor

    @property
    def num_segments(self) -> int:
        return int(self.split_rows[:, 3].sum())

    @property
    def item_bucket(self) -> np.ndarray:
        seg = self.items[:, 0] < 0
        out = self.items[:, 0].copy()
        out[seg] = self.split_rows[-1 - self.items[seg, 0], 0]
        return out

    def select(self, keep: np.ndarray) -> "EllSchedule":
        """The items where ``keep`` is true, with this schedule's split rows,
        scratch layout and counters (so launches of the two must not
        overlap). A split row's segments are kept all or none."""
        keep = np.asarray(keep, bool)
        seg = self.items[:, 0] < 0
        sr = -1 - self.items[seg, 0]
        kept = np.bincount(sr[keep[seg]], minlength=len(self.split_rows))
        if np.any((kept != 0) & (kept != self.split_rows[:, 3])):
            raise ValueError("a selection must keep all of a split row's segments or none")
        items = self.items[keep]
        return EllSchedule(items, self.split_rows, self.item_side[keep], self.budget,
                           torch.from_numpy(items).to(self.device_items.device),
                           self.device_split_rows, self.counters)


def _cdiv(a, b):
    return -(-a // b)


def ell_schedule(blocks: Sequence, num_nodes: int, device: DeviceLike = None,
                 budget: int = SLOT_BUDGET, by_side: bool = True) -> EllSchedule:
    """Work list of one hop over ELL ``blocks`` (host arrays ``node_ids``,
    ``nbr``, ``w`` per bucket, padding trailing each row), vectorised NumPy.

    Rows whose node id is ``num_nodes`` pad a bucket and are not scheduled;
    every other row is, isolated rows included (their output is zero). A
    row's live slots are those before its first padding id. A row of more
    than ``budget`` live slots is split into segments of at most ``budget``
    (a multiple of 32, so every segment starts on a 32-slot chunk); the other
    rows form runs of consecutive rows whose live slots (at least 1 per row)
    add up to at most ``budget``. With ``by_side`` the list takes the rows
    that read higher ids than their own first, then the others, so on a
    users-first bipartite graph a sweep gathers from one table at a time;
    within a side, buckets go widest first."""
    if budget < 32 or budget % 32:
        raise ValueError(f"budget must be a positive multiple of 32, got {budget}")
    if len(blocks) > MAX_BUCKETS:
        raise ValueError(f"the kernel takes at most {MAX_BUCKETS} buckets, got {len(blocks)}")
    per_bucket = []
    for b, blk in enumerate(blocks):
        nbr, ids = np.asarray(blk.nbr), np.asarray(blk.node_ids)
        if nbr.size == 0:
            continue
        live = np.count_nonzero(nbr != num_nodes, axis=1)
        side = (nbr[:, 0] < ids) if by_side else np.zeros(ids.shape, bool)
        per_bucket.append((b, live, side, ids < num_nodes))
    items, sides, splits = [], [], []
    n_split = n_seg = 0
    for s in (False, True):
        for b, live, side, real in reversed(per_bucket):
            rows = np.flatnonzero(real & (side == s))
            lv = live[rows]
            wide = lv > budget
            if wide.any():
                sr_rows, sr_live = rows[wide], lv[wide]
                nseg = _cdiv(sr_live, budget)
                seg_len = _cdiv(_cdiv(sr_live, nseg), 32) * 32   # <= budget
                nseg = _cdiv(sr_live, seg_len)
                first = n_seg + np.cumsum(nseg) - nseg
                splits.append(np.stack([np.full_like(sr_rows, b), sr_rows, first, nseg], 1))
                of = np.repeat(np.arange(sr_rows.size), nseg)
                k = np.arange(of.size) - (first - n_seg)[of]
                s0 = k * seg_len[of]
                items.append(np.stack([-1 - (n_split + of), k, s0,
                                       np.minimum(s0 + seg_len[of], sr_live[of])], 1))
                sides.append(np.full(of.size, s))
                n_split += sr_rows.size
                n_seg += int(nseg.sum())
            rr, cost = rows[~wide], np.maximum(lv[~wide], 1)
            if rr.size:
                # rows whose start falls in one window of `step` live slots
                # form a run; a run then holds at most budget live slots
                step = max(1, budget - int(cost.max()) + 1)
                win = (np.cumsum(cost) - cost) // step
                brk = np.ones(rr.size, bool)
                brk[1:] = (win[1:] != win[:-1]) | (rr[1:] != rr[:-1] + 1)
                start = np.flatnonzero(brk)
                end = np.append(start[1:], rr.size) - 1
                items.append(np.stack([np.full_like(start, b), rr[start], rr[end] + 1,
                                       np.zeros_like(start)], 1))
                sides.append(np.full(start.size, s))
    items = (np.concatenate(items) if items else np.zeros((0, 4))).astype(np.int32)
    splits = (np.concatenate(splits) if splits else np.zeros((0, 4))).astype(np.int32)
    dev = resolve_device(device)
    return EllSchedule(items, splits,
                       (np.concatenate(sides) if sides else np.zeros(0, bool)).astype(np.int8),
                       budget, torch.from_numpy(items).to(dev), torch.from_numpy(splits).to(dev),
                       torch.zeros(1 + len(splits), dtype=torch.int32, device=dev))


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("ell_spmm")
    fn = lib.ell_spmm
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i32, i32, i32, p, p, p, p, i32, p, i32, p, p, p, i32, p]
        fn.restype = ctypes.c_int
        lib.ell_spmm_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmm_error_string.restype = ctypes.c_char_p
    return lib


def ell_spmm_into(ell: DeviceELL, emb: torch.Tensor, out: torch.Tensor,
                  schedule: Optional[EllSchedule] = None) -> None:
    """One launch over ``schedule``'s items (default: ``ell.schedule``, the
    whole hop): ``out[node_ids[r]] = Σ_s w[r, s]·emb[nbr[r, s]]`` for each
    scheduled row. ``emb`` and ``out`` are CUDA tensors (num_nodes,
    d ≤ 512), contiguous, f32 or bf16, of one type. ``schedule`` may be a
    :meth:`EllSchedule.select` of ``ell.schedule`` (one bucket's or one
    side's items, for timing them alone)."""
    n = ell.num_nodes
    if (emb.device.type != "cuda" or emb.dim() != 2 or emb.shape[0] != n
            or not 0 < emb.shape[1] <= MAX_DIM
            or emb.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"emb must be a CUDA tensor ({n}, d <= {MAX_DIM}), "
                         f"float32 or bfloat16, got {tuple(emb.shape)} {emb.dtype} "
                         f"on {emb.device}")
    if (out.shape != emb.shape or out.dtype != emb.dtype or out.device != emb.device
            or not emb.is_contiguous() or not out.is_contiguous()):
        raise ValueError("emb and out must be contiguous and of one shape, type and "
                         f"device, got {tuple(emb.shape)} {emb.dtype} on {emb.device} "
                         f"and {tuple(out.shape)} {out.dtype} on {out.device}")
    for blk in ell.blocks:
        for name, t, dt in (("node_ids", blk.node_ids, torch.int32),
                            ("nbr", blk.nbr, torch.int32), ("w", blk.w, torch.float32)):
            if t.dtype != dt or not t.is_contiguous() or t.device != emb.device:
                raise ValueError(f"ELL block field {name} must be contiguous {dt} "
                                 f"on {emb.device}, got {t.dtype} on {t.device}")
        if blk.w.shape != blk.nbr.shape or blk.node_ids.shape != blk.nbr.shape[:1]:
            raise ValueError(f"ELL block shapes disagree: nbr {tuple(blk.nbr.shape)}, "
                             f"w {tuple(blk.w.shape)}, node_ids {tuple(blk.node_ids.shape)}")
    sched = ell.schedule if schedule is None else schedule
    if sched is None or sched.device_items.device != emb.device:
        raise ValueError("the ELL graph has no work list on the table's device; build "
                         "it with DeviceELL.from_host on that device")
    n_items = len(sched.items)
    if n_items == 0:
        return
    d = emb.shape[1]
    scratch = (torch.empty(sched.num_segments * d, dtype=torch.float32, device=emb.device)
               if sched.num_segments else None)
    nb = len(ell.blocks)
    ptrs = [(ctypes.c_void_p * nb)(*(getattr(b, f).data_ptr() for b in ell.blocks))
            for f in ("nbr", "w", "node_ids")]
    widths = (ctypes.c_int * nb)(*(b.nbr.shape[1] for b in ell.blocks))
    lib = _library()
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.ell_spmm(emb.data_ptr(), out.data_ptr(), d, n,
                           int(emb.dtype == torch.bfloat16), *ptrs, widths, nb,
                           sched.device_items.data_ptr(), n_items,
                           sched.device_split_rows.data_ptr(), sched.counters.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           _num_sms(emb.device), stream)
    if err != 0:
        raise RuntimeError(f"ell_spmm launch failed: cudaError {err} "
                           f"({lib.ell_spmm_error_string(err).decode()})")
    LAUNCHES["ell_spmm"] += 1


class _EllSpmm(torch.autograd.Function):
    """Forward is one launch over every bucket; there is no backward kernel."""

    @staticmethod
    def forward(ctx, emb, ell):
        out = torch.empty_like(emb)
        ell_spmm_into(ell, emb, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the ELL SpMM kernel has no backward kernel; training through it "
            "needs the symmetric-adjacency VJP (spmm_symmetric: the cotangent "
            "of Â·E is Â·g), ROADMAP queue A 7")


def spmm_ell_cuda(ell: DeviceELL, emb: torch.Tensor) -> torch.Tensor:
    """``Â·emb`` over the ELL blocks; same signature and result as
    :func:`ops.spmm.spmm_ell`. emb (num_nodes, d), f32 or bf16, d ≤ 512."""
    if emb.device.type == "cpu":
        return spmm_ell(ell, emb)
    if emb.device.type != "cuda":
        raise ValueError(f"spmm_ell_cuda runs on cuda or cpu tensors, got {emb.device}")
    return _EllSpmm.apply(emb.contiguous(), ell)


def select_spmm(num_nodes: int, dim: int, use_kernel: Optional[bool] = None
                ) -> Callable[[DeviceELL, torch.Tensor], torch.Tensor]:
    """Pick the ELL propagation backend (JAX ``pallas_spmm.select_spmm``).

    The kernel gathers rows directly, so it has no node cap: every
    ``num_nodes`` takes it unless ``use_kernel=False`` asks for the plain
    gather-and-reduce :func:`ops.spmm.spmm_ell`."""
    if dim > MAX_DIM and use_kernel is not False:
        raise ValueError(f"the ELL SpMM kernel holds rows of at most {MAX_DIM} "
                         f"elements, got dim={dim}")
    return spmm_ell if use_kernel is False else spmm_ell_cuda
