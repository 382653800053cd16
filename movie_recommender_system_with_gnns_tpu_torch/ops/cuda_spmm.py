"""LightGCN propagation ``out = Â·E`` over the degree-bucketed ELL layout with a
hand-written CUDA kernel.

:func:`spmm_ell_cuda` is the counterpart of the JAX package's
``ops/pallas_spmm.py::spmm_ell_pallas``: one launch of ``csrc/ell_spmm.cu``
per degree bucket, exact f32 products and sums for f32 or bf16 tables, each
row written straight to its node's place (no inverse-permutation pass). It
takes the plain version, ``ops/spmm.py::spmm_ell``, only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES["ell_spmm"]`` counts kernel launches: one per bucket and call, two
for a wide bucket whose rows are split over several blocks (the gather kernel
and its small reduction pass).

The kernel has no backward kernel, as the TPU kernel has none: a call that
needs a gradient raises and names what is missing.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ._build import LAUNCHES
from .spmm import DeviceELL, DeviceEllBlock, spmm_ell

MAX_DIM = 512   # widest table row the kernel's per-lane registers hold
#: blocks worth having in flight for one bucket, and the fewest slots worth
#: giving one block of a split row
_SPLIT_BLOCKS, _SPLIT_SLOTS = 1024, 1024


def row_split(rows: int, width: int) -> int:
    """Slot segments per row for a bucket: 1 for the narrow, many-row buckets;
    for a wide bucket of few rows, enough segments of at least
    ``_SPLIT_SLOTS`` slots to put about ``_SPLIT_BLOCKS`` blocks in flight,
    so a row of a hundred thousand slots does not serialise on one block."""
    if width < 4 * _SPLIT_SLOTS:
        return 1
    return max(1, min(width // _SPLIT_SLOTS, _SPLIT_BLOCKS // max(rows, 1)))


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("ell_spmm")
    fn = lib.ell_spmm
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int64, i32, i32, i32, i32, i32, p]
        fn.restype = ctypes.c_int
        lib.ell_spmm_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmm_error_string.restype = ctypes.c_char_p
    return lib


def _launch_block(blk: DeviceEllBlock, emb: torch.Tensor, out: torch.Tensor,
                  num_nodes: int, split: int) -> None:
    """Launch one bucket with ``split`` slot segments per row; no checks."""
    rows, width = blk.nbr.shape
    d = emb.shape[1]
    lib = _library()
    scratch = (torch.empty(rows * split * d, dtype=torch.float32, device=emb.device)
               if split > 1 else None)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.ell_spmm(emb.data_ptr(), blk.nbr.data_ptr(), blk.w.data_ptr(),
                           blk.node_ids.data_ptr(), out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), rows,
                           width, d, num_nodes, split,
                           int(emb.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ell_spmm launch failed: cudaError {err} "
                           f"({lib.ell_spmm_error_string(err).decode()})")
    if rows > 0 and width > 0:
        LAUNCHES["ell_spmm"] += 1 if split == 1 else 2


def ell_spmm_block(blk: DeviceEllBlock, emb: torch.Tensor, out: torch.Tensor,
                   num_nodes: int) -> None:
    """One bucket: ``out[node_ids[r]] = Σ_s w[r, s]·emb[nbr[r, s]]`` for the
    rows that do not pad the bucket. ``emb`` and ``out`` are CUDA tensors
    (num_nodes, d ≤ 512), contiguous, f32 or bf16, of one type; a row's
    padding slots trail its neighbours (``DeviceELL.from_host`` checks it)."""
    rows, width = blk.nbr.shape
    if (emb.device.type != "cuda" or emb.dim() != 2 or emb.shape[0] != num_nodes
            or not 0 < emb.shape[1] <= MAX_DIM
            or emb.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"emb must be a CUDA tensor ({num_nodes}, d <= {MAX_DIM}), "
                         f"float32 or bfloat16, got {tuple(emb.shape)} {emb.dtype} "
                         f"on {emb.device}")
    if (out.shape != emb.shape or out.dtype != emb.dtype or out.device != emb.device
            or not emb.is_contiguous() or not out.is_contiguous()):
        raise ValueError("emb and out must be contiguous and of one shape, type and "
                         f"device, got {tuple(emb.shape)} {emb.dtype} on {emb.device} "
                         f"and {tuple(out.shape)} {out.dtype} on {out.device}")
    for name, t, dt in (("node_ids", blk.node_ids, torch.int32),
                        ("nbr", blk.nbr, torch.int32), ("w", blk.w, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != emb.device:
            raise ValueError(f"ELL block field {name} must be contiguous {dt} "
                             f"on {emb.device}, got {t.dtype} on {t.device}")
    if blk.w.shape != (rows, width) or blk.node_ids.shape != (rows,):
        raise ValueError(f"ELL block shapes disagree: nbr {tuple(blk.nbr.shape)}, "
                         f"w {tuple(blk.w.shape)}, node_ids {tuple(blk.node_ids.shape)}")
    _launch_block(blk, emb, out, num_nodes, row_split(rows, width))


class _EllSpmm(torch.autograd.Function):
    """Forward launches the kernel per bucket; there is no backward kernel."""

    @staticmethod
    def forward(ctx, emb, ell):
        out = torch.empty_like(emb)
        for blk in ell.blocks:
            ell_spmm_block(blk, emb, out, ell.num_nodes)
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
