"""Exact two-phase MIPS top-k with a fused CUDA pass 1.

Pass 1, :func:`score_chunkmax`, is the hand-written kernel
``csrc/score_chunkmax.cu`` (it replaces the JAX package's
``ops/pallas_mips.py::_score_chunkmax_kernel``): one (Q, N) score matrix in
``score_dtype`` with pad columns and excluded items set to ``NEG_INF``, plus
the max of every 128-column chunk of the rounded scores. Pass 2 stays plain
PyTorch: rank the chunk maxima, gather the winning chunks, take the final
top-k. Exact by chunk containment (``ops/topk.py::twophase_select``).

:func:`score_chunkmax` takes the plain version,
:func:`score_chunkmax_plain`, only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. ``LAUNCHES["score_chunkmax"]`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import as_dtype
from ._build import LAUNCHES
from .bpr import normalize_embedding
from .topk import NEG_INF, DTypeLike, _topk_lowest_first

CHUNK = 128   # chunk width of pass 2 == the kernel's output tile edge
_MASK_NONE, _MASK_INT8, _MASK_PACKED = 0, 1, 2


def unpack_mask_tiles(packed: torch.Tensor, n_tile: int = 2048) -> torch.Tensor:
    """(Q, W) uint8 tile-bit-packed mask (``ops/topk.py::pack_mask_tiles``
    layout) -> (Q, 8·W) bool."""
    nb = n_tile // 8
    col = torch.arange(packed.shape[1] * 8, device=packed.device)
    within = col % n_tile
    byte = (col // n_tile) * nb + within % nb
    bit = (within // nb).to(torch.uint8)
    return ((packed[:, byte] >> bit) & 1).bool()


def score_chunkmax_plain(q: torch.Tensor, c: torch.Tensor, n: int,
                         mask: Optional[torch.Tensor] = None,
                         mask_packed: Optional[torch.Tensor] = None,
                         n_tile: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same arguments and outputs.

    Products of the (bf16 or f32) operands summed in f32, columns ``>= n``
    and excluded entries set to ``NEG_INF``, the result rounded to
    ``q.dtype``; ``cm[r, j]`` is the max of the rounded ``s[r, 128j:128j+128]``.
    """
    s = q.float() @ c.float().T
    col = torch.arange(c.shape[0], device=q.device)
    s = s.masked_fill(col >= n, NEG_INF)
    if mask_packed is not None:
        s = s.masked_fill(unpack_mask_tiles(mask_packed, n_tile), NEG_INF)
    elif mask is not None:
        s = s.masked_fill(mask != 0, NEG_INF)
    sb = s.to(q.dtype)
    return sb, sb.view(sb.shape[0], -1, CHUNK).amax(dim=-1)


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("score_chunkmax")
    fn = lib.score_chunkmax
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, i32, i64, i32, p, p, i64, i64, i32, i64, i32, p]
        fn.restype = ctypes.c_int
        lib.score_chunkmax_error_string.argtypes = [ctypes.c_int]
        lib.score_chunkmax_error_string.restype = ctypes.c_char_p
    return lib


def score_chunkmax(q: torch.Tensor, c: torch.Tensor, n: int,
                   mask: Optional[torch.Tensor] = None,
                   mask_packed: Optional[torch.Tensor] = None,
                   n_tile: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pass 1: (s (Qp, Np), cm (Qp, Np/128)), both in ``q.dtype``.

    q (Qp, d), c (Np, d): bf16 or f32, contiguous, Qp and Np multiples of 128,
    d a multiple of 8; ``n`` valid columns; optional exclusion ``mask``
    (Qp, Np) int8/uint8/bool or ``mask_packed`` (Qp, Np/8) uint8 in the
    ``pack_mask_tiles(n_tile=n_tile)`` layout (then ``n_tile`` is a multiple
    of 1024 and divides Np).
    """
    if q.device.type == "cpu":
        return score_chunkmax_plain(q, c, n, mask, mask_packed, n_tile)
    if q.device.type != "cuda":
        raise ValueError(f"score_chunkmax runs on cuda or cpu tensors, got {q.device}")
    qp, d = q.shape
    np_ = c.shape[0]
    if q.dtype not in (torch.bfloat16, torch.float32) or c.dtype != q.dtype:
        raise ValueError(f"q and c must share dtype bfloat16 or float32, got "
                         f"{q.dtype} and {c.dtype}")
    if c.dim() != 2 or c.shape[1] != d or c.device != q.device:
        raise ValueError(f"c must be (N, {d}) on {q.device}, got "
                         f"{tuple(c.shape)} on {c.device}")
    if qp % CHUNK or np_ % CHUNK or d % 8 or not 0 < n <= np_:
        raise ValueError(f"need Qp, Np multiples of {CHUNK}, d a multiple of 8 "
                         f"and 0 < n <= Np; got Qp={qp} Np={np_} d={d} n={n}")
    if qp // CHUNK > 65535:
        raise ValueError(f"Qp={qp} exceeds the grid's {65535 * CHUNK} rows")
    for t in (q, c):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q and c must be contiguous and 16-byte aligned")
    mode, m, ld = _MASK_NONE, None, 0
    if mask is not None and mask_packed is not None:
        raise ValueError("pass mask OR mask_packed, not both")
    if mask_packed is not None:
        # n_tile % 1024 puts each 128-column block on one bit plane of 128
        # consecutive bytes (the JAX kernel's lane tiling needs the same)
        if (mask_packed.dtype != torch.uint8 or n_tile % 1024 or np_ % n_tile
                or mask_packed.shape != (qp, np_ // 8)):
            raise ValueError(f"mask_packed must be uint8 ({qp}, {np_ // 8}) "
                             f"with n_tile={n_tile} a multiple of 1024 dividing "
                             f"Np, got {mask_packed.dtype} {tuple(mask_packed.shape)}")
        mode, m = _MASK_PACKED, mask_packed
    elif mask is not None:
        if (mask.dtype not in (torch.int8, torch.uint8, torch.bool)
                or mask.shape != (qp, np_)):
            raise ValueError(f"mask must be one-byte ({qp}, {np_}), got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        mode, m = _MASK_INT8, mask
    if m is not None:
        if not m.is_contiguous() or m.device != q.device or m.data_ptr() % 16:
            raise ValueError(f"mask must be contiguous and 16-byte aligned on {q.device}")
        ld = m.shape[1]

    lib = _library()
    s = torch.empty((qp, np_), dtype=q.dtype, device=q.device)
    cm = torch.empty((qp, np_ // CHUNK), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.score_chunkmax(
            q.data_ptr(), c.data_ptr(), None if m is None else m.data_ptr(),
            mode, ld, n_tile, s.data_ptr(), cm.data_ptr(), qp, np_, d, n,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"score_chunkmax launch failed: cudaError {err} "
                           f"({lib.score_chunkmax_error_string(err).decode()})")
    LAUNCHES["score_chunkmax"] += 1
    return s, cm


def mips_topk_fused(
    query: torch.Tensor,       # (Q, d)
    catalog: torch.Tensor,     # (N, d)
    k: int = 10,
    q_tile: int = 512,
    n_tile: int = 2048,
    normalize: bool = True,
    score_dtype: DTypeLike = torch.bfloat16,
    exclude_mask: Optional[torch.Tensor] = None,         # (Q, N) bool/int8 — 1 = exclude
    exclude_mask_packed: Optional[torch.Tensor] = None,  # (Q, ⌈N/n_tile⌉·n_tile/8) uint8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-phase MIPS top-k with the fused pass 1; returns
    (scores (Q, k) f32, indices (Q, k) int64).

    Same signature and semantics as the JAX package's
    ``ops/pallas_mips.py::mips_topk_fused``: rows are normalized in f32 and
    cast to ``score_dtype``; the query axis pads to ``q_tile`` and the catalog
    to ``n_tile`` (the packed mask's tile, ``ops/topk.py::pack_mask_tiles``),
    so pad columns rank exactly as there when fewer than k columns survive.
    """
    sd = as_dtype(score_dtype)
    q = normalize_embedding(query) if normalize else query
    c = normalize_embedding(catalog) if normalize else catalog
    q = q.to(sd)
    c = c.to(sd)
    n, d = c.shape
    nq = q.shape[0]
    qpad = (-nq) % q_tile
    npad = (-n) % n_tile
    # F.pad copies even when it pads nothing: pad only where needed
    q = (F.pad(q, (0, 0, 0, qpad)) if qpad else q).contiguous()
    c = (F.pad(c, (0, 0, 0, npad)) if npad else c).contiguous()
    nqp, np_ = nq + qpad, n + npad
    ncp = np_ // CHUNK

    if exclude_mask is not None and exclude_mask_packed is not None:
        raise ValueError("pass exclude_mask OR exclude_mask_packed, not both")
    mask = packed = None
    if exclude_mask_packed is not None:
        if exclude_mask_packed.shape[1] != np_ // 8:
            raise ValueError(
                f"packed mask width {exclude_mask_packed.shape[1]} != padded "
                f"catalog/8 {np_ // 8} — pack with pack_mask_tiles("
                f"num_items={n}, n_tile={n_tile})")
        packed = (F.pad(exclude_mask_packed, (0, 0, 0, qpad)) if qpad
                  else exclude_mask_packed).contiguous()
    elif exclude_mask is not None:
        mask = exclude_mask.to(torch.int8)
        if mask.shape != (nqp, np_):
            # accept pre-padded masks (no pad copy per dispatch)
            mask = F.pad(mask, (0, np_ - mask.shape[1], 0, nqp - mask.shape[0]))
        mask = mask.contiguous()

    s, cm = score_chunkmax(q, c, n, mask=mask, mask_packed=packed, n_tile=n_tile)

    kc = min(k, ncp)
    _, ci = _topk_lowest_first(cm[:nq], kc)                  # winning chunks
    s3 = s[:nq].view(nq, ncp, CHUNK)
    sel = torch.take_along_dim(s3, ci[:, :, None], dim=1)     # (Q, kc, 128)
    vs, vi = _topk_lowest_first(sel.reshape(nq, kc * CHUNK), k)
    chunk = torch.gather(ci, 1, vi // CHUNK)
    return vs.float(), chunk * CHUNK + vi % CHUNK
