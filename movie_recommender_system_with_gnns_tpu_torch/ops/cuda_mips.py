"""MIPS top-k through the port's two hand-written scoring kernels.

**Fused two-phase lane.**

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

**Per-block lane.** :func:`mips_block_topk` is the hand-written kernel
``csrc/mips_block.cu`` (it replaces ``ops/pallas_mips.py::_mips_block_kernel``):
per catalog block of ``block`` rows, the f32 scores of every query with pad
columns and excluded items at ``NEG_INF``, and the block's top-k taken in the
same kernel, the lowest column winning ties; only (nb, Q, k) candidates reach
device memory. :func:`mips_topk_block` (the counterpart of
``mips_topk_pallas``) normalizes, launches and merges the candidates with
``ops/topk.py::merge_topk``. The plain version,
:func:`mips_block_topk_plain`, is taken only for tensors on the CPU;
``LAUNCHES["mips_block"]`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import as_dtype
from ._build import LAUNCHES
from .bpr import normalize_embedding
from .topk import NEG_INF, DTypeLike, _topk_lowest_first, merge_topk

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
        fn.argtypes = [p, p, p, i32, i64, i32, p, p, i64, i64, i32, i64, i32, i32, p]
        fn.restype = ctypes.c_int
        lib.score_chunkmax_error_string.argtypes = [ctypes.c_int]
        lib.score_chunkmax_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    """SM count of a CUDA device: the bf16 lane of ``score_chunkmax`` runs one
    persistent block on each SM, and the per-block kernel splits its units
    over clusters where they alone would leave SMs idle."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if q.dtype == torch.float32 and qp // CHUNK > 65535:
        raise ValueError(f"Qp={qp} exceeds the f32 lane's grid of {65535 * CHUNK} rows")
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
            int(q.dtype == torch.bfloat16), _num_sms(q.device), stream)
    if err != 0:
        raise RuntimeError(f"score_chunkmax launch failed: error {err} "
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


# ---------------------------------------------------------------------------
# per-block lane: scores and the block's top-k in one kernel
# ---------------------------------------------------------------------------


def mips_block_topk_plain(q: torch.Tensor, c: torch.Tensor, k: int,
                          block: int = 4096, mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the per-block kernel, same arguments and
    outputs: (scores (nb, Q, k) f32, global column ids (nb, Q, k) int32).

    ``q @ c.T`` in f32 over the catalog padded to whole blocks, ``NEG_INF`` on
    pad columns and where ``mask`` (Q, N) is non-zero, then each block's k
    best by a stable descending sort (the lowest column wins ties). A rank
    whose value is ``NEG_INF`` names the block's first column: the kernel's
    k rounds of max-and-retire leave every column at ``NEG_INF`` once the
    live ones are taken, and the lowest of them is the block's first."""
    nq, n = q.shape[0], c.shape[0]
    pad = (-n) % block
    nb = (n + pad) // block
    s = q.float() @ F.pad(c.float(), (0, 0, 0, pad)).T            # (Q, nb·block)
    dead = (torch.arange(n + pad, device=q.device) >= n).expand(nq, -1)
    if mask is not None:
        dead = dead | F.pad(mask != 0, (0, pad))
    s = s.masked_fill(dead, NEG_INF)
    vs, pos = _topk_lowest_first(s.view(nq, nb, block), k)        # (Q, nb, k)
    first = (torch.arange(nb, device=q.device) * block)[None, :, None]
    idx = torch.where(vs == NEG_INF, first, pos + first)
    return (vs.permute(1, 0, 2).contiguous(),
            idx.permute(1, 0, 2).to(torch.int32).contiguous())


def _block_library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("mips_block")
    fn = lib.mips_block
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, p]
        fn.restype = ctypes.c_int
        lib.mips_block_scratch_bytes.argtypes = [i32] * 6
        lib.mips_block_scratch_bytes.restype = ctypes.c_int64
        lib.mips_block_error_string.argtypes = [ctypes.c_int]
        lib.mips_block_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def _block_scratch_bytes(lib: ctypes.CDLL, nq: int, n: int, d: int, k: int,
                         block: int, sms: int) -> int:
    """Bytes of global scratch the kernel needs for these sizes (0 when its
    candidate buffers fit in shared memory), asked of the library once per
    shape."""
    return lib.mips_block_scratch_bytes(nq, n, d, k, block, sms)


def _raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle, without
    building a ``torch.cuda.Stream`` object where PyTorch offers that."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def mips_block_topk(q: torch.Tensor, c: torch.Tensor, k: int,
                    block: int = 4096, mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block scores and top-k in one launch: (scores (nb, Q, k) f32,
    global column ids (nb, Q, k) int32), nb = ⌈N / block⌉.

    q (Q, d), c (N, d): contiguous f32; ``mask`` (Q, N) one-byte, non-zero =
    excluded; 1 ≤ k ≤ block. The kernel streams each block through shared
    memory in tiles and keeps only per-query candidate buffers, so neither
    ``block`` nor ``d`` is capped by shared memory: ``block`` is limited by
    N + block < 2^31 and ⌈N / block⌉ ≤ 65,535, ``k`` by ``block``. For
    k > 128, or where they do not fit in shared memory beside a deep query
    band, the candidate buffers go to a global scratch allocated here (2k to
    3k + 144 entries of 8 bytes for each query and block)."""
    if not 1 <= k <= block:
        raise ValueError(f"need 1 <= k <= block, got k={k} block={block}")
    if q.device.type == "cpu":
        return mips_block_topk_plain(q, c, k, block, mask)
    if q.device.type != "cuda":
        raise ValueError(f"mips_block_topk runs on cuda or cpu tensors, got {q.device}")
    nq, d = q.shape
    n = c.shape[0]
    dev = q.device
    for name, t in (("q", q), ("c", c)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != d
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be contiguous float32 (rows, {d}) on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if nq == 0 or n == 0:
        raise ValueError(f"empty query or catalog: Q={nq} N={n}")
    if mask is not None:
        if (mask.dtype not in (torch.int8, torch.uint8, torch.bool)
                or mask.shape != (nq, n) or not mask.is_contiguous()
                or mask.device != dev):
            raise ValueError(f"mask must be contiguous one-byte ({nq}, {n}) on "
                             f"{dev}, got {mask.dtype} {tuple(mask.shape)}")
    lib = _block_library()
    sms = _num_sms(dev)
    scratch_bytes = _block_scratch_bytes(lib, nq, n, d, k, block, sms)
    if scratch_bytes < 0:
        raise ValueError(f"mips_block does not take Q={nq} N={n} d={d} k={k} "
                         f"block={block}")
    nb = -(-n // block)
    os_ = torch.empty((nb, nq, k), dtype=torch.float32, device=dev)
    oi_ = torch.empty((nb, nq, k), dtype=torch.int32, device=dev)
    scratch = (torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
               if scratch_bytes else None)
    ctx = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
           else contextlib.nullcontext())
    with ctx:
        err = lib.mips_block(q.data_ptr(), c.data_ptr(),
                             None if mask is None else mask.data_ptr(),
                             os_.data_ptr(), oi_.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             nq, n, d, k, block, sms, _raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"mips_block launch failed: cudaError {err} "
                           f"({lib.mips_block_error_string(err).decode()})")
    LAUNCHES["mips_block"] += 1
    return os_, oi_


def mips_topk_block(
    query: torch.Tensor,       # (Q, d)
    catalog: torch.Tensor,     # (N, d)
    k: int = 10,
    block: int = 4096,
    normalize: bool = True,
    exclude_mask: Optional[torch.Tensor] = None,   # (Q, N) bool/int8 — 1 = exclude
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MIPS top-k through the per-block kernel; returns (scores (Q, k) f32,
    indices (Q, k) int64).

    Same signature and semantics as the JAX package's
    ``ops/pallas_mips.py::mips_topk_pallas``: rows normalized in f32, scores
    from three TF32 tensor-core products (within about 6e-7 of f32 at
    d = 64), each block's candidates merged by
    :func:`ops.topk.merge_topk`. The (Q, N) score matrix never reaches device
    memory."""
    q = normalize_embedding(query) if normalize else query
    c = normalize_embedding(catalog) if normalize else catalog
    mask = None
    if exclude_mask is not None:
        mask = exclude_mask.contiguous()
        if mask.dtype not in (torch.int8, torch.uint8, torch.bool):
            mask = mask.to(torch.int8)
    os_, oi_ = mips_block_topk(q.float().contiguous(), c.float().contiguous(), k,
                               block=block, mask=mask)
    vs, vi = merge_topk(os_, oi_, k)
    return vs, vi.long()
