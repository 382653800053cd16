"""Maximum-inner-product-search (MIPS) top-k retrieval (JAX package ``ops/topk.py``).

Scores are cosine similarities of L2-normalized embeddings (reference
recommend.py:39-42). Exclusion masks (train-seen items, recommend.py:48-50)
set scores to ``NEG_INF`` before selection.

Tie order follows ``jax.lax.top_k``: among equal values the lower position
wins. ``torch.topk`` promises no tie order, so every selection here is a
stable descending sort (:func:`_topk_lowest_first`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import as_dtype
from .bpr import normalize_embedding

NEG_INF = -1e30

DTypeLike = Union[str, torch.dtype, None]


def _topk_lowest_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, sorted; ties go to the lower position."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def _scores(q: torch.Tensor, c: torch.Tensor,
            score_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``q @ c.T`` in ``score_dtype``: operands rounded to it, products summed
    in f32, the sum rounded once (how a bf16 matmul with f32 accumulation
    behaves)."""
    if score_dtype is None:
        return q @ c.T
    qs, cs = q.to(score_dtype), c.to(score_dtype)
    if score_dtype == torch.float32:
        return qs @ cs.T
    return (qs.float() @ cs.float().T).to(score_dtype)


def mips_topk(
    query: torch.Tensor,            # (Q, d)
    catalog: torch.Tensor,          # (N, d)
    k: int = 10,
    exclude_mask: Optional[torch.Tensor] = None,   # (Q, N) bool/int8 — True/1 = exclude
    block: Optional[int] = None,
    normalize: bool = True,
    method: str = "auto",
    recall_target: float = 1.0,
    max_flat_bytes: int = 512 * 1024 * 1024,
    score_dtype: DTypeLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine/MIPS top-k: returns (scores (Q, k) f32, indices (Q, k) int64).

    Methods:
      * ``fused``    — the hand-written CUDA pass 1 (score tile, masks, chunk
                       maxima; ``ops/cuda_mips.py``) then a two-level exact
                       selection; bf16 scores by default;
      * ``twophase`` — full (Q, N) scores, 128-column chunk maxima, top chunks,
                       exact re-selection inside them (:func:`twophase_select`);
      * ``flat``     — full (Q, N) scores and one sort; exact at every
                       ``recall_target`` (there is no approximate selection);
      * ``blocked``  — ``block``-column tiles (8192 by default) with a running
                       (Q, k + block) merge: no (Q, N) intermediate;
      * ``auto``     — twophase while the (Q, N) score matrix fits
                       ``max_flat_bytes``, else blocked;
      * ``pallas``   — the hand-written per-block CUDA kernel (scores and the
                       block's top-k in one launch, ``block`` 4096 by default;
                       ``ops/cuda_mips.py::mips_topk_block``), candidates
                       merged by :func:`merge_topk`; exact f32. The name is
                       the JAX package's, so configs and calls carry over.

    ``score_dtype`` ("bfloat16", "float32" or a torch dtype) scores in that
    type after the f32 normalization; the top-k is exact w.r.t. those scores.
    """
    sd = as_dtype(score_dtype)
    if method == "pallas":
        if sd is not None:
            # the kernel scores in f32; handing it f32 operands after a bf16
            # request would misreport the numerics
            raise ValueError("score_dtype is not supported with method='pallas' "
                             "(the kernel fixes its own compute dtype)")
        from .cuda_mips import mips_topk_block

        return mips_topk_block(query, catalog, k=k, block=block or 4096,
                               normalize=normalize, exclude_mask=exclude_mask)
    if method == "fused":
        if block is not None:
            raise ValueError("method='fused' tiles internally; 'block' "
                             "applies to the blocked path only")
        if recall_target != 1.0:
            raise ValueError("method='fused' is exact; recall_target applies "
                             "to method='flat' only")
        from .cuda_mips import mips_topk_fused

        return mips_topk_fused(query, catalog, k=k, normalize=normalize,
                               score_dtype=sd or torch.bfloat16,
                               exclude_mask=exclude_mask)
    q = normalize_embedding(query) if normalize else query
    c = normalize_embedding(catalog) if normalize else catalog
    if exclude_mask is not None:
        exclude_mask = exclude_mask.to(torch.bool)
    nq, n = q.shape[0], c.shape[0]
    if method == "auto":
        itemsize = torch.finfo(sd or torch.float32).bits // 8
        method = "twophase" if nq * n * itemsize <= max_flat_bytes else "blocked"
    if method in ("twophase", "flat"):
        s = _scores(q, c, sd)
        if exclude_mask is not None:
            s = s.masked_fill(exclude_mask, NEG_INF)
        vs, vi = twophase_select(s, k) if method == "twophase" else _topk_lowest_first(s, k)
        return vs.float(), vi
    if method != "blocked":
        raise ValueError(f"unknown method {method!r}")

    block = block or 8192
    best_s = torch.full((nq, k), NEG_INF, dtype=sd or q.dtype, device=q.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=q.device)
    for lo in range(0, n, block):
        blk = c[lo:lo + block]
        s = _scores(q, blk, sd)
        col = torch.arange(lo, lo + block, device=q.device)
        invalid = (col >= n).expand(nq, block)
        if blk.shape[0] < block:   # zero-padded tail block, as the JAX path pads
            s = torch.nn.functional.pad(s, (0, block - blk.shape[0]))
        if exclude_mask is not None:
            invalid = invalid | exclude_mask[:, col.clamp(max=n - 1)]
        s = s.masked_fill(invalid, NEG_INF)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, col.expand(nq, block)], dim=1)
        best_s, pos = _topk_lowest_first(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s.float(), best_i


def twophase_select(s: torch.Tensor, k: int, ch: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a resident (Q, N) score matrix via chunk maxima.

    Phase 1: ``ch``-column chunk maxima and the top ``min(k, nc)`` chunks;
    phase 2: exact selection inside the winning chunks. Exact by chunk
    containment: at most k−1 elements outrank the k-th, so its chunk's max is
    a top-k chunk max. Scores keep ``s.dtype``; indices are column ids.
    """
    nq, n = s.shape
    pad = (-n) % ch
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    nc = (n + pad) // ch
    s3 = s.view(nq, nc, ch)
    cm = s3.amax(dim=-1)                                  # (Q, nc)
    kc = min(k, nc)    # small catalogs: fewer chunks than k is still exact
    _, ci = _topk_lowest_first(cm, kc)                    # winning chunks
    sel = torch.take_along_dim(s3, ci[:, :, None], dim=1)  # (Q, kc, ch)
    vs, vi = _topk_lowest_first(sel.reshape(nq, kc * ch), k)
    chunk = torch.gather(ci, 1, vi // ch)
    return vs, chunk * ch + vi % ch


def pack_mask_tiles(rows: torch.Tensor, cols: torch.Tensor, num_rows: int,
                    num_items: int, n_tile: int = 2048) -> torch.Tensor:
    """Tile-bit-packed exclusion mask: (num_rows, ⌈N/n_tile⌉·n_tile/8) uint8,
    byte-identical to the JAX package's.

    Layout: within each ``n_tile``-column tile, byte b holds the bits of
    columns b, b+n_tile/8, …, b+7·n_tile/8 (bit index = column // (n_tile/8)).
    (row, col) pairs must be distinct: each (row, byte, bit) then appears once
    and the sum is a bitwise OR. The sum runs in int32 and is cast to uint8,
    which wraps as the JAX package's uint8 sum does. Padding pairs use
    ``row == num_rows`` (a sentinel row, sliced off)."""
    nb = n_tile // 8
    width = -(-num_items // n_tile) * nb
    cols = cols.long().clamp(0, num_items - 1)
    within = cols % n_tile
    byte = (cols // n_tile) * nb + within % nb
    bit = (within // nb).int()
    m = torch.zeros((num_rows + 1) * width, dtype=torch.int32, device=cols.device)
    m.index_add_(0, rows.long() * width + byte, torch.ones_like(bit) << bit)
    return m.view(num_rows + 1, width)[:num_rows].to(torch.uint8)


def seen_mask_from_pairs(rows: torch.Tensor, cols: torch.Tensor,
                         num_rows: int, num_cols: int) -> torch.Tensor:
    """(num_rows, num_cols) int8 exclusion mask built on the pairs' device from
    flat (row, col) index pairs. Padding pairs use ``row == num_rows`` (a
    sentinel row, sliced off)."""
    m = torch.zeros((num_rows + 1, num_cols), dtype=torch.int8, device=cols.device)
    m[rows.long(), cols.long().clamp(0, num_cols - 1)] = 1
    return m[:num_rows]


def mips_topk_postfilter(
    query: torch.Tensor,     # (Q, d)
    catalog: torch.Tensor,   # (N, d)
    excl: torch.Tensor,      # (Q, L) int excluded ids, padded with -1
    k: int = 10,
    normalize: bool = True,
    score_dtype: DTypeLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked retrieval as retrieve-then-filter: top-(k+L) through the fused
    unmasked lane, then drop each query's excluded candidates. Exact whenever
    each exclusion list fits the padded width L."""
    from .cuda_mips import mips_topk_fused

    l_pad = excl.shape[1]
    s, i = mips_topk_fused(query, catalog, k=k + l_pad, normalize=normalize,
                           score_dtype=as_dtype(score_dtype) or torch.bfloat16)
    hit = (i[:, :, None] == excl.long()[:, None, :]).any(dim=-1)   # (Q, k+L)
    vs, pos = _topk_lowest_first(s.masked_fill(hit, NEG_INF), k)
    return vs, torch.gather(i, 1, pos)


def excl_matrix_from_pairs(indptr: np.ndarray, items: np.ndarray,
                           l_pad: int) -> np.ndarray:
    """(Q, l_pad) int32 exclusion matrix (−1 padded) from a CSR exclusion
    list — host-side prep for :func:`mips_topk_postfilter`. Raises if any
    row exceeds ``l_pad`` (the exactness bound)."""
    q = indptr.shape[0] - 1
    lens = np.diff(indptr)
    if lens.max(initial=0) > l_pad:
        raise ValueError(f"exclusion list of {int(lens.max())} entries "
                         f"exceeds l_pad={l_pad}; raise l_pad or use the "
                         "masked twophase")
    out = np.full((q, l_pad), -1, np.int32)
    rows = np.repeat(np.arange(q), lens)
    cols = (np.arange(items.shape[0]) - np.repeat(indptr[:-1], lens))
    out[rows, cols] = items
    return out


def merge_topk(
    scores: torch.Tensor,   # (P, Q, k) per-shard winners
    indices: torch.Tensor,  # (P, Q, k) GLOBAL indices
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k candidate sets into the global top-k."""
    p, q, kk = scores.shape
    s = scores.permute(1, 0, 2).reshape(q, p * kk)
    i = indices.permute(1, 0, 2).reshape(q, p * kk)
    top_s, pos = _topk_lowest_first(s, k)
    return top_s, torch.gather(i, 1, pos)


def full_sort_scores(query: torch.Tensor, catalog: torch.Tensor,
                     normalize: bool = True) -> torch.Tensor:
    """Reference-semantics full score matrix (reference recommend.py:39-44),
    the correctness oracle of the top-k tests."""
    q = normalize_embedding(query) if normalize else query
    c = normalize_embedding(catalog) if normalize else catalog
    return q @ c.T
