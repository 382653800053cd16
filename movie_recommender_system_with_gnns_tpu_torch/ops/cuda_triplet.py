"""Fused triplet loss of the whole-graph trainers: the standard BPR loss of a
triplet batch and its row gradients from two hand-written CUDA kernels.

The kernels, ``csrc/triplet_loss.cu``, replace no TPU kernel: the JAX package
writes ``ops/bpr.py::bpr_loss_standard`` over gathered rows and leaves its
fusion to XLA. Here the forward reads each valid triplet's rows straight from
the four tables (final and layer-0, users and items) by index and writes the
loss and σ(⟨u,n⟩ − ⟨u,p⟩) per (b, k); the backward reads them again and
writes each row occurrence's gradient, in the layout of the gathered rows
(``ops/bpr.py::triplet_rows``), which :func:`sorted_index_add` sums into
table rows over the same lists as the gather route.

  * :func:`triplet_loss_fused` is the differentiable entry point
    (``ops/bpr.py::triplet_loss_of`` takes it on the card when a gradient is
    taken of the ``standard`` loss);
  * :func:`triplet_fwd` and :func:`triplet_bwd` are the kernels' wrappers.
    They take the plain versions, :func:`triplet_fwd_plain` and
    :func:`triplet_bwd_plain`, only for tensors on the CPU; for CUDA tensors
    they launch the kernels or raise. ``LAUNCHES["triplet_loss"]`` counts
    launches: 2 a fused loss, forward and backward;
  * :func:`triplet_loss_plain` runs both plain versions, as the kernels
    compute them, for the tests and the card's check.

The loss and its scale factors stay on the device (the count of valid
triplets is read there), and no float is summed by atomics: a step through
them is bit-reproducible and waits on nothing, so it can be captured.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import LAUNCHES
from .cuda_scatter import sort_rows, sorted_index_add

DIMS = (32, 64, 128, 256, 512)   # the kernels' row widths

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_triplet_supported(d: int) -> bool:
    """Whether the kernels take rows of width ``d``."""
    return d in DIMS


def _rows(tabs: Tables, user, pos, neg):
    uf_t, if_t, ue_t, ie_t = tabs
    nk = neg.reshape(user.shape[0], -1)
    return (uf_t[user], if_t[pos], if_t[nk], ue_t[user], ie_t[pos], ie_t[nk])


def triplet_fwd_plain(tabs: Tables, user, pos, neg, mask, bpr_coeff: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: (loss (), sig (B, K), stats (2,)
    = (K·C, Cd)), with C the valid triplets' count (at least 1) and Cd
    = max(count·d, 1); sig is σ(⟨u,n⟩ − ⟨u,p⟩), 0 for a masked triplet.
    ``tabs`` = (users final, items final, users layer 0, items layer 0);
    ``neg`` (B,) or (B, K)."""
    uf, pf, nf, ue, pe, ne = _rows(tabs, user, pos, neg)
    k, d = nf.shape[1], nf.shape[2]
    m = mask.bool()
    x = torch.einsum("bd,bkd->bk", uf, nf) - (uf * pf).sum(-1)[:, None]
    z = x.exp()
    big = x > 20.0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    pair = torch.where(m[:, None], torch.where(big, x, z.log1p()), zero).sum()
    sig = torch.where(m[:, None], torch.where(big, torch.ones_like(z), z / (z + 1.0)), zero)
    q = ue.square().sum(-1) + pe.square().sum(-1) + ne.square().sum((1, 2)) / k
    sq = torch.where(m, q, zero).sum()
    count = m.sum().to(x.dtype)
    stats = torch.stack([k * count.clamp_min(1.0), (count * d).clamp_min(1.0)])
    return pair / stats[0] + bpr_coeff * (sq / stats[1]), sig, stats


def triplet_bwd_plain(tabs: Tables, user, pos, neg, mask, sig, stats, ct, bpr_coeff: float
                      ) -> Tables:
    """Plain PyTorch version of the backward: each row occurrence's gradient
    of ``ct`` × the loss, (g_uf (B, d), g_ue (B, d), g_if (B(1+K), d), g_ie
    (B(1+K), d)), the items' positives first and then the negatives
    flattened; a masked triplet's rows are zero."""
    uf, pf, nf, ue, pe, ne = _rows(tabs, user, pos, neg)
    k, d = nf.shape[1], nf.shape[2]
    ct = ct.reshape(()).to(uf.dtype)
    a = sig * (ct / stats[0])                                     # (B, K)
    a_p = -a.sum(1)
    r = torch.where(mask.bool(), 2.0 * bpr_coeff * ct / stats[1], torch.zeros_like(ct))
    g_uf = a_p[:, None] * pf + (a[..., None] * nf).sum(1)
    g_if = torch.cat([a_p[:, None] * uf, (a[..., None] * uf[:, None, :]).reshape(-1, d)])
    g_ie = torch.cat([r[:, None] * pe, ((r / k)[:, None, None] * ne).reshape(-1, d)])
    return g_uf, r[:, None] * ue, g_if, g_ie


def triplet_loss_plain(tabs: Tables, user, pos, neg, mask, bpr_coeff: float,
                       ct: Optional[torch.Tensor] = None):
    """Both plain versions in turn: (loss, sig, g_uf, g_ue, g_if, g_ie) with
    upstream scalar ``ct`` (default 1)."""
    loss, sig, stats = triplet_fwd_plain(tabs, user, pos, neg, mask, bpr_coeff)
    if ct is None:
        ct = torch.ones((), dtype=loss.dtype, device=loss.device)
    return (loss, sig) + triplet_bwd_plain(tabs, user, pos, neg, mask, sig, stats, ct,
                                           bpr_coeff)


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("triplet_loss")
    if lib.triplet_fwd.argtypes is None:
        p = ctypes.c_void_p
        tail = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
        lib.triplet_fwd.argtypes = [p] * 11 + tail
        lib.triplet_fwd.restype = ctypes.c_int
        lib.triplet_bwd.argtypes = [p] * 15 + tail
        lib.triplet_bwd.restype = ctypes.c_int
        lib.triplet_fwd_parts.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.triplet_fwd_parts.restype = ctypes.c_int64
        lib.triplet_loss_error_string.argtypes = [ctypes.c_int]
        lib.triplet_loss_error_string.restype = ctypes.c_char_p
    return lib


def _check(tabs: Tables, user, pos, neg, mask) -> Tuple[int, int, int]:
    """(B, K, d) of validated kernel inputs; raises ``ValueError``."""
    dev = tabs[0].device
    if dev.type != "cuda":
        raise ValueError(f"the triplet loss kernels run on cuda or cpu tensors, got {dev}")
    d = tabs[0].shape[1]
    if not fused_triplet_supported(d):
        raise ValueError(f"the triplet loss kernels take d in {DIMS}, got d={d}")
    for name, t in zip(("users_final", "items_final", "user_emb", "item_emb"), tabs):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != d
                or not t.is_contiguous() or t.device != dev or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous, 16-byte aligned float32 "
                             f"(rows, {d}) on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    b = user.shape[0]
    k = neg.shape[1] if neg.dim() == 2 else 1
    for name, t, shapes, dtype in (("user", user, [(b,)], torch.int64),
                                   ("pos", pos, [(b,)], torch.int64),
                                   ("neg", neg, [(b,), (b, k)], torch.int64),
                                   ("mask", mask, [(b,)], torch.bool)):
        if (t.dtype != dtype or tuple(t.shape) not in shapes or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be contiguous {dtype} {shapes[-1]} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if k < 1:
        raise ValueError("the triplet loss needs at least one negative a triplet")
    return b, k, d


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({lib.triplet_loss_error_string(err).decode()})")


def triplet_fwd(tabs: Tables, user, pos, neg, mask, bpr_coeff: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel: (loss (), sig (B, K), stats (2,)) as
    :func:`triplet_fwd_plain` gives them. Tables (rows, d) contiguous f32;
    ``user``, ``pos`` (B,), ``neg`` (B,) or (B, K) int64 and ``mask`` (B,)
    bool, contiguous. Index values are not checked on the device."""
    if tabs[0].device.type == "cpu":
        return triplet_fwd_plain(tabs, user, pos, neg, mask, bpr_coeff)
    b, k, d = _check(tabs, user, pos, neg, mask)
    lib = _library()
    dev = tabs[0].device
    out = torch.empty(3, dtype=torch.float32, device=dev)
    sig = torch.empty((b, k), dtype=torch.float32, device=dev)
    part = torch.empty((max(lib.triplet_fwd_parts(b, d), 1), 4), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.triplet_fwd(*(t.data_ptr() for t in (*tabs, user, pos, neg, mask, sig,
                                                       part, out)),
                              b, k, d, float(bpr_coeff), stream)
    _raise(lib, err, "triplet_fwd")
    LAUNCHES["triplet_loss"] += 1
    return out[0], sig, out[1:]


def triplet_bwd(tabs: Tables, user, pos, neg, mask, sig, stats, ct, bpr_coeff: float
                ) -> Tables:
    """The backward kernel: (g_uf, g_ue, g_if, g_ie) as
    :func:`triplet_bwd_plain` gives them, from the forward's ``sig`` and
    ``stats`` and the upstream scalar ``ct`` on the device."""
    if tabs[0].device.type == "cpu":
        return triplet_bwd_plain(tabs, user, pos, neg, mask, sig, stats, ct, bpr_coeff)
    b, k, d = _check(tabs, user, pos, neg, mask)
    lib = _library()
    dev = tabs[0].device
    ct = ct.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    g_u = torch.empty((2, b, d), dtype=torch.float32, device=dev)
    g_i = torch.empty((2, b * (1 + k), d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.triplet_bwd(*(t.data_ptr() for t in (*tabs, user, pos, neg, mask, sig,
                                                       stats, ct, g_u[0], g_u[1], g_i[0],
                                                       g_i[1])),
                              b, k, d, float(bpr_coeff), stream)
    _raise(lib, err, "triplet_bwd")
    LAUNCHES["triplet_loss"] += 1
    return g_u[0], g_u[1], g_i[0], g_i[1]


class _FusedTriplet(torch.autograd.Function):
    """Forward runs the forward kernel and keeps its coefficients; backward
    runs the backward kernel and sums each table's gradient rows over the
    lists of :func:`sort_rows`."""

    @staticmethod
    def forward(ctx, uf_t, if_t, ue_t, ie_t, user, pos, neg, mask, u_order, u_starts,
                i_order, i_starts, bpr_coeff):
        tabs = (uf_t, if_t, ue_t, ie_t)
        loss, sig, stats = triplet_fwd(tabs, user, pos, neg, mask, bpr_coeff)
        ctx.save_for_backward(*tabs, user, pos, neg, mask, sig, stats, u_order, u_starts,
                              i_order, i_starts)
        ctx.bpr_coeff = bpr_coeff
        return loss

    @staticmethod
    def backward(ctx, ct):
        (uf_t, if_t, ue_t, ie_t, user, pos, neg, mask, sig, stats, u_order, u_starts,
         i_order, i_starts) = ctx.saved_tensors
        tabs = (uf_t, if_t, ue_t, ie_t)
        g_uf, g_ue, g_if, g_ie = triplet_bwd(tabs, user, pos, neg, mask, sig, stats, ct,
                                             ctx.bpr_coeff)
        nu, ni = uf_t.shape[0], if_t.shape[0]
        need = ctx.needs_input_grad
        grads = [sorted_index_add(g, *lists, rows) if want else None
                 for g, lists, rows, want in ((g_uf, (u_order, u_starts), nu, need[0]),
                                              (g_if, (i_order, i_starts), ni, need[1]),
                                              (g_ue, (u_order, u_starts), nu, need[2]),
                                              (g_ie, (i_order, i_starts), ni, need[3]))]
        return tuple(grads) + (None,) * 9


def triplet_loss_fused(finals: Tuple[torch.Tensor, torch.Tensor],
                       tables: Tuple[torch.Tensor, torch.Tensor], user: torch.Tensor,
                       pos: torch.Tensor, neg: torch.Tensor, mask: torch.Tensor,
                       bpr_coeff: float) -> torch.Tensor:
    """``bpr_loss_standard`` of the triplets' rows in the (user, item)
    ``finals`` and layer-0 ``tables``, differentiable with respect to all
    four, through the kernels (their plain versions on the CPU). ``neg`` (B,)
    or (B, K); ``mask`` (B,) leaves out padded triplets. The table gradients
    are summed by :func:`sorted_index_add` over one :func:`sort_rows` of the
    users and one of the items (positives, then negatives), as the gather
    route sums them. A width the kernels lack raises ``ValueError``."""
    d = tables[0].shape[1]
    if not fused_triplet_supported(d):
        raise ValueError(f"the fused triplet loss takes d in {DIMS}, got d={d}")
    for f, t in zip(finals, tables):
        if f.shape != t.shape:
            raise ValueError(f"a final table {tuple(f.shape)} and its layer-0 table "
                             f"{tuple(t.shape)} must have one shape")
    user = user.to(torch.int64).contiguous()
    pos = pos.to(torch.int64).contiguous()
    neg = neg.to(torch.int64).contiguous()
    items = torch.cat([pos, neg.reshape(-1)])
    u_lists = sort_rows(user, tables[0].shape[0])
    i_lists = sort_rows(items, tables[1].shape[0])
    tabs = [t.contiguous() for t in (*finals, *tables)]
    return _FusedTriplet.apply(*tabs, user, pos, neg, mask.to(torch.bool).contiguous(),
                               *u_lists, *i_lists, float(bpr_coeff))
