"""Fused BPR triplet loss for one compact cluster: loss and all embedding
gradients from hand-written CUDA kernels.

The kernels, ``csrc/bpr_tile.cu``, replace the JAX package's
``ops/pallas_bpr.py::_bpr_tile_kernel``. Per valid triplet it gathers the
cluster's ``[propagated ‖ initial]`` user and item rows and the negative's
final row (``propagated[loc]`` when the negative lies in the cluster, else
``initial · scale``), evaluates the reference loss (cosine of L2-normalized
finals, ``softplus(10Δ)``) or the standard one (``softplus(⟨u,n⟩ − ⟨u,p⟩)``)
plus the L2 term on the initial rows, and returns the masked sum with its
gradients for both tables and for the negatives' initial rows. It gathers
exact f32 values (the TPU kernel rounds them to bf16).

  * :func:`fused_bpr_loss` is the differentiable entry point, with the JAX
    function's signature; a ``torch.autograd.Function`` keeps the kernel's
    gradients from the forward launch and scales them in backward.
  * :func:`bpr_tile` is the kernel's wrapper. It takes the plain version,
    :func:`bpr_tile_plain`, only for tensors on the CPU; for CUDA tensors it
    launches the kernel or raises. ``LAUNCHES["bpr_tile"]`` counts launches.
  * :func:`fused_bpr_loss_plain` is the same loss as row gathers and autograd
    (the row-gather route of ``training/compact.py::_triplet_loss``).

No float is summed by atomics: each table row's triplets come with the call
as lists (:class:`BprIncidence`; the compact trainer keeps the user and
positive lists per cluster and takes the negatives' from the step's one sort,
other callers build them with :func:`bpr_incidence`), pass 1 writes each
triplet's gradient coefficients, and pass 2 sums every row and the loss in
an order fixed by the data, so two calls on the same inputs give bit-equal
outputs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ._build import LAUNCHES
from .bpr import triplet_loss
from .cuda_scatter import sort_rows

MAX_DIM = 512   # lanes stride over d with at most 16 elements each


def fused_bpr_supported(u_pad: int, i_pad: int, d: int) -> bool:
    """Whether the kernel takes a cluster of this size.

    The TPU kernel keeps both tables resident in on-chip memory and refuses
    clusters that overflow it. This kernel gathers rows from global memory
    (the tables stay in L2 when they fit and stream from HBM when they do
    not), so no table size is too large; only the row width is bounded.
    """
    return 0 < d <= MAX_DIM


def fused_bpr_loss_plain(fu, u_rows, fi, i_rows, ni, user_local, pos_local,
                         loc, in_cluster, mask, *, scale: float,
                         bpr_coeff: float, loss: str = "reference") -> torch.Tensor:
    """The fused loss as plain PyTorch: row gathers, ``ops/bpr.py``'s loss,
    autograd for the gradients. ``ni`` is (B, d), one negative per triplet."""
    d = fu.shape[1]
    u_cat = torch.cat([fu, u_rows], dim=1)[user_local]          # (B, 2d)
    p_cat = torch.cat([fi, i_rows], dim=1)[pos_local]
    nf = torch.where(in_cluster.bool()[:, None], fi[loc], ni * scale)
    return triplet_loss((u_cat[:, :d], u_cat[:, d:], p_cat[:, :d], p_cat[:, d:], nf, ni),
                        mask.bool(), loss, bpr_coeff)


def bpr_tile_plain(u_tab, i_tab, ni, ul, pl, loc, inc, m, *, scale: float,
                   bpr_coeff: float, loss: str = "reference"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same arguments and outputs:
    (loss (), gu (u_pad, 2d), gi (i_pad, 2d), gni (B, d))."""
    d = ni.shape[1]
    with torch.enable_grad():
        ut = u_tab.detach().requires_grad_(True)
        it = i_tab.detach().requires_grad_(True)
        nt = ni.detach().requires_grad_(True)
        out = fused_bpr_loss_plain(ut[:, :d], ut[:, d:], it[:, :d], it[:, d:],
                                   nt, ul, pl, loc, inc, m, scale=scale,
                                   bpr_coeff=bpr_coeff, loss=loss)
        gu, gi, gni = torch.autograd.grad(out, (ut, it, nt))
    return out.detach(), gu, gi, gni


class BprIncidence(NamedTuple):
    """Each table row's triplets, as the kernel reads them (int32 on the
    kernel's device). A user or positive entry ``e`` stands for the ``kneg``
    triplets ``e·kneg + k``; every list holds its triplets in ascending order.

    user_order / user_start (u_pad + 1): each user row's valid triplets, and
    ``user_start[u_pad]·kneg`` is the valid count; pos_order / pos_start
    (i_pad + 1): each item row's valid positive triplets; neg_order /
    neg_range (2·i_pad): item row ``r``'s in-cluster negatives are
    ``neg_order[neg_range[r]:neg_range[i_pad + r]]``, masked ones skipped.
    """

    user_order: torch.Tensor
    user_start: torch.Tensor
    pos_order: torch.Tensor
    pos_start: torch.Tensor
    neg_order: torch.Tensor
    neg_range: torch.Tensor
    kneg: int = 1


def bpr_incidence(ul, pl, loc, inc, m, u_pad: int, i_pad: int,
                  kneg: int = 1) -> BprIncidence:
    """The lists of one call's triplets, by stable sorts on their device.

    ``kneg > 1`` is the trainer's layout (users, positives and the mask
    repeated per group of ``kneg`` triplets): the user and positive lists are
    built from each group's first triplet, with entries that stand for the
    whole group. The negative lists hold the valid in-cluster triplets of each
    local item row (``loc`` where ``inc``)."""
    valid = m != 0
    sentinel = lambda keys, ok, rows: torch.where(ok, keys, torch.full_like(keys, rows))
    vk = valid[::kneg]
    user_order, user_start = sort_rows(sentinel(ul[::kneg], vk, u_pad), u_pad)
    pos_order, pos_start = sort_rows(sentinel(pl[::kneg], vk, i_pad), i_pad)
    neg_order, neg_start = sort_rows(sentinel(loc, valid & (inc != 0), i_pad), i_pad)
    return BprIncidence(user_order, user_start, pos_order, pos_start, neg_order,
                        torch.cat([neg_start[:-1], neg_start[1:]]), kneg)


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("bpr_tile")
    fn = lib.bpr_tile
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 20 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [
            ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [p]
        fn.restype = ctypes.c_int
        lib.bpr_tile_error_string.argtypes = [ctypes.c_int]
        lib.bpr_tile_error_string.restype = ctypes.c_char_p
    return lib


def _check_incidence(inc: BprIncidence, b: int, u_pad: int, i_pad: int,
                     device) -> None:
    if inc.kneg < 1 or b % inc.kneg:
        raise ValueError(f"incidence kneg={inc.kneg} does not divide B={b}")
    groups = b // inc.kneg
    want = dict(user_order=groups, user_start=u_pad + 1, pos_order=groups,
                pos_start=i_pad + 1, neg_order=b, neg_range=2 * i_pad)
    for name, n in want.items():
        t = getattr(inc, name)
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != device or t.shape[0] < n
                or (name.endswith(("start", "range")) and t.shape[0] != n)):
            raise ValueError(f"incidence.{name} must be contiguous int32 1-D with "
                             f"{n} entries on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def bpr_tile(u_tab, i_tab, ni, ul, pl, loc, inc, m, *, scale: float,
             bpr_coeff: float, loss: str = "reference",
             incidence: Optional[BprIncidence] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call: (loss (), gu (u_pad, 2d), gi (i_pad, 2d), gni (B, d)).

    u_tab (u_pad, 2d), i_tab (i_pad, 2d), ni (B, d): contiguous f32;
    ul, pl, loc (local rows, in range), inc (in-cluster flag) and m (validity)
    are contiguous int32 (B,). ``incidence`` lists each row's triplets; left
    None it is built by :func:`bpr_incidence` from these arrays. The index
    values and the lists are not checked against each other on the device:
    callers build both from the same cluster.
    """
    if loss not in ("reference", "standard"):
        raise ValueError(f"unknown loss {loss!r}")
    if u_tab.device.type == "cpu":
        return bpr_tile_plain(u_tab, i_tab, ni, ul, pl, loc, inc, m, scale=scale,
                              bpr_coeff=bpr_coeff, loss=loss)
    if u_tab.device.type != "cuda":
        raise ValueError(f"bpr_tile runs on cuda or cpu tensors, got {u_tab.device}")
    b, d = ni.shape
    if not fused_bpr_supported(u_tab.shape[0], i_tab.shape[0], d):
        raise ValueError(f"bpr_tile needs 0 < d <= {MAX_DIM}, got d={d}")
    for name, t in (("u_tab", u_tab), ("i_tab", i_tab), ("ni", ni)):
        if (t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous()
                or t.device != u_tab.device):
            raise ValueError(f"{name} must be contiguous float32 2-D on "
                             f"{u_tab.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if u_tab.shape[1] != 2 * d or i_tab.shape[1] != 2 * d:
        raise ValueError(f"tables must be (rows, {2 * d}); got "
                         f"{tuple(u_tab.shape)} and {tuple(i_tab.shape)}")
    for name, t in (("ul", ul), ("pl", pl), ("loc", loc), ("inc", inc), ("m", m)):
        if (t.dtype != torch.int32 or t.shape != (b,) or not t.is_contiguous()
                or t.device != u_tab.device):
            raise ValueError(f"{name} must be contiguous int32 ({b},) on "
                             f"{u_tab.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if b >= 2 ** 31 - 1:
        raise ValueError(f"bpr_tile takes fewer than 2**31 triplets, got {b}")
    u_pad, i_pad = u_tab.shape[0], i_tab.shape[0]
    if incidence is None:
        incidence = bpr_incidence(ul, pl, loc, inc, m, u_pad, i_pad)
    _check_incidence(incidence, b, u_pad, i_pad, u_tab.device)
    return _launch(u_tab, i_tab, ni, ul, pl, loc, inc, m, incidence, scale,
                   bpr_coeff, loss)


def _launch(u_tab, i_tab, ni, ul, pl, loc, inc, m, incidence: BprIncidence,
            scale: float, bpr_coeff: float, loss: str, grid: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Enqueue pass 1 and pass 2 on the current stream for validated inputs;
    every output and scratch buffer comes from ``torch.empty``. ``grid`` > 0
    sets pass 1's block count (the outputs do not depend on it)."""
    lib = _library()
    b, d = ni.shape
    u_pad, i_pad = u_tab.shape[0], i_tab.shape[0]
    dev = u_tab.device
    nu, nit = u_tab.numel(), i_tab.numel()
    outs = torch.empty(nu + nit + 1, dtype=torch.float32, device=dev)
    gu = outs[:nu].view_as(u_tab)
    gi = outs[nu:nu + nit].view_as(i_tab)
    out = outs[nu + nit:]
    gni = torch.empty_like(ni)
    # pass 1's per-triplet records: ru (B, 4) first, for its 16-byte loads,
    # then lt, rp and rn (B, 2) each; un (B,)
    floats = torch.empty(10 * b, dtype=torch.float32, device=dev)
    ints = torch.empty(b, dtype=torch.int32, device=dev)
    ptr = lambda t: t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bpr_tile(
            *map(ptr, (u_tab, i_tab, ni, ul, pl, loc, inc, m, *incidence[:6],
                       out, gu, gi, gni, floats, ints)),
            b, d, u_pad, i_pad, incidence.kneg, float(scale), float(bpr_coeff),
            int(loss == "reference"), int(grid), stream)
    if err != 0:
        raise RuntimeError(f"bpr_tile launch failed: cudaError {err} "
                           f"({lib.bpr_tile_error_string(err).decode()})")
    LAUNCHES["bpr_tile"] += 1
    return out[0], gu, gi, gni


class _FusedBPR(torch.autograd.Function):
    """Forward launches the kernel once and keeps its gradients; backward
    scales them by the incoming cotangent and splits the table halves."""

    @staticmethod
    def forward(ctx, fu, u_rows, fi, i_rows, ni, ul, pl, loc, inc, m,
                scale, bpr_coeff, loss, incidence):
        u_tab = torch.cat([fu, u_rows], dim=1)
        i_tab = torch.cat([fi, i_rows], dim=1)
        out, gu, gi, gni = bpr_tile(u_tab, i_tab, ni.contiguous(), ul, pl, loc,
                                    inc, m, scale=scale, bpr_coeff=bpr_coeff,
                                    loss=loss, incidence=incidence)
        ctx.save_for_backward(gu, gi, gni)
        return out

    @staticmethod
    def backward(ctx, ct):
        gu, gi, gni = ctx.saved_tensors
        d = gni.shape[1]
        return (gu[:, :d] * ct, gu[:, d:] * ct, gi[:, :d] * ct, gi[:, d:] * ct,
                gni * ct) + (None,) * 9


def fused_bpr_loss(fu, u_rows, fi, i_rows, ni, user_local, pos_local, loc,
                   in_cluster, mask, *, scale: float, bpr_coeff: float,
                   loss: str = "reference",
                   incidence: Optional[BprIncidence] = None) -> torch.Tensor:
    """BPR loss (``ops/bpr.py::bpr_loss`` / ``bpr_loss_standard`` semantics)
    through the fused kernel; differentiable w.r.t. the five embedding
    arguments. fu/u_rows (u_pad, d), fi/i_rows (i_pad, d), ni (B, d) f32;
    user_local, pos_local, loc integer (B,); in_cluster, mask bool (B,).
    ``incidence``: the rows' lists (the compact trainer passes the cluster's
    and the step's); left None, :func:`bpr_incidence` builds them."""
    i32 = lambda t: t.to(torch.int32).contiguous()
    return _FusedBPR.apply(fu, u_rows, fi, i_rows, ni, i32(user_local),
                           i32(pos_local), i32(loc), i32(in_cluster), i32(mask),
                           float(scale), float(bpr_coeff), loss, incidence)
