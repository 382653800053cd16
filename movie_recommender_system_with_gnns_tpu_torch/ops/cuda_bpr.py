"""Fused BPR triplet loss for one compact cluster: loss and all embedding
gradients from one hand-written CUDA kernel.

The kernel, ``csrc/bpr_tile.cu``, replaces the JAX package's
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

The table gradients are summed with f32 atomics, so their last bits change
from run to run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ._build import LAUNCHES
from .bpr import select_bpr_loss

MAX_DIM = 512   # lanes stride over d with at most 16 elements each


def fused_bpr_supported(u_pad: int, i_pad: int, d: int) -> bool:
    """Whether the kernel takes a cluster of this size.

    The TPU kernel keeps both tables resident in on-chip memory and refuses
    clusters that overflow it. This kernel gathers rows from global memory
    (the tables stay in L2 when they fit and stream from HBM when they do
    not), so no table size is too large; only the row width is bounded.
    """
    return 0 < d <= MAX_DIM


@functools.lru_cache(maxsize=64)
def _weight_numerators(device: torch.device, d: int, bpr_coeff: float,
                       loss: str) -> torch.Tensor:
    """[−1/10 or 1, coeff/d] on ``device``; cached so a step uploads nothing."""
    return torch.tensor([-0.1 if loss == "reference" else 1.0, bpr_coeff / d],
                        dtype=torch.float32, device=device)


def _weights(m: torch.Tensor, d: int, bpr_coeff: float, loss: str) -> torch.Tensor:
    """[w1, w2] on the device, with no host sync: the masked means'
    denominators folded into the per-triplet weights, w1 = −1/(10·count)
    (reference: −mean(sp)/10 + reg) or 1/count (standard: mean(sp) + reg),
    w2 = coeff/(count·d), count = max(sum(m), 1)."""
    return _weight_numerators(m.device, d, bpr_coeff, loss) / m.sum().clamp_min(1)


def fused_bpr_loss_plain(fu, u_rows, fi, i_rows, ni, user_local, pos_local,
                         loc, in_cluster, mask, *, scale: float,
                         bpr_coeff: float, loss: str = "reference") -> torch.Tensor:
    """The fused loss as plain PyTorch: row gathers, ``ops/bpr.py``'s loss,
    autograd for the gradients. ``ni`` is (B, d), one negative per triplet."""
    d = fu.shape[1]
    u_cat = torch.cat([fu, u_rows], dim=1)[user_local]          # (B, 2d)
    p_cat = torch.cat([fi, i_rows], dim=1)[pos_local]
    nf = torch.where(in_cluster.bool()[:, None], fi[loc], ni * scale)
    return select_bpr_loss(loss)(u_cat[:, :d], u_cat[:, d:], p_cat[:, :d],
                                 p_cat[:, d:], nf, ni, bpr_coeff,
                                 mask=mask.bool())


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


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("bpr_tile")
    fn = lib.bpr_tile
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 13 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.bpr_tile_error_string.argtypes = [ctypes.c_int]
        lib.bpr_tile_error_string.restype = ctypes.c_char_p
    return lib


def bpr_tile(u_tab, i_tab, ni, ul, pl, loc, inc, m, *, scale: float,
             bpr_coeff: float, loss: str = "reference"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch: (loss (), gu (u_pad, 2d), gi (i_pad, 2d), gni (B, d)).

    u_tab (u_pad, 2d), i_tab (i_pad, 2d), ni (B, d): contiguous f32;
    ul, pl, loc (local rows, in range), inc (in-cluster flag) and m (validity)
    are contiguous int32 (B,). The index values are not checked on the device:
    callers build them from the cluster's host arrays and ``searchsorted``.
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

    w = _weights(m, d, bpr_coeff, loss)
    nu, nit = u_tab.numel(), i_tab.numel()
    # loss, gu and gi share one zeroed buffer: one memset per launch
    zeros = torch.zeros(nu + nit + 1, dtype=torch.float32, device=u_tab.device)
    gu = zeros[:nu].view_as(u_tab)
    gi = zeros[nu:nu + nit].view_as(i_tab)
    out = zeros[nu + nit:]
    gni = torch.empty_like(ni)
    _launch(u_tab, i_tab, ni, ul, pl, loc, inc, m, w, out, gu, gi, gni,
            scale, loss)
    return out[0], gu, gi, gni


def _launch(u_tab, i_tab, ni, ul, pl, loc, inc, m, w, out, gu, gi, gni,
            scale: float, loss: str) -> None:
    """Enqueue the kernel on the current stream: validated inputs, the weights
    ``w`` (2,), zeroed ``out`` (1,), ``gu`` and ``gi``, and ``gni`` to fill."""
    lib = _library()
    b, d = ni.shape
    with torch.cuda.device(u_tab.device):
        stream = torch.cuda.current_stream(u_tab.device).cuda_stream
        err = lib.bpr_tile(
            u_tab.data_ptr(), i_tab.data_ptr(), ni.data_ptr(), ul.data_ptr(),
            pl.data_ptr(), loc.data_ptr(), inc.data_ptr(), m.data_ptr(),
            w.data_ptr(), out.data_ptr(), gu.data_ptr(), gi.data_ptr(),
            gni.data_ptr(), b, d, float(scale), int(loss == "reference"), stream)
    if err != 0:
        raise RuntimeError(f"bpr_tile launch failed: cudaError {err} "
                           f"({lib.bpr_tile_error_string(err).decode()})")
    LAUNCHES["bpr_tile"] += 1


class _FusedBPR(torch.autograd.Function):
    """Forward launches the kernel once and keeps its gradients; backward
    scales them by the incoming cotangent and splits the table halves."""

    @staticmethod
    def forward(ctx, fu, u_rows, fi, i_rows, ni, ul, pl, loc, inc, m,
                scale, bpr_coeff, loss):
        u_tab = torch.cat([fu, u_rows], dim=1)
        i_tab = torch.cat([fi, i_rows], dim=1)
        out, gu, gi, gni = bpr_tile(u_tab, i_tab, ni.contiguous(), ul, pl, loc,
                                    inc, m, scale=scale, bpr_coeff=bpr_coeff,
                                    loss=loss)
        ctx.save_for_backward(gu, gi, gni)
        return out

    @staticmethod
    def backward(ctx, ct):
        gu, gi, gni = ctx.saved_tensors
        d = gni.shape[1]
        return (gu[:, :d] * ct, gu[:, d:] * ct, gi[:, :d] * ct, gi[:, d:] * ct,
                gni * ct) + (None,) * 8


def fused_bpr_loss(fu, u_rows, fi, i_rows, ni, user_local, pos_local, loc,
                   in_cluster, mask, *, scale: float, bpr_coeff: float,
                   loss: str = "reference") -> torch.Tensor:
    """BPR loss (``ops/bpr.py::bpr_loss`` / ``bpr_loss_standard`` semantics)
    through the fused kernel; differentiable w.r.t. the five embedding
    arguments. fu/u_rows (u_pad, d), fi/i_rows (i_pad, d), ni (B, d) f32;
    user_local, pos_local, loc integer (B,); in_cluster, mask bool (B,)."""
    i32 = lambda t: t.to(torch.int32).contiguous()
    return _FusedBPR.apply(fu, u_rows, fi, i_rows, ni, i32(user_local),
                           i32(pos_local), i32(loc), i32(in_cluster), i32(mask),
                           float(scale), float(bpr_coeff), loss)
