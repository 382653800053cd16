"""XSimGCL's in-batch InfoNCE, fused: ``csrc/infonce.cu`` on the card, its
plain version on the CPU.

``InfoNCE(A, B) = mean_i [ -â_i·b̂_i/τ + log Σ_j exp(â_i·b̂_j/τ) ]`` over the
first ``count`` rows of A and B, with â, b̂ the rows over their L2 norms
(SELFRec's ``InfoNCE`` with ``b_cos``); gradients flow into both.

  * :func:`infonce` is the loss. The rows are normalised by autograd, then
    rounded to the operand dtype (:func:`round_operands`; ``bfloat16`` on
    the card) and handed to :class:`_InfoNCE`, whose forward keeps each
    row's log-sum-exp only and whose backward recomputes the logits:
    ``dÂ = (P·B̂ − B̂)/(τ n)``, ``dB̂ = (Pᵀ·Â − Â)/(τ n)``, with
    ``P = exp(ÂB̂ᵀ/τ − lse)`` rounded to the operand dtype as the second
    products' operand. ``count`` is a (1,) int32 tensor on the rows' device:
    the kernels read it there, so nothing waits for the card.
  * On CUDA tensors the three kernels run (forward, then the backward's two,
    one per view), or the call raises; ``LAUNCHES["infonce_fwd"]`` and
    ``["infonce_bwd"]`` count them, and the ``infonce.launch`` counter too
    while tracing is on. On the CPU the plain version runs, in blocks of
    rows, with the same roundings.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.device import as_dtype
from ..utils.observability import count as count_event
from ..utils.observability import trace_span
from ._build import LAUNCHES

#: widths the kernels are built for
KERNEL_DIMS = (32, 64)
#: rows of the plain version's blocks (a block's logits: BLOCK × n floats)
BLOCK = 4096
#: the kernels take 1/τ as every row's largest logit (unit rows) and sum
#: exp((s − 1)/τ), which stays inside f32's range while 2·log2(e)/τ < 126
MIN_TEMPERATURE = 0.025


def round_operands(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The products' operand: ``x`` (float32) rounded to ``dtype``."""
    return x.to(dtype).contiguous()


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("infonce")
    if lib.infonce_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.infonce_fwd.argtypes = [p, p, p, p, i, i, f, p]
        lib.infonce_fwd.restype = i
        lib.infonce_bwd.argtypes = [p, p, p, p, p, i, i, f, i, p]
        lib.infonce_bwd.restype = i
        lib.infonce_error_string.argtypes = [i]
        lib.infonce_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _library().infonce_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def lse_cuda(qa: torch.Tensor, qb: torch.Tensor, count: torch.Tensor, tau: float
             ) -> torch.Tensor:
    """``csrc/infonce.cu::infonce_fwd_kernel``: each row's log-sum-exp."""
    cap, d = qa.shape
    lse = torch.empty(cap, dtype=torch.float32, device=qa.device)
    with torch.cuda.device(qa.device):
        err = _library().infonce_fwd(qa.data_ptr(), qb.data_ptr(), count.data_ptr(),
                                     lse.data_ptr(), cap, d, math.log2(math.e) / tau,
                                     _stream(qa))
    _check(err, "infonce_fwd")
    LAUNCHES["infonce_fwd"] += 1
    count_event("infonce.launch")
    return lse


def pmul_cuda(x: torch.Tensor, y: torch.Tensor, lse: torch.Tensor, count: torch.Tensor,
              tau: float, column_bias: bool) -> torch.Tensor:
    """``csrc/infonce.cu::infonce_bwd_kernel``: ``Σ_c bf16(P_rc)·y_c``, the
    bias ``lse[r]`` (``column_bias`` False) or ``lse[c]``."""
    cap, d = x.shape
    out = torch.empty((cap, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().infonce_bwd(x.data_ptr(), y.data_ptr(), lse.data_ptr(),
                                     count.data_ptr(), out.data_ptr(), cap, d,
                                     math.log2(math.e) / tau, int(column_bias), _stream(x))
    _check(err, "infonce_bwd")
    LAUNCHES["infonce_bwd"] += 1
    count_event("infonce.launch")
    return out


def lse_plain(qa: torch.Tensor, qb: torch.Tensor, count: torch.Tensor, tau: float
              ) -> torch.Tensor:
    """Plain version of :func:`lse_cuda`, in blocks of :data:`BLOCK` rows."""
    cap = qa.shape[0]
    n = int(count.reshape(-1)[0])
    a, b = qa[:n].float(), qb[:n].float()
    lse = torch.zeros(cap, dtype=torch.float32, device=qa.device)
    for i in range(0, n, BLOCK):
        e = min(i + BLOCK, n)
        lse[i:e] = torch.logsumexp(a[i:e] @ b.T / tau, dim=1)
    return lse


def grads_plain(qa: torch.Tensor, qb: torch.Tensor, lse: torch.Tensor, count: torch.Tensor,
                tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the two :func:`pmul_cuda` calls: ``(P·B̂, Pᵀ·Â)``,
    P rounded to the operands' dtype."""
    cap, d = qa.shape
    n = int(count.reshape(-1)[0])
    a, b = qa[:n].float(), qb[:n].float()
    pa = torch.zeros((cap, d), dtype=torch.float32, device=qa.device)
    pb = torch.zeros((cap, d), dtype=torch.float32, device=qa.device)
    for i in range(0, n, BLOCK):
        e = min(i + BLOCK, n)
        p = torch.exp(a[i:e] @ b.T / tau - lse[i:e, None]).to(qa.dtype).float()
        pa[i:e] = p @ b
        pb[:n] += p.T @ a[i:e]
    return pa, pb


def _check_inputs(ahat: torch.Tensor, bhat: torch.Tensor, count: torch.Tensor,
                  dtype: torch.dtype, temperature: float) -> None:
    if ahat.shape != bhat.shape or ahat.dim() != 2:
        raise ValueError(f"the two views must be (n, d) of one shape, got "
                         f"{tuple(ahat.shape)} and {tuple(bhat.shape)}")
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != ahat.device:
        raise ValueError(f"count must be one int32 on {ahat.device}, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")
    if ahat.device.type == "cuda":
        if dtype != torch.bfloat16:
            raise ValueError(f"the fused InfoNCE takes bfloat16 operands on the card, "
                             f"not {dtype}")
        if temperature < MIN_TEMPERATURE:
            raise ValueError(f"the fused InfoNCE takes a temperature of at least "
                             f"{MIN_TEMPERATURE} (its terms' range in f32), got {temperature}")
        if ahat.shape[1] not in KERNEL_DIMS:
            raise ValueError(f"the fused InfoNCE is built for d in {KERNEL_DIMS}, "
                             f"got d={ahat.shape[1]}")
    elif ahat.device.type != "cpu":
        raise ValueError(f"infonce runs on cuda or cpu tensors, got {ahat.device}")


class _InfoNCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ahat, bhat, count, tau, dtype):
        with trace_span("xsimgcl.infonce"):
            qa, qb = round_operands(ahat, dtype), round_operands(bhat, dtype)
            cuda = qa.device.type == "cuda"
            lse = (lse_cuda if cuda else lse_plain)(qa, qb, count, tau)
            valid = torch.arange(qa.shape[0], device=qa.device) < count
            diag = (qa.float() * qb.float()).sum(-1) / tau
            n = count.float().clamp_min(1.0)
            loss = torch.where(valid, lse - diag, 0.0).sum() / n[0]
        ctx.save_for_backward(qa, qb, lse, count)
        ctx.tau = tau
        return loss

    @staticmethod
    def backward(ctx, g):
        qa, qb, lse, count = ctx.saved_tensors
        tau = ctx.tau
        with trace_span("xsimgcl.infonce_bwd"):
            if qa.device.type == "cuda":
                pa = pmul_cuda(qa, qb, lse, count, tau, column_bias=False)
                pb = pmul_cuda(qb, qa, lse, count, tau, column_bias=True)
            else:
                pa, pb = grads_plain(qa, qb, lse, count, tau)
            valid = (torch.arange(qa.shape[0], device=qa.device) < count)[:, None]
            scale = g / (tau * count.float().clamp_min(1.0))
            da = torch.where(valid, (pa - qb.float()) * scale, 0.0)
            db = torch.where(valid, (pb - qa.float()) * scale, 0.0)
        return da, db, None, None, None


def infonce(a: torch.Tensor, b: torch.Tensor, count: torch.Tensor, temperature: float,
            dtype="bfloat16") -> torch.Tensor:
    """The mean InfoNCE of the first ``count`` rows of the views ``a`` and
    ``b`` (each (cap, d), float32), both normalised here; rows past
    ``count`` are ignored and get zero gradients. ``dtype`` is the products'
    operand dtype (``bfloat16``, or ``float32`` on the CPU)."""
    dtype = as_dtype(dtype)
    ahat, bhat = F.normalize(a, dim=-1), F.normalize(b, dim=-1)
    _check_inputs(ahat, bhat, count, dtype, float(temperature))
    return _InfoNCE.apply(ahat, bhat, count, float(temperature), dtype)
