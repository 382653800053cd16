"""Sparse·dense propagation for LightGCN: ``out = Â @ emb`` (JAX package
``ops/spmm.py``).

  * :class:`DeviceCOO`: a host :class:`~..data.graph.COOGraph` as tensors on
    one device;
  * :func:`spmm_segment`: gather × weight, then ``index_add_`` over the sorted
    destinations; the reference-semantics propagation (PyG LGConv's normalized
    scatter-add, reference models/light_gcn.py:33);
  * :func:`densify_blocks`: per-block dense ``Â`` from block-tagged COO edges,
    scattered on the device, so a cluster's propagation is a plain matmul.

The hybrid block-diagonal, chunked-ELL and symmetric-VJP paths wait for the
full-graph trainer's slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.graph import COOGraph
from ..utils.device import DeviceLike, as_dtype, resolve_device
from .topk import DTypeLike


@dataclass(frozen=True)
class DeviceCOO:
    """COOGraph on a device: dst-sorted edges with a static padded length."""

    src: torch.Tensor   # (E_pad,) int32
    dst: torch.Tensor   # (E_pad,) int32, sorted ascending
    w: torch.Tensor     # (E_pad,) float32, zero on padding
    num_nodes: int

    @staticmethod
    def from_host(g: COOGraph, device: DeviceLike = None) -> "DeviceCOO":
        dev = resolve_device(device)
        return DeviceCOO(
            src=torch.from_numpy(g.src).to(dev),
            dst=torch.from_numpy(g.dst).to(dev),
            w=torch.from_numpy(g.w).to(dev),
            num_nodes=g.num_nodes,
        )


def spmm_segment(coo: DeviceCOO, emb: torch.Tensor) -> torch.Tensor:
    """Reference-semantics propagation: ``out[d] = Σ_e w[e]·emb[src[e]]``."""
    gathered = emb.index_select(0, coo.src) * coo.w[:, None].to(emb.dtype)
    out = torch.zeros((coo.num_nodes, emb.shape[1]), dtype=emb.dtype,
                      device=emb.device)
    return out.index_add(0, coo.dst, gathered)


def densify_blocks(blk, dst, src, w, num_blocks: int, width: int,
                   dtype: DTypeLike = torch.bfloat16,
                   check: Optional[bool] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """Scatter-add densification on the device: ``A[blk, dst, src] += w`` into
    dense ``(num_blocks, width, width)`` Â blocks.

    The COO edges behind the blocks are tens of MB where the dense blocks are
    GB, so the edges go to the device and the blocks are built there.
    Accumulation is f32 whatever the storage ``dtype``; the f32 buffer is
    transient (twice the final bf16 array). Inputs may be 1-D (edge-major,
    ``blk`` per edge) or (num_blocks, E) block-major, NumPy arrays or tensors;
    they are flattened. Padding edges must carry ``w == 0`` and in-range
    indices.

    ``check=None`` runs a host-side range check on ``blk``/``dst``/``src``
    whenever they are host NumPy arrays (every build-time call site), so a
    malformed partition raises here instead of faulting in the scatter;
    ``check=True`` forces it for tensors too (one device-to-host copy).
    """
    if check is None:
        check = all(isinstance(a, np.ndarray) for a in (blk, dst, src))
    if check:
        for name, arr, hi in (("blk", blk, num_blocks), ("dst", dst, width),
                              ("src", src, width)):
            a = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
                 else np.asarray(arr)).reshape(-1)
            if a.size and (a.min() < 0 or a.max() >= hi):
                raise ValueError(
                    f"densify_blocks: {name} index out of range "
                    f"[{a.min()}, {a.max()}] vs [0, {hi})")
    dev = resolve_device(device)

    def flat(a, dt):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dev).reshape(-1).to(dt)

    cell = flat(dst, torch.int64) * width + flat(src, torch.int64)
    dense = torch.zeros((int(num_blocks), int(width) * int(width)),
                        dtype=torch.float32, device=dev)
    dense.index_put_((flat(blk, torch.int64), cell), flat(w, torch.float32),
                     accumulate=True)
    return dense.view(num_blocks, width, width).to(as_dtype(dtype))
