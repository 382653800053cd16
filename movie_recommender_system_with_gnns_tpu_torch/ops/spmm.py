"""Sparse·dense propagation for LightGCN: ``out = Â @ emb`` (JAX package
``ops/spmm.py``).

  * :class:`DeviceCOO`: a host :class:`~..data.graph.COOGraph` as tensors on
    one device;
  * :func:`spmm_segment`: gather × weight, then ``index_add_`` over the sorted
    destinations; the reference-semantics propagation (PyG LGConv's normalized
    scatter-add, reference models/light_gcn.py:33);
  * :func:`make_spmm_chunked`: the same sum over edge chunks, so the
    (E, d) message tensor never exists whole;
  * :class:`DeviceELL` and :func:`spmm_ell`: the degree-bucketed ELL layout
    and its scatter-free propagation (gather, weighted reduce, inverse
    permutation), the plain version of the kernel in ``ops/cuda_spmm.py``;
  * :func:`densify_blocks`: per-block dense ``Â`` from block-tagged COO edges,
    scattered on the device, so a cluster's propagation is a plain matmul.

The hybrid block-diagonal, chunked-ELL and symmetric-VJP paths wait for the
full-graph trainer's slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.graph import COOGraph, EllGraph
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


def make_spmm_chunked(num_chunks: int
                      ) -> Callable[[DeviceCOO, torch.Tensor], torch.Tensor]:
    """Edge-chunked propagation for memory-bounded full-graph steps: a loop
    over ``num_chunks`` equal edge chunks that accumulates into the (N, d)
    output, so the extra memory is (E / num_chunks, d). The padded edge count
    must divide by ``num_chunks``."""

    def spmm_chunked(coo: DeviceCOO, emb: torch.Tensor) -> torch.Tensor:
        e_pad = coo.src.shape[0]
        if e_pad % num_chunks != 0:
            raise ValueError(f"padded edge count {e_pad} not divisible by "
                             f"num_chunks={num_chunks}")
        c = e_pad // num_chunks
        out = torch.zeros((coo.num_nodes, emb.shape[1]), dtype=emb.dtype,
                          device=emb.device)
        for lo in range(0, e_pad, c):
            msg = (emb.index_select(0, coo.src[lo:lo + c])
                   * coo.w[lo:lo + c, None].to(emb.dtype))
            out.index_add_(0, coo.dst[lo:lo + c], msg)
        return out

    return spmm_chunked


class DeviceEllBlock(NamedTuple):
    node_ids: torch.Tensor  # (rows,) int32; num_nodes on rows that pad the bucket
    nbr: torch.Tensor       # (rows, width) int32; padding points at num_nodes
    w: torch.Tensor         # (rows, width) float32, zero on padding


@dataclass(frozen=True)
class DeviceELL:
    """Degree-bucketed ELL adjacency on a device (scatter-free propagation).
    ``schedule`` is the SpMM kernel's work list over the blocks
    (``ops/cuda_spmm.py::EllSchedule``), built once by :meth:`from_host`."""

    blocks: Tuple[DeviceEllBlock, ...]
    inv_perm: torch.Tensor  # (num_nodes,) int64: node id -> row of the concatenated blocks
    num_nodes: int
    schedule: Optional[object] = None

    @staticmethod
    def from_host(g: EllGraph, device: DeviceLike = None) -> "DeviceELL":
        """Upload an :class:`~..data.graph.EllGraph`, the port's or the JAX
        package's (any object with the same NumPy fields). The blocks must
        cover every node exactly once (the kernel writes each node's row
        from its block and nothing else), and a row's padding slots must
        trail its neighbours (the kernel reads a row up to its first padding
        id), as ``EllGraph.build`` lays them out."""
        dev = resolve_device(device)
        ids = (np.concatenate([np.asarray(b.node_ids) for b in g.blocks])
               if g.blocks else np.zeros(0, np.int64))
        real = ids[ids < g.num_nodes]
        if real.size != g.num_nodes or np.unique(real).size != g.num_nodes:
            raise ValueError("EllGraph blocks do not cover every node exactly once")
        for blk in g.blocks:
            pad = np.asarray(blk.nbr) == g.num_nodes
            if (pad[:, :-1] & ~pad[:, 1:]).any():
                raise ValueError("EllGraph block has a neighbour behind a padding "
                                 "slot; padding must trail each row")

        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

        from .cuda_spmm import ell_schedule   # the kernel's module imports this one

        return DeviceELL(
            blocks=tuple(DeviceEllBlock(up(b.node_ids, np.int32), up(b.nbr, np.int32),
                                        up(b.w, np.float32)) for b in g.blocks),
            inv_perm=up(g.inv_perm, np.int64),
            num_nodes=int(g.num_nodes),
            schedule=ell_schedule(g.blocks, int(g.num_nodes), dev),
        )


def spmm_ell(ell: DeviceELL, emb: torch.Tensor) -> torch.Tensor:
    """Scatter-free propagation over degree-bucketed ELL blocks, plain PyTorch.

    For each bucket: gather (rows, width, d) neighbour rows of the table
    extended by one zero row (where padding slots point), multiply by the
    edge weights, reduce over the width. Products and sums are f32 whatever
    the table type; the result is rounded once to ``emb.dtype``. Block outputs
    concatenate in bucket order; one gather by ``inv_perm`` restores node
    order."""
    emb_pad = torch.cat([emb, emb.new_zeros((1, emb.shape[1]))]).float()
    outs = [torch.einsum("rw,rwd->rd", blk.w, emb_pad[blk.nbr.long()])
            for blk in ell.blocks]
    return torch.cat(outs)[ell.inv_perm].to(emb.dtype)


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
