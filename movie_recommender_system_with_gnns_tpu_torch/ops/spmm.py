"""Sparse·dense propagation for LightGCN: ``out = Â @ emb`` (JAX package
``ops/spmm.py``).

  * :class:`DeviceCOO`: a host :class:`~..data.graph.COOGraph` as tensors on
    one device;
  * :func:`spmm_segment`: gather × weight, then ``index_add_`` over the sorted
    destinations; the reference-semantics propagation (PyG LGConv's normalized
    scatter-add, reference models/light_gcn.py:33);
  * :func:`spmm_rows`: the same sum, each row's run of the sorted edges
    summed in edge order by ``ops/cuda_scatter.py::scatter_rows`` and each
    source row's gradient over its run by ``gather_rows``, so two calls or
    two steps on the card give the same bits (the full-node trainer,
    ``train_model``'s evaluations and each shard of the sharded trainer);
  * :func:`make_spmm_chunked`: the same sum over edge chunks, so the
    (E, d) message tensor never exists whole;
  * :class:`DeviceELL` and :func:`spmm_ell`: the degree-bucketed ELL layout
    and its scatter-free propagation (gather, weighted reduce, inverse
    permutation), the plain version of the kernel in ``ops/cuda_spmm.py``;
  * :func:`densify_blocks`: per-block dense ``Â`` from block-tagged COO edges,
    scattered on the device, so a cluster's propagation is a plain matmul;
    :func:`block_matmul` multiplies such blocks (bf16 or f32) with an f32
    result, as the JAX package's ``dot_general`` with f32 accumulation;
  * :class:`HybridGraph`, :func:`build_hybrid_graph` and :func:`spmm_hybrid`:
    the full graph split along a node partition, ``Â = Â_diag + Â_off``
    exactly: dense diagonal blocks and a sparse remainder, summed by a row
    gather (the full-graph trainer's propagation);
  * :func:`spmm_symmetric`: a propagation whose backward is the same
    propagation of the cotangent (``Â = Âᵀ``), with :func:`spmm_hybrid_sym`
    and :func:`spmm_segment_sym`.

The JAX package's remainder is a chunked ELL (``ChunkedEll``,
``spmm_chunked_ell``), a TPU workaround that keeps scatters short. The port
carries every remainder as a degree-bucketed :class:`DeviceELL` on the ELL
SpMM kernel (``ops/cuda_spmm.py``), or as the dst-sorted COO that
:func:`spmm_segment` reads. The chunked ELL's rectangular form, a shard's
local rows summed from the all-gathered table, is a :class:`DeviceELL` with
a source table of its own size (``num_src``; ``parallel/sharding.py``'s
hybrid remainder).
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
    """COOGraph on a device: dst-sorted edges with a static padded length.

    ``num_nodes`` output rows are summed from a table of ``num_src`` rows
    (``num_nodes`` unless given: a shard of ``parallel/sharding.py`` writes
    its local rows from the all-gathered table). ``from_host(...,
    row_runs=True)`` adds the int32 row runs that ``cuda_scatter.sort_rows``
    would give, for :func:`spmm_rows`: ``order`` / ``starts`` of ``dst``
    over ``num_nodes`` rows, ``src_order`` / ``src_starts`` of ``src`` over
    ``num_src`` rows. The four come together or not at all."""

    src: torch.Tensor   # (E_pad,) int32
    dst: torch.Tensor   # (E_pad,) int32, sorted ascending
    w: torch.Tensor     # (E_pad,) float32, zero on padding
    num_nodes: int
    order: Optional[torch.Tensor] = None   # (E_pad,) int32: 0 .. E_pad - 1
    starts: Optional[torch.Tensor] = None  # (num_nodes + 1,) int32
    src_order: Optional[torch.Tensor] = None   # (E_pad,) int32
    src_starts: Optional[torch.Tensor] = None  # (num_src + 1,) int32
    num_src: Optional[int] = None

    def __post_init__(self):
        if self.num_src is None:
            object.__setattr__(self, "num_src", self.num_nodes)
        runs = (self.order, self.starts, self.src_order, self.src_starts)
        if any(r is None for r in runs) and any(r is not None for r in runs):
            raise ValueError("DeviceCOO's row runs come as one set: order, starts, "
                             "src_order and src_starts, or none of them")

    @staticmethod
    def from_host(g: COOGraph, device: DeviceLike = None,
                  row_runs: bool = False) -> "DeviceCOO":
        return DeviceCOO.from_arrays(g.src, g.dst, g.w, g.num_nodes, device, row_runs)

    @staticmethod
    def from_arrays(src: np.ndarray, dst: np.ndarray, w: np.ndarray, num_nodes: int,
                    device: DeviceLike = None, row_runs: bool = False,
                    num_src: Optional[int] = None) -> "DeviceCOO":
        """Upload host arrays (``dst`` sorted) of ``num_nodes`` output rows
        over a source table of ``num_src`` rows (default ``num_nodes``)."""
        from .cuda_scatter import sort_rows_np

        dev = resolve_device(device)
        num_src = num_nodes if num_src is None else int(num_src)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        runs = {}
        if row_runs:
            starts = np.searchsorted(dst, np.arange(num_nodes + 1), side="left")
            src_order, src_starts = sort_rows_np(src, num_src)
            runs = dict(order=torch.arange(dst.shape[0], dtype=torch.int32, device=dev),
                        starts=up(starts.astype(np.int32)),
                        src_order=up(src_order), src_starts=up(src_starts))
        return DeviceCOO(src=up(src), dst=up(dst), w=up(w), num_nodes=num_nodes,
                         num_src=num_src, **runs)


def spmm_segment(coo: DeviceCOO, emb: torch.Tensor) -> torch.Tensor:
    """Reference-semantics propagation: ``out[d] = Σ_e w[e]·emb[src[e]]``."""
    gathered = emb.index_select(0, coo.src) * coo.w[:, None].to(emb.dtype)
    out = torch.zeros((coo.num_nodes, emb.shape[1]), dtype=emb.dtype,
                      device=emb.device)
    return out.index_add(0, coo.dst, gathered)


def spmm_rows(coo: DeviceCOO, emb: torch.Tensor) -> torch.Tensor:
    """:func:`spmm_segment`'s sum with each row summed over its run of the
    sorted edges in edge order (``scatter_rows``; ``index_add`` on the CPU),
    so it is bit-equal from call to call on the card, where ``index_add``'s
    float atomics are not. Needs ``coo``'s row runs (``from_host(...,
    row_runs=True)``). The gather is ``gather_rows``, whose backward sums
    each table row over its run of the edges in order too
    (``sorted_index_add``), so a step through it is as reproducible as its
    forward."""
    from .cuda_scatter import gather_rows, scatter_rows

    if coo.starts is None:
        raise ValueError("spmm_rows needs the graph's row runs: build it with "
                         "DeviceCOO.from_host(..., row_runs=True)")
    if emb.shape[0] != coo.num_src:
        raise ValueError(f"spmm_rows: the table has {emb.shape[0]} rows, the graph "
                         f"gathers from {coo.num_src}")
    rows = gather_rows(emb, coo.src, coo.src_order, coo.src_starts)
    gathered = rows * coo.w[:, None].to(emb.dtype)
    return scatter_rows(gathered, coo.dst, coo.order, coo.starts, coo.num_nodes)


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
    nbr: torch.Tensor       # (rows, width) int32; padding points at num_src
    w: torch.Tensor         # (rows, width) float32, zero on padding


@dataclass(frozen=True)
class DeviceELL:
    """Degree-bucketed ELL adjacency on a device (scatter-free propagation):
    ``num_nodes`` output rows summed from a table of ``num_src`` rows
    (``num_nodes`` unless given: a rectangular shard of the sharded hybrid
    remainder). ``schedule`` is the SpMM kernel's work list over the blocks
    (``ops/cuda_spmm.py::EllSchedule``), built once by :meth:`from_host`."""

    blocks: Tuple[DeviceEllBlock, ...]
    inv_perm: torch.Tensor  # (num_nodes,) int64: node id -> row of the concatenated blocks
    num_nodes: int
    schedule: Optional[object] = None
    num_src: Optional[int] = None

    def __post_init__(self):
        if self.num_src is None:
            object.__setattr__(self, "num_src", self.num_nodes)

    @staticmethod
    def from_host(g: EllGraph, device: DeviceLike = None,
                  src_split: Optional[int] = None) -> "DeviceELL":
        """Upload an :class:`~..data.graph.EllGraph`, the port's or the JAX
        package's (any object with the same NumPy fields; one without
        ``num_src`` is square). The blocks must cover every node exactly
        once (the kernel writes each node's row from its block and nothing
        else), every slot must hold a source row or the padding id
        ``num_src``, and a row's padding slots must trail its neighbours
        (the kernel reads a row up to its first padding id), as
        ``EllGraph.build`` lays them out. ``src_split`` is the first item
        row of a rectangular bipartite graph's source table, for the work
        list's side order (``ops/cuda_spmm.py::ell_schedule``)."""
        dev = resolve_device(device)
        num_src = int(getattr(g, "num_src", None) or g.num_nodes)
        ids = (np.concatenate([np.asarray(b.node_ids) for b in g.blocks])
               if g.blocks else np.zeros(0, np.int64))
        real = ids[ids < g.num_nodes]
        if real.size != g.num_nodes or np.unique(real).size != g.num_nodes:
            raise ValueError("EllGraph blocks do not cover every node exactly once")
        for blk in g.blocks:
            nbr = np.asarray(blk.nbr)
            if nbr.size and (nbr.min() < 0 or nbr.max() > num_src):
                raise ValueError(f"EllGraph block reads row {nbr.min()} or {nbr.max()} of a "
                                 f"source table of {num_src} rows (padding {num_src})")
            pad = nbr == num_src
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
            schedule=ell_schedule(g.blocks, int(g.num_nodes), dev, num_src=num_src,
                                  src_split=src_split),
            num_src=num_src,
        )


def spmm_ell(ell: DeviceELL, emb: torch.Tensor) -> torch.Tensor:
    """Scatter-free propagation over degree-bucketed ELL blocks, plain PyTorch.

    ``emb`` has ``ell.num_src`` rows, the result ``ell.num_nodes``. For each
    bucket: gather (rows, width, d) neighbour rows of the table extended by
    one zero row (where padding slots point), multiply by the edge weights,
    reduce over the width. Products and sums are f32 whatever the table
    type; the result is rounded once to ``emb.dtype``. Block outputs
    concatenate in bucket order; one gather by ``inv_perm`` restores node
    order."""
    if emb.shape[0] != ell.num_src:
        raise ValueError(f"spmm_ell: the table has {emb.shape[0]} rows, the graph reads "
                         f"{ell.num_src}")
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


def _f32_product(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` (2-D or batched 3-D) with both operands in ``a``'s dtype and
    an f32 result: bf16 operands are multiplied exactly and summed in f32.
    CUDA tensors take ``torch.mm`` / ``torch.bmm`` with ``out_dtype``; CPU
    tensors an f32 product of the upcast operands (the CPU build has no
    mixed-output product)."""
    x = x.to(a.dtype)
    if a.dtype == torch.float32:
        return torch.matmul(a, x)
    if a.device.type == "cuda":
        return (torch.bmm if a.dim() == 3 else torch.mm)(a, x, out_dtype=torch.float32)
    return torch.matmul(a.float(), x.float())


class _BlockMatmul(torch.autograd.Function):
    """:func:`block_matmul`; ``adj`` is a constant. The backward is the same
    product with ``adjᵀ`` and the cotangent rounded to ``adj``'s dtype."""

    @staticmethod
    def forward(ctx, adj, x):
        ctx.save_for_backward(adj)
        ctx.x_dtype = x.dtype
        return _f32_product(adj, x)

    @staticmethod
    def backward(ctx, g):
        (adj,) = ctx.saved_tensors
        return None, _f32_product(adj.transpose(-1, -2), g).to(ctx.x_dtype)


def block_matmul(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` for dense adjacency blocks, (P, P) or (K, P, P), in f32 or
    bf16: ``x`` is rounded to ``adj``'s dtype, the result is f32 (``adj`` is
    not differentiated)."""
    return _BlockMatmul.apply(adj, x)


# ---------------------------------------------------------------------------
# Hybrid block-diagonal propagation: Â = Â_diag + Â_off, exactly.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HybridGraph:
    """The full adjacency split along a node partition (JAX ``HybridGraph``).

    Intra-part edges become dense (K, P, P) blocks ``adj[k, dst, src]`` over
    each part's sorted node ids ``ids`` (pad slots repeat a real id, with
    zero rows and columns); the rest is the remainder, as a
    :class:`DeviceELL` (``off_ell``, the ELL SpMM kernel's layout) or a
    dst-sorted :class:`DeviceCOO` (``off``). Every edge carries the GLOBAL GCN
    weight, so ``spmm_hybrid(h, e)`` equals ``spmm_segment`` of the whole
    graph up to summation order with f32 blocks; bf16 blocks round the
    intra-part operands to bf16 (f32 products and sums).

    ``pos`` (N,) is each node's flat (K·P) block slot (a node sits in at most
    one block) and ``cov`` (N,) whether it has one, so the combine is a row
    gather. ``off_ell_t`` is the remainder's transpose (src and dst swapped,
    the same weights), built only for a graph whose propagation is
    differentiated by autograd: the backward of the kernel runs over it."""

    ids: torch.Tensor              # (K, P) int32
    adj: torch.Tensor              # (K, P, P) float32 or bfloat16
    pos: torch.Tensor              # (N,) int32
    cov: torch.Tensor              # (N,) bool
    num_nodes: int
    off: Optional[DeviceCOO] = None
    off_ell: Optional[DeviceELL] = None
    off_ell_t: Optional[DeviceELL] = None


def build_hybrid_graph(
    edge_index: np.ndarray,
    num_nodes: int,
    node_part: np.ndarray,
    num_parts: int,
    align: int = 128,
    block_dtype: DTypeLike = torch.bfloat16,
    max_block_nodes: int = 4096,
    off_format: str = "ell",
    transpose: bool = False,
    device: DeviceLike = None,
) -> HybridGraph:
    """Host-side split of the full (undirected, global-id) edge list
    (JAX ``build_hybrid_graph``; the same ``ids``, ``adj``, ``pos``, ``cov``
    and remainder edges).

    ``node_part`` (num_nodes,) is each node's part (users ‖ items, as
    ``data.partition.partition_assignments`` gives them). ``off_format``:
    ``"ell"`` (the remainder on the ELL SpMM kernel) or ``"coo"`` (the
    segment-sum oracle). ``transpose`` also builds the ELL remainder's
    transpose, for autodiff through the kernel. The blocks are densified on
    ``device``; a part wider than ``max_block_nodes`` raises."""
    from ..data.graph import gcn_norm

    if off_format not in ("ell", "coo"):
        raise ValueError(f"unknown off_format {off_format!r}")
    dev = resolve_device(device)
    src = edge_index[0].astype(np.int64)
    dst = edge_index[1].astype(np.int64)
    w = gcn_norm(edge_index, num_nodes)          # GLOBAL degrees: exactness
    intra = node_part[src] == node_part[dst]

    off = off_ell = off_ell_t = None
    o_src, o_dst, o_w = src[~intra], dst[~intra], w[~intra]
    if off_format == "ell":
        off_ell = DeviceELL.from_host(
            EllGraph.build(np.stack([o_src, o_dst]), num_nodes, weights=o_w), dev)
        if transpose:
            off_ell_t = DeviceELL.from_host(
                EllGraph.build(np.stack([o_dst, o_src]), num_nodes, weights=o_w), dev)
    else:
        order = np.argsort(o_dst, kind="stable")
        o_src, o_dst, o_w = o_src[order], o_dst[order], o_w[order]
        e_pad = ((len(o_src) + align - 1) // align) * align or align
        pad = e_pad - len(o_src)
        # zero-weight padding edges into the last node keep dst sorted
        off = DeviceCOO.from_host(COOGraph(
            src=np.concatenate([o_src, np.zeros(pad, np.int64)]).astype(np.int32),
            dst=np.concatenate([o_dst, np.full(pad, num_nodes - 1, np.int64)]).astype(np.int32),
            w=np.concatenate([o_w, np.zeros(pad, np.float32)]),
            num_nodes=num_nodes, num_edges=len(o_src)), dev)

    # diagonal blocks: the nodes with at least one intra-part edge, per part
    i_src, i_dst, i_w = src[intra], dst[intra], w[intra]
    k = num_parts
    touched = np.zeros(num_nodes, bool)
    touched[i_src] = True
    touched[i_dst] = True
    tnodes = np.flatnonzero(touched)
    tparts = node_part[tnodes]
    order = np.argsort(tparts, kind="stable")
    tnodes, tparts = tnodes[order], tparts[order]
    counts = np.bincount(tparts, minlength=k)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    ranks = np.arange(tnodes.size, dtype=np.int64) - offsets[tparts]
    p_max = int(counts.max()) if tnodes.size else 1
    p_pad = ((p_max + align - 1) // align) * align
    if p_pad > max_block_nodes:
        raise ValueError(
            f"hybrid block width {p_pad} > {max_block_nodes}: use more parts")
    # pad slots repeat a part's last real id (or 0): their adj rows and
    # columns stay zero, so what they gather and give back is exactly zero
    ids = np.zeros((k, p_pad), np.int32)
    ids[tparts, ranks] = tnodes
    last = np.where(counts > 0, ids[np.arange(k), np.maximum(counts - 1, 0)], 0)
    ids = np.where(np.arange(p_pad)[None, :] < counts[:, None], ids, last[:, None])
    local = np.zeros(num_nodes, np.int64)
    local[tnodes] = ranks
    adj = densify_blocks(node_part[i_dst], local[i_dst], local[i_src], i_w,
                         num_blocks=k, width=p_pad, dtype=block_dtype, device=dev)
    pos = np.zeros(num_nodes, np.int64)
    pos[tnodes] = tparts * p_pad + ranks
    return HybridGraph(ids=torch.from_numpy(ids.astype(np.int32)).to(dev), adj=adj,
                       pos=torch.from_numpy(pos.astype(np.int32)).to(dev),
                       cov=torch.from_numpy(touched).to(dev), num_nodes=num_nodes,
                       off=off, off_ell=off_ell, off_ell_t=off_ell_t)


def spmm_hybrid(h: HybridGraph, emb: torch.Tensor) -> torch.Tensor:
    """``Â @ emb`` as dense diagonal blocks plus the remainder, an f32 result
    whatever ``emb``'s dtype (JAX ``spmm_hybrid``): the ELL remainder runs
    the ELL SpMM kernel on the table in f32 (a bf16 table's values exactly),
    the COO remainder :func:`spmm_segment` in the table's dtype; the block
    operands are rounded to the blocks' dtype. Each node takes its block row
    by a gather (``pos``, ``cov``), not a scatter."""
    if h.off_ell is not None:
        from .cuda_spmm import spmm_ell_cuda   # the kernel's module imports this one

        out = spmm_ell_cuda(h.off_ell, emb.float(), transpose=h.off_ell_t)
    else:
        out = spmm_segment(h.off, emb).float()
    k, p = h.ids.shape
    d = emb.shape[1]
    blk_in = emb.index_select(0, h.ids.reshape(-1)).view(k, p, d)
    blk_out = block_matmul(h.adj, blk_in).view(k * p, d)
    contrib = torch.where(h.cov[:, None], blk_out.index_select(0, h.pos),
                          blk_out.new_zeros(()))
    return out + contrib


def spmm_symmetric(spmm_fn: Callable[[object, torch.Tensor], torch.Tensor]
                   ) -> Callable[[object, torch.Tensor], torch.Tensor]:
    """``spmm_fn(graph, emb)`` whose backward is ``spmm_fn(graph, g)``: the
    cotangent of ``Â·E`` is ``Âᵀ·g = Â·g`` for LightGCN's symmetric
    normalized adjacency, so the backward runs the forward's own kernels
    (for the hybrid graph: the blocks and the ELL SpMM kernel) and never a
    transposed scatter. The graph gets no gradient. A ``spmm_fn`` that rounds
    its input (a bfloat16 compute dtype) rounds the cotangent the same way."""

    class _Symmetric(torch.autograd.Function):
        @staticmethod
        def forward(ctx, emb, graph):
            ctx.graph = graph
            return spmm_fn(graph, emb)

        @staticmethod
        def backward(ctx, g):
            return spmm_fn(ctx.graph, g.contiguous()), None

    def prop(graph, emb: torch.Tensor) -> torch.Tensor:
        return _Symmetric.apply(emb, graph)

    return prop


#: symmetric-backward hybrid propagation (the full-graph trainer's)
spmm_hybrid_sym = spmm_symmetric(spmm_hybrid)
#: symmetric-backward segment-sum propagation
spmm_segment_sym = spmm_symmetric(spmm_segment)
