"""Sharded training and retrieval: embedding tables row-sharded over the
``model`` axis of a (data, model) mesh of ``torch.distributed`` ranks (JAX
package ``parallel/sharding.py``).

  * Host layout, arrays equal to the JAX package's: :class:`ShardPlan` pads
    each table to a multiple of ``pm`` rows; :func:`shard_graph` remaps node
    ids into the padded space and splits the edges by the rank that owns
    their destination row, dst-sorted, padded to one length with zero-weight
    edges into the last local row (GCN weights from the true graph, before
    padding); :func:`pad_params` / :func:`unpad_params`; :func:`pad_batch`.
  * The segment path, per layer: :func:`~.mesh.all_gather_rows` of the user
    and item shards over ``model``, then the shard's dst-sorted segment sum
    through ``ops/spmm.py::spmm_rows`` over a rectangular ``DeviceCOO``
    (``l_rows`` outputs from ``n_pad`` sources, both kinds of row run built
    once per shard, :func:`shard_coos`), so a step is bit-reproducible on
    the card; ``spmm_chunks > 1`` sums the edges chunk by chunk as JAX does.
  * The hybrid path: :func:`shard_hybrid_graph` splits the graph along a
    node partition into dense diagonal blocks (with ghost source columns)
    dealt over the model ranks and an off-diagonal remainder sharded by
    destination, :class:`ShardedHybrid`; :func:`shard_hybrid` puts one
    rank's part on its device (:class:`HybridShard`: the blocks densified
    there, the remainder a rectangular ``DeviceELL`` on the ELL SpMM kernel,
    ``l_rows`` rows from ``n_pad`` sources, or the segment path's COO). A
    layer all-gathers the shards, propagates the remainder, multiplies the
    rank's blocks and reduce-scatters their rows
    (:func:`~.mesh.reduce_scatter_rows`); with the symmetric VJP its
    backward is the same layer on the cotangents.
  * :func:`make_sharded_train_step` (either path): BPR data-parallel over
    ``data``, table gradients back through the collectives' transposes,
    one all-reduce of them over ``data``, the global-norm clip over all
    shards, the update on the local shards; :func:`make_sharded_epoch_fn`,
    a whole epoch of hybrid steps over all train positives.
  * :func:`make_sharded_propagate` (eval and serving tables) and
    :func:`make_sharded_mips` (top-k over catalog shards, candidates merged).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config, check_model
from ..data.graph import EllGraph, gcn_norm
from ..models.lightgcn import LightGCNParams, readout_scale
from ..ops.bpr import triplet_loss_of
from ..ops.cuda_spmm import spmm_ell_cuda
from ..ops.sampling import TripletBatch, sample_negative
from ..ops.spmm import DeviceCOO, DeviceELL, block_matmul, densify_blocks, spmm_rows
from ..ops.topk import merge_topk, mips_topk
from ..utils.device import DeviceLike, as_dtype, resolve_device
from .mesh import Mesh, all_gather_rows, all_reduce_, gather_rows_of, reduce_scatter_rows


class ShardedGraph(NamedTuple):
    """Edge shards stacked over the model axis (leading dim = Pm), host
    arrays. ``src`` holds GLOBAL padded node ids; ``dst_local`` indices into
    each shard's local rows (users then items)."""

    src: np.ndarray        # (Pm, E_shard) int32, global padded node id
    dst_local: np.ndarray  # (Pm, E_shard) int32, sorted per shard
    w: np.ndarray          # (Pm, E_shard) float32


@dataclass(frozen=True)
class ShardPlan:
    """Static layout of the padded, sharded problem."""

    num_users: int      # true
    num_items: int      # true
    pm: int             # model-parallel degree
    u_pad: int          # padded user rows (divisible by pm)
    i_pad: int          # padded item rows (divisible by pm)

    @property
    def u_loc(self) -> int:
        return self.u_pad // self.pm

    @property
    def i_loc(self) -> int:
        return self.i_pad // self.pm

    @property
    def n_pad(self) -> int:
        return self.u_pad + self.i_pad

    @staticmethod
    def create(num_users: int, num_items: int, pm: int) -> "ShardPlan":
        rnd = lambda x: ((x + pm - 1) // pm) * pm
        return ShardPlan(num_users, num_items, pm, rnd(num_users), rnd(num_items))


def pad_params(params: LightGCNParams, plan: ShardPlan) -> LightGCNParams:
    """Zero-pad table rows so each divides evenly over the model axis."""
    pad = lambda t, rows: torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0]))
    return LightGCNParams(pad(params.user_emb, plan.u_pad), pad(params.item_emb, plan.i_pad))


def unpad_params(params: LightGCNParams, plan: ShardPlan) -> LightGCNParams:
    return LightGCNParams(params.user_emb[: plan.num_users],
                          params.item_emb[: plan.num_items])


def shard_params(params: LightGCNParams, plan: ShardPlan, m: int) -> LightGCNParams:
    """Model rank ``m``'s rows of PADDED tables, as contiguous copies."""
    return LightGCNParams(
        params.user_emb[m * plan.u_loc:(m + 1) * plan.u_loc].contiguous(),
        params.item_emb[m * plan.i_loc:(m + 1) * plan.i_loc].contiguous())


def gather_params(local: LightGCNParams, mesh: Mesh) -> LightGCNParams:
    """The PADDED tables from every model rank's shard (all-gather over
    ``model``)."""
    return LightGCNParams(gather_rows_of(local.user_emb, mesh.model_group),
                          gather_rows_of(local.item_emb, mesh.model_group))


def _to_padded_ids(nodes: np.ndarray, plan: ShardPlan) -> np.ndarray:
    """True node-id space → padded space (items shift up to ``u_pad``)."""
    shift = plan.u_pad - plan.num_users
    return np.where(nodes >= plan.num_users, nodes + shift, nodes)


def _owner_and_local(nodes: np.ndarray, plan: ShardPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Padded-space node id → (owner device, local row index users‖items)."""
    is_item = nodes >= plan.u_pad
    u_owner = nodes // plan.u_loc
    u_local = nodes % plan.u_loc
    it = nodes - plan.u_pad
    i_owner = it // plan.i_loc
    i_local = plan.u_loc + it % plan.i_loc
    return (
        np.where(is_item, i_owner, u_owner),
        np.where(is_item, i_local, u_local),
    )


def _shard_coo_by_dst(src_p: np.ndarray, dst_p: np.ndarray, w: np.ndarray,
                      plan: ShardPlan) -> ShardedGraph:
    """Partition padded-space COO edges by destination owner; equal-length,
    dst-sorted padded shards (pads point at the last local row with w=0)."""
    own, loc = _owner_and_local(dst_p, plan)
    counts = np.bincount(own, minlength=plan.pm)
    e_shard = int(counts.max(initial=1))
    e_shard = ((e_shard + 127) // 128) * 128
    l_rows = plan.u_loc + plan.i_loc
    src_s = np.zeros((plan.pm, e_shard), np.int32)
    dst_s = np.full((plan.pm, e_shard), l_rows - 1, np.int32)
    w_s = np.zeros((plan.pm, e_shard), np.float32)
    # one global (owner, local-dst) sort, then contiguous slices per shard;
    # padding tails stay dst-sorted for free (real dst <= l_rows-1 = pad dst)
    order = np.lexsort((loc, own))
    src_o, loc_o, w_o = src_p[order], loc[order], w[order]
    ofs = np.concatenate([[0], np.cumsum(counts)])
    for p in range(plan.pm):
        k = int(counts[p])
        src_s[p, :k] = src_o[ofs[p]:ofs[p + 1]]
        dst_s[p, :k] = loc_o[ofs[p]:ofs[p + 1]]
        w_s[p, :k] = w_o[ofs[p]:ofs[p + 1]]
    return ShardedGraph(src_s, dst_s, w_s)


def shard_graph(edge_index: np.ndarray, plan: ShardPlan) -> ShardedGraph:
    """Partition edges by destination owner; emit equal-length padded shards.

    Node ids are remapped into the padded space: users keep their id, items
    shift from ``num_users`` up to ``u_pad``. GCN weights are computed BEFORE
    padding/sharding on the true graph, so sharded propagation sums the same
    terms as the single-device path.
    """
    w = gcn_norm(edge_index, plan.num_users + plan.num_items)
    src_p = _to_padded_ids(edge_index[0].astype(np.int64), plan)
    dst_p = _to_padded_ids(edge_index[1].astype(np.int64), plan)
    return _shard_coo_by_dst(src_p, dst_p, w, plan)


def shard_coos(graph: ShardedGraph, plan: ShardPlan, m: int, device: DeviceLike = None,
               spmm_chunks: int = 1) -> List[DeviceCOO]:
    """Model rank ``m``'s edge shard on ``device``: rectangular
    ``DeviceCOO``s (``l_rows`` outputs from the ``n_pad``-row all-gathered
    table) with both kinds of row run, one per edge chunk. ``spmm_chunks``
    splits the shard into that many equal chunks when it divides the shard's
    length (JAX's condition), else the shard stays whole."""
    l_rows = plan.u_loc + plan.i_loc
    src, dst, w = graph.src[m], graph.dst_local[m], graph.w[m]
    chunks = max(int(spmm_chunks), 1)
    if src.shape[0] % chunks:
        chunks = 1
    c = src.shape[0] // chunks
    return [DeviceCOO.from_arrays(src[lo:lo + c], dst[lo:lo + c], w[lo:lo + c], l_rows,
                                  device, row_runs=True, num_src=plan.n_pad)
            for lo in range(0, src.shape[0], c)]


@dataclass(frozen=True)
class ShardedHybrid:
    """Host build of the sharded hybrid adjacency (JAX ``ShardedHybrid``):
    the node partition's intra-part edges (and the ghost edges) as dense
    diagonal blocks, the rest as a remainder sharded by destination owner.

    ``blk_ids`` (Pm, K_loc, P) int32: each rank's blocks' PADDED-space node
    ids (pad slots repeat a part's last id); ``blk_pos`` (Pm, n_pad) int32:
    each node's flat (K_loc·P) slot in the rank's blocks that owns it, and
    ``blk_cov`` (Pm, n_pad) bool whether it has one: JAX's arrays. The
    blocks themselves stay as their edges, ``blk_edges`` = (global block,
    dst slot, src slot, weight), and are densified on the device one rank
    at a time (:func:`dense_blocks`; stacked over the ranks they are JAX's
    ``blk_adj`` (Pm, K_loc, P, P)), since a full graph's are gigabytes.
    ``off`` is the remainder as the segment path's dst-sorted shards
    (:class:`ShardedGraph`), ``off_counts`` (Pm,) their real edges;
    ``off_format`` says how :func:`shard_hybrid` uploads it: ``"ell"`` a
    rectangular ``DeviceELL`` (:func:`remainder_ell`), ``"coo"`` the
    segment path's ``DeviceCOO``. ``stats`` holds the build's
    ``ghost_cap``, ``absorbed_edges``, ``off_diag_edges`` and
    ``remainder_edges``."""

    blk_ids: np.ndarray
    blk_pos: np.ndarray
    blk_cov: np.ndarray
    blk_edges: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    block_dtype: str
    off: ShardedGraph
    off_counts: np.ndarray
    off_format: str
    stats: Dict[str, int]


def _ghost_edges(src: np.ndarray, dst: np.ndarray, part: np.ndarray, intra: np.ndarray,
                 num_parts: int, n_nodes: int, cap: int) -> np.ndarray:
    """The off-part edges a part's block absorbs as GHOST SOURCE COLUMNS
    (JAX ``shard_hybrid_graph``'s ``ghost_cap`` branch): among the off-part
    edges whose destination is already in its part's block (a node with an
    intra-part edge), each part takes its ``cap - base width`` sources of
    the most such edges (ties to the lower id) and every edge from them.
    Returns the absorbed edges' indices."""
    ik = np.unique(np.concatenate([part[src[intra]] * n_nodes + src[intra],
                                   part[dst[intra]] * n_nodes + dst[intra]]))
    base_width = np.bincount(ik // n_nodes, minlength=num_parts)
    off_idx = np.flatnonzero(~intra)
    dkey = part[dst[off_idx]] * n_nodes + dst[off_idx]
    if ik.size:
        ins = np.searchsorted(ik, dkey)
        ok = (ins < ik.size) & (ik[np.minimum(ins, ik.size - 1)] == dkey)
    else:
        ok = np.zeros(off_idx.size, bool)
    cand = off_idx[ok]
    uk, inv, ucnt = np.unique(part[dst[cand]] * n_nodes + src[cand], return_inverse=True,
                              return_counts=True)
    uq = uk // n_nodes
    order = np.lexsort((-ucnt, uq))
    starts = np.searchsorted(uq[order], np.arange(num_parts))
    rank = np.arange(uk.size) - starts[uq[order]]
    budget = np.maximum(cap - base_width, 0)
    sel = np.zeros(uk.size, bool)
    sel[order[rank < budget[uq[order]]]] = True
    return cand[sel[inv.reshape(-1)]]


def shard_hybrid_graph(edge_index: np.ndarray, plan: ShardPlan, node_part: np.ndarray,
                       num_parts: int, align: int = 128, block_dtype="bfloat16",
                       max_block_nodes: int = 4096, off_format: str = "ell",
                       ghost_cap: int = 0) -> ShardedHybrid:
    """Host-side build of the sharded hybrid adjacency (JAX
    ``shard_hybrid_graph``; the same ids, blocks, positions, coverage,
    remainder edges and stats).

    ``node_part`` (num_users + num_items,) is each TRUE node id's part
    (users ‖ items, ``data.partition.partition_assignments``). GCN weights
    are global (the true graph), so the blocks plus the remainder hold every
    edge once, with its weight: the layer is ``Â`` exactly with f32 blocks.
    The block count is rounded up to a multiple of ``pm`` with all-zero
    filler blocks; rank ``m`` takes parts ``m·K_loc .. (m + 1)·K_loc - 1``.
    A block wider than ``max_block_nodes`` raises ``ValueError``, so a
    caller can cut the graph into more parts.

    ``ghost_cap > 0`` gives each part's block extra columns for its
    busiest off-part sources, up to ``min(ghost_cap, max_block_nodes)``
    nodes (:func:`_ghost_edges`); their edges leave the remainder for the
    block product. Ghosts are columns only: a node's output slot
    (``blk_pos``) belongs to its own part's block, so a foreign part that
    holds it as a ghost does not claim it."""
    if off_format not in ("ell", "coo"):
        raise ValueError(f"unknown off_format {off_format!r}")
    src = edge_index[0].astype(np.int64)
    dst = edge_index[1].astype(np.int64)
    n_nodes = plan.num_users + plan.num_items
    w = gcn_norm(edge_index, n_nodes)
    part = np.asarray(node_part).astype(np.int64)
    intra = part[src] == part[dst]
    blk_edge = intra
    off_diag = int((~intra).sum())
    absorbed = 0
    cap = 0
    if ghost_cap > 0:
        cap = min(int(ghost_cap), int(max_block_nodes))
        ghost = _ghost_edges(src, dst, part, intra, num_parts, n_nodes, cap)
        blk_edge = intra.copy()
        blk_edge[ghost] = True
        absorbed = int(ghost.size)
    stats = dict(ghost_cap=cap, absorbed_edges=absorbed, off_diag_edges=off_diag,
                 remainder_edges=off_diag - absorbed)

    o_dst = _to_padded_ids(dst[~blk_edge], plan)
    off = _shard_coo_by_dst(_to_padded_ids(src[~blk_edge], plan), o_dst, w[~blk_edge], plan)
    off_counts = np.bincount(_owner_and_local(o_dst, plan)[0], minlength=plan.pm)

    # one (part, padded node) key per block node: a part's block is its keys
    # in order; an edge belongs to its DST's part (ghost edges put a foreign
    # source into that part's columns)
    i_src = _to_padded_ids(src[blk_edge], plan)
    i_dst = _to_padded_ids(dst[blk_edge], plan)
    ep = part[dst[blk_edge]]
    npad = plan.n_pad
    keys = np.unique(np.concatenate([ep * npad + i_src, ep * npad + i_dst]))
    key_part = keys // npad
    bounds = np.searchsorted(key_part, np.arange(num_parts + 1))
    counts = np.diff(bounds)
    p_pad = -(-max(int(counts.max(initial=1)), 1) // align) * align
    if p_pad > max_block_nodes:
        raise ValueError(f"sharded hybrid block width {p_pad} > {max_block_nodes}: "
                         "use more parts")
    k_tot = -(-num_parts // plan.pm) * plan.pm
    k_loc = k_tot // plan.pm
    slot = np.arange(keys.size) - bounds[key_part]
    nodes = keys % npad
    ids = np.zeros((k_tot, p_pad), np.int64)
    ids[key_part, slot] = nodes
    # pad slots repeat the part's last id; an empty part's stay 0
    last = np.where(counts > 0, ids[np.arange(num_parts), np.maximum(counts - 1, 0)], 0)
    ids[:num_parts] = np.where(np.arange(p_pad)[None, :] < counts[:, None],
                               ids[:num_parts], last[:, None])
    ls = np.searchsorted(keys, ep * npad + i_src) - bounds[ep]
    ld = np.searchsorted(keys, ep * npad + i_dst) - bounds[ep]
    # only the part that owns a node claims its slot (ghosts sit in foreign
    # parts' keys)
    part_of_padded = np.full(npad, -1, np.int64)
    part_of_padded[_to_padded_ids(np.arange(n_nodes, dtype=np.int64), plan)] = part
    owned = part_of_padded[nodes] == key_part
    m, kl = np.divmod(key_part[owned], k_loc)
    blk_pos = np.zeros((plan.pm, npad), np.int32)
    blk_cov = np.zeros((plan.pm, npad), bool)
    blk_pos[m, nodes[owned]] = kl * p_pad + slot[owned]
    blk_cov[m, nodes[owned]] = True
    return ShardedHybrid(
        blk_ids=ids.astype(np.int32).reshape(plan.pm, k_loc, p_pad), blk_pos=blk_pos,
        blk_cov=blk_cov,
        blk_edges=(ep.astype(np.int32), ld.astype(np.int32), ls.astype(np.int32),
                   w[blk_edge].astype(np.float32)),
        block_dtype=str(block_dtype), off=off, off_counts=off_counts,
        off_format=off_format, stats=stats)


def build_sharded_hybrid(edge_index: np.ndarray, plan: ShardPlan, num_parts: int, *,
                         ghost_cap: int = 0, max_block_nodes: Optional[int] = None,
                         balance_tol: float = 1.1, refine_rounds: Optional[int] = None,
                         seed: int = 0, block_dtype="bfloat16", node_part=None,
                         max_parts: int = 1024):
    """The JAX package's ``bench.py`` loop around :func:`shard_hybrid_graph`:
    the native partition of ``edge_index``'s forward half into ``num_parts``
    parts (``data.partition.partition_assignments``), then the build; a block
    wider than ``max_block_nodes`` (default ``max(4096, ghost_cap)``) doubles
    the parts, up to ``max_parts``, past which the ``ValueError`` stands.
    Given ``node_part``, the build alone at ``num_parts``. Returns ``(graph,
    node_part, num_parts, partition seconds, build seconds)``, the failed
    attempts' seconds included."""
    import time

    from ..data.partition import forward_half, partition_assignments

    nu, n = plan.num_users, plan.num_users + plan.num_items
    cap = max(4096, ghost_cap) if max_block_nodes is None else max_block_nodes
    given = node_part is not None
    uv = None if given else forward_half(edge_index, nu)
    t_part = t_build = 0.0
    while True:
        if not given:
            t0 = time.perf_counter()
            pu, pi = partition_assignments(edge_index, nu, n, num_parts, seed=seed,
                                           balance_tol=balance_tol, uv=uv,
                                           refine_rounds=refine_rounds)
            node_part = np.concatenate([pu, pi])
            t_part += time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            g = shard_hybrid_graph(edge_index, plan, node_part, num_parts,
                                   block_dtype=block_dtype, max_block_nodes=cap,
                                   ghost_cap=ghost_cap)
            t_build += time.perf_counter() - t0
            return g, node_part, num_parts, t_part, t_build
        except ValueError:
            t_build += time.perf_counter() - t0
            if given or num_parts * 2 > max_parts:
                raise
            num_parts *= 2


def dense_blocks(graph: ShardedHybrid, m: int, device: DeviceLike = None) -> torch.Tensor:
    """Model rank ``m``'s dense blocks (K_loc, P, P), ``Â[k, dst, src]`` in
    the build's ``block_dtype``, scattered on ``device``
    (``ops/spmm.py::densify_blocks``)."""
    k_loc, p = graph.blk_ids.shape[1:]
    blk, dst, src, w = graph.blk_edges
    sel = blk // k_loc == m
    return densify_blocks(blk[sel] - m * k_loc, dst[sel], src[sel], w[sel],
                          num_blocks=k_loc, width=p, dtype=graph.block_dtype, device=device)


def remainder_ell(graph: ShardedHybrid, plan: ShardPlan, m: int,
                  transpose: bool = False) -> EllGraph:
    """Model rank ``m``'s remainder as a rectangular ELL: its ``l_rows``
    local rows read the ``n_pad``-row all-gathered table (global padded
    ids; padding slots point at ``n_pad``). ``transpose``: ``Âᵀ`` of it,
    ``n_pad`` rows from ``l_rows`` sources (a row without an edge is
    zero)."""
    k = int(graph.off_counts[m])
    src, dst, w = (a[m, :k] for a in (graph.off.src, graph.off.dst_local, graph.off.w))
    l_rows = plan.u_loc + plan.i_loc
    if transpose:
        return EllGraph.build(np.stack([dst, src]), plan.n_pad, weights=w, num_src=l_rows)
    return EllGraph.build(np.stack([src, dst]), l_rows, weights=w, num_src=plan.n_pad)


@dataclass(frozen=True)
class HybridShard:
    """One model rank's part of a :class:`ShardedHybrid` on its device (JAX
    ``_hybrid_shard``): its blocks ``ids`` (K_loc, P) int32 and ``adj``
    (K_loc, P, P), the combine's ``pos`` / ``cov`` (n_pad,), and its
    remainder: ``off_ell`` (a rectangular ``DeviceELL``, with ``off_ell_t``
    its transpose when the step is differentiated by autograd) or
    ``off_coos`` (the segment path's ``DeviceCOO`` with both row runs)."""

    ids: torch.Tensor
    adj: torch.Tensor
    pos: torch.Tensor
    cov: torch.Tensor
    off_ell: Optional[DeviceELL] = None
    off_ell_t: Optional[DeviceELL] = None
    off_coos: Optional[List[DeviceCOO]] = None


def shard_hybrid(graph: ShardedHybrid, plan: ShardPlan, m: int, device: DeviceLike = None,
                 transpose: bool = False) -> HybridShard:
    """Model rank ``m``'s :class:`HybridShard` on ``device`` (the
    counterpart of :func:`shard_coos`): the blocks densified there, the
    remainder as ``graph.off_format`` says. ``transpose`` also builds the
    rectangular ELL's transpose, which only a step without the symmetric
    VJP reads (B4's backward over ``Âᵀ``)."""
    dev = resolve_device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ell = ell_t = coos = None
    if graph.off_format == "ell":
        ell = DeviceELL.from_host(remainder_ell(graph, plan, m), dev, src_split=plan.u_pad)
        if transpose:
            ell_t = DeviceELL.from_host(remainder_ell(graph, plan, m, transpose=True), dev,
                                        src_split=plan.u_loc)
    else:
        coos = shard_coos(graph.off, plan, m, dev)
    return HybridShard(ids=up(graph.blk_ids[m]), adj=dense_blocks(graph, m, dev),
                       pos=up(graph.blk_pos[m]), cov=up(graph.blk_cov[m]),
                       off_ell=ell, off_ell_t=ell_t, off_coos=coos)


def pad_batch(batch: TripletBatch, pd: int) -> TripletBatch:
    """Pad the triplet batch so it divides evenly over the data axis."""
    b = batch.user.shape[0]
    pad = (-b) % pd
    if pad == 0:
        return batch
    z = lambda a: torch.cat([a, a.new_zeros((pad,))])
    return TripletBatch(z(batch.user), z(batch.pos_item), z(batch.mask))


Layer = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _segment_layer(cfg: Config, plan: ShardPlan, mesh: Mesh, coos: List[DeviceCOO],
                   u: torch.Tensor, i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the segment path (JAX ``local_propagate``'s body):
    all-gather over ``model``, then the shard's segment sum."""
    full = torch.cat([all_gather_rows(u, mesh.model_group),
                      all_gather_rows(i, mesh.model_group)]).to(as_dtype(cfg.model.compute_dtype))
    out = spmm_rows(coos[0], full)
    for coo in coos[1:]:
        out = out + spmm_rows(coo, full)
    return out[:plan.u_loc], out[plan.u_loc:]


def _hybrid_layer(cfg: Config, plan: ShardPlan, mesh: Mesh, g: HybridShard,
                  u: torch.Tensor, i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hybrid layer on the mesh (JAX ``_hybrid_layer``): all-gather the
    shards over ``model`` and cast them to the compute dtype; the remainder
    of this rank's rows (B4 over the rectangular ELL, exact f32, or the
    segment sum); this rank's blocks times their gathered rows (f32 result),
    combined into (n_pad, d) by the permutation gather; the users' and the
    items' rows reduce-scattered over ``model`` apart; the two added. Every
    rank calls the same collectives in the same order, an empty remainder
    or not. As a global operator it is ``Â``, so ``Â = Âᵀ`` makes it its
    own adjoint (:class:`_SymmetricLayer`)."""
    mg = mesh.model_group
    full = torch.cat([all_gather_rows(u, mg),
                      all_gather_rows(i, mg)]).to(as_dtype(cfg.model.compute_dtype))
    if g.off_ell is not None:
        off = spmm_ell_cuda(g.off_ell, full.float(), transpose=g.off_ell_t)
    else:
        off = sum(spmm_rows(coo, full.float()) for coo in g.off_coos)
    k_loc, p = g.ids.shape
    d = full.shape[1]
    blk_in = full.index_select(0, g.ids.reshape(-1)).view(k_loc, p, d)
    blk_out = block_matmul(g.adj, blk_in).view(k_loc * p, d)
    contrib = torch.where(g.cov[:, None], blk_out.index_select(0, g.pos),
                          blk_out.new_zeros(()))
    cu = reduce_scatter_rows(contrib[:plan.u_pad], mg)
    ci = reduce_scatter_rows(contrib[plan.u_pad:], mg)
    return off[:plan.u_loc] + cu, off[plan.u_loc:] + ci


class _SymmetricLayer(torch.autograd.Function):
    """A layer over the pair ``(u, i)`` whose backward is the same layer,
    collectives included, on the cotangent pair (JAX
    ``spmm_symmetric(_hybrid_layer)``): the cotangent of ``Â·x`` is
    ``Âᵀ·g = Â·g``. The forward runs without autograd, so no collective
    is recorded twice."""

    @staticmethod
    def forward(ctx, u, i, layer):
        ctx.layer = layer
        return layer(u, i)

    @staticmethod
    def backward(ctx, gu, gi):
        return (*ctx.layer(gu.contiguous(), gi.contiguous()), None)


def _layer_of(cfg: Config, plan: ShardPlan, mesh: Mesh, graph, hybrid: bool,
              symmetric: bool) -> Layer:
    """The layer over this rank's graph: the segment path's over its
    ``DeviceCOO`` list, the hybrid path's over its :class:`HybridShard`
    (under the symmetric VJP when ``symmetric``)."""
    if hybrid != isinstance(graph, HybridShard):
        want = "a HybridShard (shard_hybrid)" if hybrid else "a DeviceCOO list (shard_coos)"
        raise TypeError(f"the {'hybrid' if hybrid else 'segment'} path takes {want}, "
                        f"got {type(graph).__name__}")
    if not hybrid:
        return partial(_segment_layer, cfg, plan, mesh, graph)
    layer = partial(_hybrid_layer, cfg, plan, mesh, graph)
    if symmetric:
        return lambda u, i: _SymmetricLayer.apply(u, i, layer)
    return layer


def _propagate(cfg: Config, layer: Layer, u_shard: torch.Tensor, i_shard: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K layers; returns this rank's FINAL rows, users and items, by the
    readout's mean of the layers (JAX ``local_propagate`` /
    ``local_propagate_hybrid``)."""
    scale = readout_scale(cfg.model.num_layers, cfg.model.readout)
    u_cur, i_cur = u_shard, i_shard
    acc_u, acc_i = u_shard, i_shard
    for _ in range(cfg.model.num_layers):
        u_cur, i_cur = layer(u_cur, i_cur)
        acc_u = acc_u + u_cur
        acc_i = acc_i + i_cur
    return acc_u * scale, acc_i * scale


def make_sharded_propagate(cfg: Config, mesh: Mesh, plan: ShardPlan, hybrid: bool = False):
    """``fn(local_params, graph) -> LightGCNParams``: this rank's FINAL
    propagated rows (padded, row-sharded over ``model``) from its table
    shards (:func:`shard_params`) and its graph (:func:`shard_coos`, or
    :func:`shard_hybrid` with ``hybrid=True``), for eval and serving
    tables."""
    @torch.no_grad()
    def fn(local: LightGCNParams, graph) -> LightGCNParams:
        layer = _layer_of(cfg, plan, mesh, graph, hybrid, symmetric=False)
        return LightGCNParams(*_propagate(cfg, layer, local.user_emb, local.item_emb))

    return fn


def _local_loss(cfg: Config, mesh: Mesh, params: LightGCNParams, layer: Layer,
                batch: TripletBatch, neg: torch.Tensor) -> torch.Tensor:
    """This data shard's part of the step's loss: the single-device triplet
    loss (``ops/bpr.py::triplet_loss_of`` over the
    all-gathered final and layer-0 tables, masked means over the shard's
    triplets) times the shard's share of the valid triplets, ``local count
    / psum(count, data)``. So each part is the shard's masked SUMS over the
    GLOBAL count, as JAX's ``local_loss`` computes them before its ``psum``
    over ``data``, and the parts of all data ranks add up to the whole
    batch's loss. At ``dp = 1`` the share is exactly 1: the part is the
    full-node step's loss, bit for bit."""
    fu_loc, fi_loc = _propagate(cfg, layer, params.user_emb, params.item_emb)
    mg = mesh.model_group
    finals = all_gather_rows(fu_loc, mg), all_gather_rows(fi_loc, mg)
    tables = all_gather_rows(params.user_emb, mg), all_gather_rows(params.item_emb, mg)
    loss = triplet_loss_of(finals, tables, batch, neg, cfg.train.loss, cfg.train.bpr_coeff)
    local = batch.mask.to(torch.float32).sum()
    return loss * (local / all_reduce_(local.clone(), mesh.data_group).clamp_min(1.0))


def make_sharded_train_step(cfg: Config, mesh: Mesh, plan: ShardPlan, opt,
                            hybrid: bool = False, symmetric: Optional[bool] = None):
    """``step(state, graph, batch, neg) -> (state, loss)``.

    ``state`` is a NamedTuple with ``params`` (this rank's shards of the
    PADDED tables, :func:`shard_params`), ``opt_state`` and ``step``, such as
    ``training/train.py::TrainState``; ``graph`` its part of the graph: the
    segment path's edge shard (:func:`shard_coos`), or with ``hybrid=True``
    its :class:`HybridShard` (:func:`shard_hybrid`); ``batch`` and ``neg``
    the WHOLE step's triplets (size a multiple of ``dp``, :func:`pad_batch`)
    and negatives, the same on every rank: each rank takes its data shard.
    ``loss`` is the whole batch's. ``opt.update(params, grads, opt_state) ->
    (params, opt_state)`` is the update applied to the clipped gradients, in
    place (the trainer passes ``training/train.py::make_adam`` at the
    constant ``cfg.train.lr``, as JAX's ``optax.adam``). ``symmetric``
    (default ``cfg.train.symmetric_vjp``) runs each hybrid layer's backward
    as the same layer on the cotangents, for a symmetric train graph; else
    autograd differentiates through the collectives and B4's transposed
    ELL (``shard_hybrid(..., transpose=True)``; an ELL shard without it is
    refused with ``ValueError``). No fused BPR kernel: the
    loss runs on the full-catalog tables, as JAX's does.

    The gradient's bookkeeping (JAX ``:713-737``): every model rank of a
    data row computes the same loss part, so the all-gathers' backward sums
    ``pm`` equal cotangents into each shard, divided out here (the layers,
    autograd's or the symmetric one, are linear and carry the factor
    through unchanged); each data rank's part covers its own triplets, so
    the table gradients are summed over ``data`` once; the clip's norm sums
    the squares over ``model``, whose shards are disjoint. The padded rows'
    gradients are zero, so they stay zero.
    """
    pm = plan.pm
    dp = mesh.dp
    d_rank = mesh.coords[0]
    max_norm = cfg.train.grad_clip_norm
    sym = bool(cfg.train.symmetric_vjp) if symmetric is None else bool(symmetric)

    def step(state, graph, batch: TripletBatch, neg: torch.Tensor):
        layer = _layer_of(cfg, plan, mesh, graph, hybrid, sym)
        if hybrid and not sym and graph.off_ell is not None and graph.off_ell_t is None:
            raise ValueError("a step without the symmetric VJP differentiates B4 over the "
                             "remainder's transpose: build the shard with "
                             "shard_hybrid(..., transpose=True)")
        b = batch.user.shape[0]
        if b % dp:
            raise ValueError(f"batch of {b} does not split over the data axis {dp}: "
                             "pad it with pad_batch")
        lo, hi = d_rank * (b // dp), (d_rank + 1) * (b // dp)
        local = TripletBatch(batch.user[lo:hi], batch.pos_item[lo:hi], batch.mask[lo:hi])
        leaves = LightGCNParams(*(t.detach().requires_grad_(True) for t in state.params))
        with torch.enable_grad():
            part = _local_loss(cfg, mesh, leaves, layer, local, neg[lo:hi])
            grads = torch.autograd.grad(part, leaves)
        with torch.no_grad():
            flat = torch.cat([g.reshape(-1) for g in grads]) / pm
            all_reduce_(flat, mesh.data_group)
            gu, gi = flat.split([grads[0].numel(), grads[1].numel()])
            grads = (gu.view_as(grads[0]), gi.view_as(grads[1]))
            gsq = all_reduce_(flat.square().sum(), mesh.model_group)
            scale = (max_norm / gsq.sqrt().clamp_min(1e-6)).clamp_max(1.0)
            params, opt_state = opt.update(state.params, [g * scale for g in grads],
                                           state.opt_state)
            loss = all_reduce_(part.detach().clone(), mesh.data_group)
        return state._replace(params=params, opt_state=opt_state,
                              step=state.step + 1), loss

    return step


def sharded_epoch_plan(cfg: Config, e_real: int, dp: int) -> Dict[str, int]:
    """The fused sharded epoch's static plan (JAX ``epoch_fn``'s sizing):
    the batch is ``ceil(e_real / fullgraph_steps)``, or ``batch_size`` when
    set, rounded up to a multiple of 1,024 and at least ``dp · 8``; then
    ``num_steps`` batches cover the ``e_real`` positives, the tail masked."""
    batch = -(-e_real // max(1, cfg.train.fullgraph_steps))
    if cfg.train.batch_size:
        batch = int(cfg.train.batch_size)
    batch = max(-(-batch // 1024) * 1024, dp * 8)
    return dict(e_real=e_real, num_steps=max(1, -(-e_real // batch)), batch=batch)


def make_sharded_epoch_fn(cfg: Config, mesh: Mesh, plan: ShardPlan, opt,
                          hybrid: bool = True, symmetric: Optional[bool] = None):
    """The fused sharded epoch (JAX ``make_sharded_epoch_fn``): ``build(state)
    -> epoch_fn`` for states of this rank's shards (checked), and
    ``epoch_fn(state, graph, user, pos_item, generator, perm=None, neg=None)
    -> (state, loss, plan)``.

    ``user`` / ``pos_item`` are ALL train positives (int32, on the device),
    the same on every rank. The epoch shuffles them on the device with
    ``generator`` (seeded alike on every rank, so a run does not depend on
    the mesh's shape), cuts :func:`sharded_epoch_plan`'s ``num_steps``
    batches (the tail past ``e_real`` masked out of the loss), draws each
    step's uniform negatives from ``generator`` and runs the steps of
    :func:`make_sharded_train_step` in a Python loop that never waits for
    the host. ``loss`` is the mean of the steps' losses weighted by their
    real triplets, a device scalar; ``plan`` the epoch's static plan.
    ``perm`` (e_real,) and ``neg`` (num_steps, batch[, K]) inject the
    shuffle and the negatives, so a test can replay another run's draws."""
    check_model(cfg, "sharded")
    step = make_sharded_train_step(cfg, mesh, plan, opt, hybrid=hybrid, symmetric=symmetric)
    k = cfg.train.num_negatives

    def build(state):
        rows = (state.params.user_emb.shape[0], state.params.item_emb.shape[0])
        if rows != (plan.u_loc, plan.i_loc):
            raise ValueError(f"the epoch takes this rank's shards, ({plan.u_loc}, "
                             f"{plan.i_loc}) rows (shard_params), got {rows}")

        def epoch_fn(state, graph, user: torch.Tensor, pos_item: torch.Tensor,
                     generator: Optional[torch.Generator], perm=None, neg=None):
            dev = user.device
            sp = sharded_epoch_plan(cfg, int(user.shape[0]), mesh.dp)
            e_real, steps, b = sp["e_real"], sp["num_steps"], sp["batch"]
            if perm is None:
                perm = torch.randperm(e_real, generator=generator, device=generator.device)
            idx = torch.cat([torch.as_tensor(perm).to(dev, torch.int64),
                             torch.arange(e_real, steps * b, device=dev)])
            pad = user.new_zeros(steps * b - e_real)
            u = torch.cat([user, pad])[idx].view(steps, b)
            p = torch.cat([pos_item, pad])[idx].view(steps, b)
            m = (idx < e_real).view(steps, b)
            wloss = torch.zeros((), dtype=torch.float32, device=dev)
            for s in range(steps):
                neg_s = (torch.as_tensor(neg[s]).to(dev) if neg is not None
                         else sample_negative(generator, b, plan.num_items, k, device=dev))
                state, loss = step(state, graph, TripletBatch(u[s], p[s], m[s]), neg_s)
                wloss = wloss + loss * m[s].sum()
            return state, wloss / e_real, sp

        return epoch_fn

    return build


def make_sharded_mips(mesh: Mesh, k: int = 10, block: int = 8192):
    """``fn(query, catalog) -> (scores, indices)``: the catalog's rows split
    over ``model`` (its row count a multiple of ``mp``), each rank's top-k
    over its rows (``ops/topk.py::mips_topk``) with global indices, the
    ``(Q, k)`` candidates all-gathered over ``model`` and merged by
    ``merge_topk`` (ties to the lowest index). Queries and catalog are the
    same on every rank."""
    mp, m = mesh.mp, mesh.coords[1]

    @torch.no_grad()
    def fn(query: torch.Tensor, catalog: torch.Tensor):
        rows = catalog.shape[0] // mp
        if rows * mp != catalog.shape[0]:
            raise ValueError(f"catalog of {catalog.shape[0]} rows does not split over "
                             f"the model axis {mp}")
        s, i = mips_topk(query, catalog[m * rows:(m + 1) * rows], k=k,
                         block=min(block, max(rows, 128)))
        i = i + m * rows                                   # globalize
        all_s = gather_rows_of(s.float().contiguous(), mesh.model_group)
        all_i = gather_rows_of(i.contiguous(), mesh.model_group)
        q = query.shape[0]
        return merge_topk(all_s.view(mp, q, k), all_i.view(mp, q, k), k)

    return fn
