"""Host-side graph structures (JAX package ``data/graph.py``): symmetric GCN edge
weights, the normalized COO edge list that segment-sum propagation reads, and
the degree-bucketed ELL layout that the ELL SpMM kernel reads.

  * :func:`gcn_norm`: ``w(s,d) = deg(s)^-1/2 · deg(d)^-1/2`` (PyG LGConv's
    ``gcn_norm`` with no self-loops); zero-degree nodes get weight 0.
  * :class:`COOGraph`: edges sorted by destination, padded to a static edge
    count with zero-weight edges that target the last node, so the arrays
    equal the JAX package's element for element.
  * :class:`EllGraph`: nodes grouped into degree buckets; each bucket is a
    dense (rows × width) neighbour-index / weight matrix padded to the
    bucket's width. Padding slots point at the phantom row ``num_src`` (the
    source table's row count, ``num_nodes`` unless given) with weight 0.
    Square arrays equal the JAX package's element for element.

Pure NumPy; the arrays move to the device in ``ops/spmm.py`` (``DeviceCOO``,
``DeviceELL``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def compute_degrees(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """In-degree per node over the given (2, E) edge list."""
    return np.bincount(edge_index[1], minlength=num_nodes).astype(np.int64)


def gcn_norm(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Symmetric GCN edge weights, no self-loops (PyG LGConv semantics).

    ``w(e) = deg(src)^-1/2 * deg(dst)^-1/2`` with zero-degree → 0.
    """
    deg = compute_degrees(edge_index, num_nodes).astype(np.float64)
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(deg)
    dinv[~np.isfinite(dinv)] = 0.0
    return (dinv[edge_index[0]] * dinv[edge_index[1]]).astype(np.float32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class COOGraph:
    """Destination-sorted, weight-normalized, pad-to-static COO edge list.

    ``src``/``dst`` are int32 (E_pad,); ``w`` float32 (E_pad,) with zeros on the
    padding tail (pad edges are (0, num_nodes - 1) with w = 0, so ``dst`` stays
    sorted and their contribution is zero). ``num_edges`` is the true edge
    count.
    """

    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    num_nodes: int
    num_edges: int

    @staticmethod
    def build(edge_index: np.ndarray, num_nodes: int, pad_to: int | None = None) -> "COOGraph":
        w = gcn_norm(edge_index, num_nodes)
        order = np.argsort(edge_index[1], kind="stable")
        src = edge_index[0, order].astype(np.int32)
        dst = edge_index[1, order].astype(np.int32)
        w = w[order]
        e = src.shape[0]
        pad = _round_up(max(e, 1), 128) if pad_to is None else pad_to
        if pad < e:
            raise ValueError(f"pad_to={pad} < num_edges={e}")
        if pad > e:
            # pad with zero-weight edges targeting the LAST node id so dst
            # stays sorted
            src = np.concatenate([src, np.zeros(pad - e, np.int32)])
            dst = np.concatenate([dst, np.full(pad - e, num_nodes - 1, np.int32)])
            w = np.concatenate([w, np.zeros(pad - e, np.float32)])
        return COOGraph(src=src, dst=dst, w=w, num_nodes=num_nodes, num_edges=e)


@dataclass(frozen=True)
class EllBlock:
    """One degree bucket: ``rows`` nodes, each padded to ``width`` neighbours.

    ``nbr`` (rows, width) int32 — neighbour node ids; padding entries point at
    the phantom row ``num_src`` (``num_nodes`` for a square graph). ``w``
    (rows, width) float32 — edge weights, zero on padding. ``node_ids``
    (rows,) int32 — global node id of each row, ``num_nodes`` on the rows
    that pad the bucket to ``row_align``.
    """

    node_ids: np.ndarray
    nbr: np.ndarray
    w: np.ndarray

    @property
    def rows(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def width(self) -> int:
        return int(self.nbr.shape[1])


@dataclass(frozen=True)
class EllGraph:
    """Degree-bucketed ELL adjacency: the concatenation of the blocks covers
    every node exactly once; ``inv_perm`` maps node id to its row in the
    concatenated block order. ``num_nodes`` output rows read a source table
    of ``num_src`` rows (``num_nodes`` for a square graph)."""

    blocks: List[EllBlock]
    inv_perm: np.ndarray      # (num_nodes,) int32
    num_nodes: int
    num_edges: int
    num_src: Optional[int] = None

    def __post_init__(self):
        if self.num_src is None:
            object.__setattr__(self, "num_src", self.num_nodes)

    @staticmethod
    def build(
        edge_index: np.ndarray,
        num_nodes: int,
        width_buckets: Sequence[int] = (8, 32, 128, 512, 2048, 8192, 32768),
        row_align: int = 8,
        weights: Optional[np.ndarray] = None,
        num_src: Optional[int] = None,
    ) -> "EllGraph":
        """Bucket nodes by degree; each node lands in the smallest bucket whose
        width holds its whole neighbour list (none is dropped: the last
        bucket's width is the true max degree rounded up to 8).

        The edge weights are ``gcn_norm`` of the given edges, or ``weights``
        (E,) float32 when given: a subset of a larger graph (the hybrid
        propagation's remainder) keeps its graph's global GCN weights.

        ``num_src`` makes the graph rectangular: ``num_nodes`` destination
        rows (``edge_index[1]``) read sources ``edge_index[0]`` of a table of
        ``num_src`` rows, and padding slots point at ``num_src`` (JAX
        ``ChunkedEll.build(num_src=...)``; a shard of the sharded hybrid
        remainder, ``l_rows`` local rows from the ``n_pad``-row gathered
        table). Left None the graph is square and its arrays are those of
        the square build, byte for byte."""
        n_src = num_nodes if num_src is None else int(num_src)
        w_all = (gcn_norm(edge_index, num_nodes) if weights is None
                 else np.asarray(weights, np.float32))
        if w_all.shape != (edge_index.shape[1],):
            raise ValueError(f"weights must be ({edge_index.shape[1]},), got {w_all.shape}")
        dst = edge_index[1].astype(np.int64)
        order = np.argsort(dst, kind="stable")
        dst_s = dst[order]
        src_s = edge_index[0, order].astype(np.int64)
        ws = w_all[order]
        deg = np.bincount(dst_s, minlength=num_nodes)
        rowptr = np.concatenate([[0], np.cumsum(deg)])
        max_deg = int(deg.max(initial=0))
        widths = (sorted(set(int(w) for w in width_buckets if w < max_deg))
                  + [max(_round_up(max_deg, 8), 8)])

        # position of each edge within its destination's neighbour run
        pos_in_row = np.arange(dst_s.shape[0], dtype=np.int64) - rowptr[dst_s]

        blocks: List[EllBlock] = []
        perm_rows: List[np.ndarray] = []
        lo = 0
        for wd in widths:
            sel = (np.flatnonzero((deg > lo) & (deg <= wd)) if lo > 0
                   else np.flatnonzero(deg <= wd))
            lo = wd
            if sel.size == 0:
                continue
            rows = _round_up(sel.size, row_align)
            nbr = np.full((rows, wd), n_src, dtype=np.int32)
            bw = np.zeros((rows, wd), dtype=np.float32)
            # every edge whose destination is in this bucket
            row_of = np.full(num_nodes, -1, dtype=np.int64)
            row_of[sel] = np.arange(sel.size)
            emask = row_of[dst_s] >= 0
            r = row_of[dst_s[emask]]
            c = pos_in_row[emask]
            nbr[r, c] = src_s[emask]
            bw[r, c] = ws[emask]
            node_ids = np.concatenate(
                [sel, np.full(rows - sel.size, num_nodes, np.int64)])
            blocks.append(EllBlock(node_ids=node_ids.astype(np.int32), nbr=nbr, w=bw))
            perm_rows.append(node_ids)

        concat = np.concatenate(perm_rows) if perm_rows else np.zeros(0, np.int64)
        inv_perm = np.zeros(num_nodes, dtype=np.int32)
        valid = concat < num_nodes
        inv_perm[concat[valid]] = np.flatnonzero(valid)
        return EllGraph(blocks=blocks, inv_perm=inv_perm, num_nodes=num_nodes,
                        num_edges=int(edge_index.shape[1]), num_src=n_src)

    @property
    def padding_ratio(self) -> float:
        """ELL slots over true edges."""
        slots = sum(b.rows * b.width for b in self.blocks)
        return slots / max(self.num_edges, 1)


def build_csr(edge_index: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rowptr, col, w) CSR of the normalized adjacency, the on-disk
    interchange format."""
    w = gcn_norm(edge_index, num_nodes)
    order = np.argsort(edge_index[1], kind="stable")
    col = edge_index[0, order].astype(np.int32)
    w = w[order]
    deg = np.bincount(edge_index[1], minlength=num_nodes)
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return rowptr, col, w


def adjacency_is_symmetric(edge_index: np.ndarray, num_nodes: int) -> bool:
    """True iff every directed edge has its mirror (multiset equality).

    Â = Âᵀ holds exactly when the edge list is mirror-complete; edge-level
    90/5/5 splits (reference data/dataset_handler.py:167-168) break this for
    ~2·p·(1−p) of pairs."""
    kf = edge_index[0].astype(np.int64) * num_nodes + edge_index[1]
    kb = edge_index[1].astype(np.int64) * num_nodes + edge_index[0]
    return bool(np.array_equal(np.sort(kf), np.sort(kb)))
