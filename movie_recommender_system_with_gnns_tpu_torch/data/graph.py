"""Host-side graph structures (JAX package ``data/graph.py``): symmetric GCN edge
weights and the normalized COO edge list that segment-sum propagation reads.

  * :func:`gcn_norm`: ``w(s,d) = deg(s)^-1/2 · deg(d)^-1/2`` (PyG LGConv's
    ``gcn_norm`` with no self-loops); zero-degree nodes get weight 0.
  * :class:`COOGraph`: edges sorted by destination, padded to a static edge
    count with zero-weight edges that target the last node, so the arrays
    equal the JAX package's element for element.

Pure NumPy; the arrays move to the device in ``ops/spmm.py::DeviceCOO``. The
degree-bucketed ``EllGraph`` waits for the slice that ports the ELL SpMM kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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
