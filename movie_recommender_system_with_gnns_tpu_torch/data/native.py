"""ctypes binding to the host graph runtime ``native/graphcore.cpp`` (JAX
package ``data/native.py``): CSR build, greedy partitioning with
label-propagation refinement and the kept-edge balance pass, undirected
doubling, membership hashing, and the mmap ``ratings.csv`` reader.

The port compiles the source itself (``ops/_build.py``, ``g++`` without
``-march=native``, into the package's gitignored ``build/``, keyed by a source
hash) at first use and never loads or writes anything under ``native/``. There
is no NumPy fallback here: if the library cannot be built or loaded, every
function raises with the compiler's message. The NumPy partitioner of
``data/partition.py`` is reached only by asking for it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np


def _library() -> ctypes.CDLL:
    from ..ops import _build

    lib = _build.load("graphcore")
    if lib.gc_build_csr.argtypes is None:
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
        f64 = ctypes.c_double
        signatures = {
            "gc_build_csr": [i32p, i32p, i64, i64, i64p, i32p, f32p],
            "gc_partition_greedy": [i32p, i32p, i64, i64, i64, i32, u64, i32p, i32p],
            "gc_partition_refine": [i32p, i32p, i64, i64, i64, i32, i32, f64,
                                    i32p, i32p],
            "gc_partition_balance": [i32p, i32p, i64, i64, i32, f64, i32p, i32p],
            "gc_to_undirected": [i32p, i32p, i64, i64, i32p, i32p],
            "gc_member_hashes": [i32p, i32p, i64, u64p],
            "gc_count_csv_lines": [ctypes.c_char_p],
            "gc_load_ratings_csv": [ctypes.c_char_p, ctypes.c_float, i32p, i32p],
        }
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.restype = i64
            fn.argtypes = argtypes
    return lib


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dst-sorted GCN-normalized CSR ``(rowptr, col, w)``."""
    lib = _library()
    e = src.shape[0]
    rowptr = np.zeros(num_nodes + 1, np.int64)
    col = np.zeros(e, np.int32)
    w = np.zeros(e, np.float32)
    lib.gc_build_csr(_i32(src), _i32(dst), e, num_nodes, rowptr, col, w)
    return rowptr, col, w


def partition_greedy(u: np.ndarray, it: np.ndarray, num_users: int,
                     num_items: int, num_parts: int, seed: int = 0,
                     refine_rounds: int = 4, slack: float = 1.15,
                     balance_tol: float = 0.0
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Node partition assignment (users, items) + kept-half-edge count.

    Greedy degree-balanced init, then ``refine_rounds`` of capacity-constrained
    label propagation (``slack`` × the mean part size is the capacity). With
    ``balance_tol`` > 0 a final pass caps every part's intra-cluster edge
    count at tol × the mean: that count sets the padded triplet width of
    every train step."""
    lib = _library()
    u32, it32 = _i32(u), _i32(it)
    pu = np.zeros(num_users, np.int32)
    pi = np.zeros(num_items, np.int32)
    e = u32.shape[0]
    kept = lib.gc_partition_greedy(u32, it32, e, num_users, num_items,
                                   num_parts, seed, pu, pi)
    if refine_rounds > 0:
        kept = lib.gc_partition_refine(u32, it32, e, num_users, num_items,
                                       num_parts, refine_rounds, slack, pu, pi)
    if balance_tol > 0:
        kept = lib.gc_partition_balance(u32, it32, e, num_users, num_parts,
                                        balance_tol, pu, pi)
    return pu, pi, int(kept)


def to_undirected(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Double and coalesce edges; (2, M) int32, sorted."""
    lib = _library()
    out_s = np.zeros(2 * src.shape[0], np.int32)
    out_d = np.zeros(2 * src.shape[0], np.int32)
    m = lib.gc_to_undirected(_i32(src), _i32(dst), src.shape[0], num_nodes,
                             out_s, out_d)
    return np.stack([out_s[:m], out_d[:m]])


def member_hashes(u: np.ndarray, it: np.ndarray) -> np.ndarray:
    """Sorted unique Cantor hashes of (user, item) pairs."""
    lib = _library()
    out = np.zeros(u.shape[0], np.uint64)
    m = lib.gc_member_hashes(_i32(u), _i32(it), u.shape[0], out)
    return out[:m]


def load_ratings_csv(path: str, min_rating: float) -> Tuple[np.ndarray, np.ndarray]:
    """``ratings.csv`` ingest: mmap + threaded parse with the ``rating >=
    min_rating`` filter fused in, file order preserved. Returns (userId,
    movieId) int32 arrays."""
    lib = _library()
    n = lib.gc_count_csv_lines(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    users = np.empty(n, np.int32)
    movies = np.empty(n, np.int32)
    kept = lib.gc_load_ratings_csv(path.encode(), min_rating, users, movies)
    if kept < 0:
        raise FileNotFoundError(path)
    return users[:kept], movies[:kept]
