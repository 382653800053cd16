"""The benchmark's frozen copy of the port's Cluster-GCN partition
(``data/partition.py::partition_bipartite_greedy`` over the native library),
built from ``benchmark/data/partition.cpp``.

The library is compiled with ``g++`` at first use into
``benchmark/.cache/build/`` under a name hashed from the source and the flags,
so a checkout builds it once and an edited source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "partition.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / ".cache" / "build"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libbench_partition-{h.hexdigest()[:16]}.so"
    if not out.exists():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++, or $CXX) to build the partitioner")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        done = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"partitioner build failed:\n{done.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    for name, args in (
            ("gc_partition_greedy", [i32p, i32p, i64, i64, i64, i32, ctypes.c_uint64,
                                     i32p, i32p]),
            ("gc_partition_refine", [i32p, i32p, i64, i64, i64, i32, i32, ctypes.c_double,
                                     i32p, i32p]),
            ("gc_partition_balance", [i32p, i32p, i64, i64, i32, ctypes.c_double,
                                      i32p, i32p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i64
    _LIB = lib
    return lib


def assignments(edge_index: np.ndarray, num_users: int, num_items: int, num_parts: int,
                seed: int = 0, balance_tol: float = 0.0, refine_rounds: int = 4,
                slack: float = 1.15) -> Tuple[np.ndarray, np.ndarray]:
    """(part of each user, part of each item): the greedy deal, then
    ``refine_rounds`` of refinement under ``slack`` × the mean load, then,
    with ``balance_tol`` > 0, the kept-edge balance pass."""
    head, tail = edge_index[0], edge_index[1]
    fwd = (head < num_users) & (tail >= num_users)
    u = np.ascontiguousarray(head[fwd], np.int32)
    it = np.ascontiguousarray(tail[fwd] - num_users, np.int32)
    pu = np.zeros(num_users, np.int32)
    pi = np.zeros(num_items, np.int32)
    lib, e = _library(), u.shape[0]
    lib.gc_partition_greedy(u, it, e, num_users, num_items, num_parts, seed, pu, pi)
    if refine_rounds > 0:
        lib.gc_partition_refine(u, it, e, num_users, num_items, num_parts, refine_rounds,
                                slack, pu, pi)
    if balance_tol > 0:
        lib.gc_partition_balance(u, it, e, num_users, num_parts, balance_tol, pu, pi)
    return pu, pi


def cluster_edges(edge_index: np.ndarray, num_users: int, num_items: int, num_parts: int,
                  seed: int = 0, balance_tol: float = 0.0) -> List[np.ndarray]:
    """Each part's kept edges, both directions, (2, E_p) int32: an edge is
    kept where its user and its item share a part (Cluster-GCN)."""
    pu, pi = assignments(edge_index, num_users, num_items, num_parts, seed, balance_tol)
    head, tail = edge_index[0], edge_index[1]
    fwd = (head < num_users) & (tail >= num_users)
    u = head[fwd].astype(np.int64)
    it = (tail[fwd] - num_users).astype(np.int64)
    ep = pu[u]
    keep = ep == pi[it]
    u_k, it_k, p_k = u[keep], it[keep], ep[keep]
    out = []
    for p in range(num_parts):
        m = p_k == p
        uu, ii = u_k[m], it_k[m] + num_users
        out.append(np.stack([np.concatenate([uu, ii]),
                             np.concatenate([ii, uu])]).astype(np.int32))
    return out
