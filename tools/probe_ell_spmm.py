#!/usr/bin/env python3
"""Where the ELL SpMM kernel's time goes, bucket by bucket, on one NVIDIA GPU.

    python3 tools/probe_ell_spmm.py [--small]

Builds the ML-25M-width synthetic graph (``--small``: a 20,000 x 8,000 one),
its train split's ``EllGraph`` and a random (N, 64) f32 table, then times every
bucket's launch (CUDA events, 20 launches after 3 warm-ups) as the package
launches it and, for the wide buckets, with each row ``split`` from 1 to 64.
Prints one line per bucket with its rows, width, true edges and time, and the
sum over buckets beside the whole wrapper and ``torch.sparse.mm`` on the CSR
of the same matrix. The package's own choice of ``split`` is
``ops/cuda_spmm.py::row_split``.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_ell_spmm: CUDA is not available", file=sys.stderr)
        return 1
    from movie_recommender_system_with_gnns_tpu_torch.data import native
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import EllGraph
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import (
        _launch_block, ell_spmm_block, row_split, spmm_ell_cuda)
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceELL

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    size = (dict(users=20_000, items=8_000, n=1_000_000, c=20) if "--small" in sys.argv[1:]
            else dict(users=162_541, items=59_047, n=18_000_000, c=200))
    data = make_synthetic_movielens(size["users"], size["items"], size["n"], seed=0,
                                    power=0.9, num_communities=size["c"])
    with tempfile.TemporaryDirectory() as tmp:
        train_e, _, _ = split_edges(data, tmp, seed=0)
    n, d = data.num_users + data.num_items, 64
    g = EllGraph.build(train_e, n)
    ell = DeviceELL.from_host(g, "cuda")
    emb = torch.randn(n, d, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    ref = spmm_ell_cuda(ell, emb)
    out = torch.empty_like(emb)
    total = 0.0
    for blk in ell.blocks:
        rows, width = blk.nbr.shape
        t = time_ms(lambda: ell_spmm_block(blk, emb, out, n))
        total += t
        real = blk.node_ids[blk.node_ids < n].long()
        ok = torch.allclose(out[real], ref[real], rtol=1e-4, atol=1e-6)
        print(f"bucket rows {rows} width {width}, {int((blk.nbr != n).sum())} edges "
              f"(split {row_split(rows, width)}): {t:.4f} ms; agrees with the whole "
              f"wrapper's rows: {ok}", flush=True)
        if width >= 2048:
            for split in (1, 2, 4, 8, 16, 32, 64):
                if split * 64 > width:
                    break
                t = time_ms(lambda: _launch_block(blk, emb, out, n, split))
                print(f"    split {split}: {t:.4f} ms", flush=True)
    rowptr, col, w = native.build_csr(train_e[0], train_e[1], n)
    csr = torch.sparse_csr_tensor(
        *(torch.from_numpy(a).to("cuda") for a in (rowptr.astype(np.int32), col, w)),
        size=(n, n))
    lib = time_ms(lambda: torch.sparse.mm(csr, emb))
    print(f"one hop, sum over buckets: {total:.4f} ms; whole wrapper "
          f"{time_ms(lambda: spmm_ell_cuda(ell, emb)):.4f} ms; torch.sparse.mm {lib:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
