#!/usr/bin/env python3
"""Where the ELL SpMM kernel's time goes, on one NVIDIA GPU.

    python3 tools/probe_ell_spmm.py [--small] [--root DIR] [--cache DIR]

Builds the ML-25M-width synthetic graph (``--small``: a 20,000 x 8,000 one),
its train split's ``EllGraph`` and a random (N, 64) f32 table, then times with
CUDA events (20 launches after 3 warm-ups), in two alternating rounds: the
whole hop through ``spmm_ell_cuda``; the work list without the side
ordering and with other slot budgets; each bucket's items and each side's
items alone; kernels built from variants of the source (:data:`VARIANTS`:
without the evict-first hint on the slots, other numbers of gathers in
flight, larger blocks, a register cap);
and ``torch.sparse.mm`` on
the CSR of the same matrix. Also prints the work list's host time. Prints
the card's ``nvidia-smi`` line and one JSON object per round.

``--root`` times the wrapper of the package in another checkout instead (the
whole hop and ``torch.sparse.mm`` only), for example an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
``--cache`` keeps the train split's edges in DIR as ``.npy``, so later runs
in the same call skip building the graph.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
#: variant -> [(exact source line, replacement), ...]
VARIANTS = {
    # slot ids and weights loaded without the evict-first hint
    "no_slot_hint": [("constexpr bool kSlotHint = true;", "constexpr bool kSlotHint = false;")],
    # 2 or 8 gathers in flight per group instead of 4
    "k2": [("constexpr int kGatherRegs = 16;", "constexpr int kGatherRegs = 8;")],
    "k8": [("constexpr int kGatherRegs = 16;", "constexpr int kGatherRegs = 32;")],
    # blocks of 8 warps instead of 2
    "t256": [("constexpr int kThreads = 64;", "constexpr int kThreads = 256;")],
    # a register cap: 16 blocks of 2 warps an SM, 64 registers a thread
    "cap64": [("__global__ void __launch_bounds__(kThreads, 1)\n",
               "__global__ void __launch_bounds__(kThreads, 16)\n")],
}


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


def train_edges(small: bool, cache):
    """(train edges, node count) of the synthetic graph."""
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)

    size = (dict(users=20_000, items=8_000, n=1_000_000, c=20) if small
            else dict(users=162_541, items=59_047, n=18_000_000, c=200))
    nodes = size["users"] + size["items"]
    path = None if cache is None else Path(cache) / f"train_e{'_small' if small else ''}.npy"
    if path is not None and path.exists():
        return np.load(path), nodes
    data = make_synthetic_movielens(size["users"], size["items"], size["n"], seed=0,
                                    power=0.9, num_communities=size["c"])
    with tempfile.TemporaryDirectory() as tmp:
        train_e, _, _ = split_edges(data, tmp, seed=0)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, train_e)
    return train_e, nodes


def build_variants(_build) -> dict:
    """{variant: ctypes library} built from patched copies of the source, one
    ``nvcc`` each, all at once."""
    src = (_build.CSRC / "ell_spmm.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for line, repl in edits:
            if line not in text:
                raise SystemExit(f"probe out of date: a line of {name} is not in the source")
            text = text.replace(line, repl)
        path = _build.BUILD_DIR / f"probe_ell_{name}.cu"
        path.write_text(text)
        procs[name] = (path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} build failed:\n{err}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in (out + err).splitlines() if "registers" in ln or "spill" in ln]}),
            flush=True)
        libs[name] = ctypes.CDLL(str(path.with_suffix(".so")))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="a 20,000 x 8,000 graph")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose package is timed (default: this one)")
    ap.add_argument("--cache", type=Path, default=None,
                    help="directory that keeps the train split's edges between runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ell_spmm: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from movie_recommender_system_with_gnns_tpu_torch.data import native
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import EllGraph
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_spmm
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceELL

    if not Path(cuda_spmm.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"probe: the package was not imported from {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    own = root == ROOT
    libs = build_variants(_build) if own else {}
    train_e, n = train_edges(args.small, args.cache)
    d = 64
    g = EllGraph.build(train_e, n)
    ell = DeviceELL.from_host(g, "cuda")
    emb = torch.randn(n, d, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    ref = cuda_spmm.spmm_ell_cuda(ell, emb)
    rowptr, col, w = native.build_csr(train_e[0], train_e[1], n)
    csr = torch.sparse_csr_tensor(
        *(torch.from_numpy(a).to("cuda") for a in (rowptr.astype(np.int32), col, w)),
        size=(n, n))
    head = {"package": str(Path(cuda_spmm.__file__).parent.parent), "nodes": n,
            "edges": int(train_e.shape[1]),
            "buckets": [(b.rows, b.width) for b in g.blocks]}
    cases = {}
    if own:
        sch = ell.schedule
        t0 = time.perf_counter()
        for _ in range(3):
            cuda_spmm.ell_schedule(g.blocks, n, "cuda")
        torch.cuda.synchronize()
        head.update(list_s=(time.perf_counter() - t0) / 3, items=len(sch.items),
                    split_rows=len(sch.split_rows), segments=sch.num_segments,
                    budget=sch.budget)
        out = torch.empty_like(emb)

        def into(schedule=None, graph=ell):
            return lambda: cuda_spmm.ell_spmm_into(graph, emb, out, schedule)

        flat = dataclasses.replace(ell, schedule=cuda_spmm.ell_schedule(
            g.blocks, n, "cuda", by_side=False))
        cases["no_side_order"] = into(graph=flat)
        for budget in (128, 512, 1024):
            other = dataclasses.replace(ell, schedule=cuda_spmm.ell_schedule(
                g.blocks, n, "cuda", budget=budget))
            cases[f"budget{budget}"] = into(graph=other)
        def rows_of(part):
            """The node ids of the rows a part of the work list writes."""
            rows = []
            for x, y, z, _ in part.items:
                if x < 0:
                    x, y = part.split_rows[-1 - x, :2]
                    z = y + 1
                rows.append(ell.blocks[x].node_ids[y:z])
            return torch.cat(rows).long()

        cases_rows = {}
        for key, parts in (("bucket", sch.item_bucket), ("side", sch.item_side)):
            for v in np.unique(parts):
                part = sch.select(parts == v)
                name = f"{key}{ell.blocks[v].nbr.shape[1] if key == 'bucket' else v}"
                cases[name] = into(part)
                cases_rows[name] = rows_of(part)
        # every variant's hop against the package's result
        orig = cuda_spmm._library()
        for name, lib in libs.items():
            def call(lib=lib):
                _build._LIBS["ell_spmm"] = lib
                try:
                    into()()
                finally:
                    _build._LIBS["ell_spmm"] = orig
            cases[name] = call
        # bit-equal where the rows are summed in the same order; another
        # budget cuts other segments (f32 sums in another order)
        for name, fn in cases.items():
            out.zero_()
            first = []
            for _ in range(3):    # the first calls of each case, one by one
                first.append(time_ms(fn, iters=1, warmup=0))
            part = cases_rows.get(name)
            if part is None:
                ok = (torch.equal(out, ref) if not name.startswith("budget")
                      else bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-5)))
            else:
                ok = torch.equal(out[part], ref[part])
            head[f"{name}_ok"] = bool(ok)
            head[f"{name}_first_ms"] = [round(t, 4) for t in first]
    print(json.dumps(head), flush=True)
    for rnd in range(2):
        row = {"round": rnd, "wrapper_ms": time_ms(lambda: cuda_spmm.spmm_ell_cuda(ell, emb))}
        for name, fn in cases.items():
            row[f"{name}_ms"] = time_ms(fn)
        row["sparse_mm_ms"] = time_ms(lambda: torch.sparse.mm(csr, emb))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
