#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --mesh-only]

``--kernels-only`` stops after phase 3 (a new kernel's first, short run).
``--mesh-only`` (two or more cards) runs after the build only the meshes of
several cards against the 1×1 mesh (``mesh_cards_only``).

Phases:
  1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
     power limit;
  2. build every kernel from the sources in this checkout (one ``nvcc`` per
     source) and the host graph runtime (``g++``), all started together;
  3. each kernel against its plain PyTorch version. ``score_chunkmax``: random
     normalized inputs, d in {64, 128, 256}, ragged N, masks none / int8 /
     packed, bf16 and f32; then the bf16 lane at n_tile 1024, 3072 and 4096,
     one 128-row band, a band count that does not divide over the SMs, d in
     {8, 24, 320} and a last valid column inside a mask tile. ``bpr_tile``: d
     in {16, 64, 128, 256}, both losses, ragged B, negatives all / none /
     partly in the cluster, one user in most triplets, one item the positive
     of over 800, negatives equal to their positive, a masked tail, every
     triplet masked, four negatives per positive (also through the trainer's
     grouped lists); each case with the lists ``bpr_incidence`` builds from
     its own inputs, bit-equal over two calls and over two grids of pass 1;
     then timed at its reference shape, pass by pass. ``sorted_index_add``:
     repeated ids, a row with hundreds of entries, rows with none, d in
     {16, 64, 100} f32 and d = 64 bf16, bit-equal to the plain version's
     sequential sum on the host and over two calls.
     ``ell_spmm``: d in {16, 64, 100, 256}, f32 and bf16 tables, a graph with
     an isolated node and a hub whose bucket is grown to the max degree (its
     row split into many segments), aligned and unaligned row counts, and a
     graph whose rows all read higher ids (one side of the work list empty),
     weights that are not the graph's own gcn_norm, a remainder with a third
     of its rows empty (d = 256), the transpose of an asymmetric graph and
     the backward over it; every case bit-equal over two calls. ``mips_block``: with and without mask,
     N no multiple of the block, k in {1, 10, 100}, Q no multiple of the query
     band, a row with fewer than k live columns, planted exact ties, d in
     {64, 100}; then d = 30 (4-byte copies), d = 256 and k = 1000 (candidate
     buffers in global scratch); every case bit-equal over two calls;
  4. the serving path at ML-25M width (``bench.py``'s ``SCALES["full"]``:
     162,541 users x 59,047 items, 18 M sampled interactions, d = 64): split,
     seeded random weights through save/load, ``ServingIndex.build`` over
     the train split, 32,768-user masked ``batch_recommend`` dispatches;
     1,024 of the served users are held against the plain version;
  5. the training path at the same width, on the same graph and split: 100
     clusters from the native partitioner (greedy + label-propagation
     refinement), compact clusters, dense bf16 adjacency blocks where
     they fit the configured width (the segment path otherwise), then
     ``train_model`` for 2 epochs (compact trainer, fused BPR kernel, Adam,
     L = 3, d = 64) with the best-val checkpoint; one cluster's gradients
     through the kernel against the plain route (both on the f32 segment
     path), and through its dense bf16 block against the segment path; one
     step run twice from the same state, bit-equal in parameters and Adam
     moments, on the dense bf16 block and on the segment path;
  5a. the lazy-row optimizers on the same clusters: ``hybrid_adam`` (the
     JAX package's headline optimizer) through ``train_model`` for 2 epochs
     from the Adam run's initial tables and epoch generators; one step of
     each of ``lazy_adam``, ``hybrid_adam`` and ``lazy_item_adam`` run twice
     from the same state, bit-equal in parameters and both moment tables, on
     the dense bf16 block and on the segment path; from fresh moments,
     hybrid's item table against Adam's (1e-6 of its largest entry) and
     lazy-item's tables against hybrid's (rtol 1e-6, atol 1e-7) after one
     step; each optimizer's update with host syncs made errors (the gradient
     code's first sync, if any, logged); then for Adam and each of the three
     a third, timed epoch (peak memory) and a profiled window of 10 steps;
  5b. eval and propagated serving at the same width, with the checkpoint of
     phase 5: ``compute_serving_tables(mode="propagated")`` through the ELL
     SpMM kernel (one launch per hop) against ``spmm_segment`` propagation,
     ``evaluate_full_ranking`` with layer-0 and with propagated tables
     (10,000 sampled users, k = 10; 1,000 of them against a run on the host),
     ``batch_recommend_users(method="pallas")`` for 256 users with train-seen
     exclusion against ``method="twophase"``;
  5c. the full-graph trainer (the JAX package's quality flagship) on the
     interaction split of the same graph: L = 3, d = 256, 100 hybrid parts
     (bf16 diagonal blocks, the remainder on the ELL SpMM kernel), 8
     popularity negatives, 16 steps an epoch, cosine lr. Host set-up times;
     ``spmm_hybrid`` against ``spmm_segment`` of the whole train graph (f32
     blocks within 1e-5 of the largest entry, bf16 blocks within their
     operand rounding); the symmetric VJP's table gradients through
     ``compute_loss`` against autodiff through ``spmm_segment`` (rel < 1e-4);
     the transposed backward on a small edge-split graph; one step twice,
     bit-equal; ``sorted_index_add`` and ``gather_rows``' gradient at one
     step's users and items (d = 256), bit-equal to the plain version on the
     host and within 1e-5 of the largest entry of ``index_add_`` on the card,
     both timed; 10 M alias draws within 5 sigma of count^0.75; ``train_model``
     for 2 epochs (falling losses, 6 ELL launches a step, no plain hop); a
     timed third epoch, 4 steps under the profiler, and the ELL kernel at the
     remainder's shape beside ``torch.sparse.mm`` and the block product, in
     one ``[fullgraph]`` JSON line;
  5d. full-state checkpoints, elastic recovery and exact-feasible negatives
     (``recovery_phase``): 10 M feasible draws against the train split's
     member table, equal to the rule run on the host from the same
     candidates, residual train pairs within 5 sigma of Σ (deg_u/I)^(R+1);
     ``hybrid_adam`` with the fused kernel under feasible negatives (200 B1
     launches, falling losses, a step bit-equal over two runs, its step time
     and launches beside uniform negatives'); the compact trainer (4 epochs)
     and the full-graph trainer at ``FG`` (3 epochs, B4 counted) recovered
     from a drop before their first checkpoint and one after epoch 1,
     ``torch.equal`` to uninterrupted runs in tables, moments, count, step,
     histories, best-val checkpoint and one ``metrics.jsonl`` row per epoch;
     the save and load seconds of both full states; a state saved on the
     card, loaded on the CPU and saved again, byte-equal; ``cli train
     --max-retries 1 --negatives feasible --fused-bpr --optimizer
     hybrid_adam``, in one ``[recovery]`` JSON line;
  5e. the multi-device slice (``mesh_phase``) on a one-rank NCCL group (a
     1×1 mesh; with two or more cards also 2×1 and 1×2, one card a rank):
     the sharded step at a batch of 2^20 train positives against the
     single-device full-node step, both bit-equal over two runs (fault C5),
     timed with their launches and collective calls; the data-parallel
     compact epoch with the fused BPR kernel against the single-device
     epoch; the mesh's propagated tables and full-ranking eval against the
     single-device ones; ``cli train --mesh 1x1 --full-eval`` at the small
     size; one ``[mesh]`` JSON line;
  6. trained -> served: the checkpoint of phase 5 behind the ``ServingIndex``
     for one 32,768-user dispatch; then the CLI at a small synthetic size:
     ``train --fused-bpr --full-eval --epochs 1``, the three ``recommend``
     modes and ``recommend --propagated``, and ``train --optimizer
     hybrid_adam --fused-bpr`` beside its own checkpoint;
  7. each kernel timed at its main-path shape beside its plain version, one
     library call where one computes the same function, and its bound.

Kernel launches are counted per path: the counts are set to 0 just before a
path is driven and read just after. Prints the card's ``nvidia-smi`` line and
a ``{"kernels": [...]}`` line, and as its last line ``{"ok": true, "device":
{...}}``. Any failed check exits non-zero without that line. Exits non-zero
when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke_work"
#: bench.py SCALES["full"]: ML-25M statistics with 200 planted communities
FULL = dict(users=162_541, items=59_047, interactions=18_000_000,
            communities=200, power=0.9, dim=64)
DISPATCH = 32_768
DISPATCHES = 5
TOP_K = 10
SEED = 0
#: published dense peaks (bytes/s, bf16 FLOP/s), NVIDIA data sheets
PEAKS = {
    "H100 SXM": (3.35e12, 989e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
}
#: published f32 rate outside the tensor cores (FLOP/s), NVIDIA data sheet
F32_FLOPS = 67e12
#: published dense TF32 tensor-core rate (FLOP/s), NVIDIA data sheet
TF32_FLOPS = 495e12
#: the training path: reference defaults (100 clusters, L = 3, d = 64)
TRAIN = dict(clusters=100, layers=3, epochs=2)
#: the full-graph phase: the JAX flagship's configuration
#: (runs/ml25m_fg150_k8_d256_pop.log), 2 epochs
FG = dict(dim=256, layers=3, parts=100, steps=16, negatives=8, lr=3e-3, warmup=32,
          epochs=2)
#: the CLI phase's synthetic graph (its host work stays a few seconds)
SMALL = dict(users=20_000, items=8_000, interactions=1_000_000,
             communities=20, power=0.9, clusters=10)
KERNEL_ROWS = {
    "score_chunkmax": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/score_chunkmax.cu",
        replaces="movie_recommender_system_with_gnns_tpu/ops/pallas_mips.py:140"),
    "bpr_tile": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/bpr_tile.cu",
        replaces="movie_recommender_system_with_gnns_tpu/ops/pallas_bpr.py:76"),
    "ell_spmm": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/ell_spmm.cu",
        replaces="movie_recommender_system_with_gnns_tpu/ops/pallas_spmm.py:43"),
    "mips_block": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/mips_block.cu",
        replaces="movie_recommender_system_with_gnns_tpu/ops/pallas_mips.py:30"),
    # no Pallas kernel: the XLA scatter-add of the negatives' row gradients
    "sorted_index_add": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/sorted_index_add.cu",
        replaces="movie_recommender_system_with_gnns_tpu/training/compact.py:538"),
}
#: the eval / propagated-serving path: sampled eval users, users of the
#: per-block serving call, users re-evaluated on the host
EVAL = dict(max_users=10_000, block_users=256, host_users=1_000)


def check(cond, msg: str) -> None:
    if not cond:
        # on both streams: a caller that keeps only one of them still sees why
        print(f"FAIL: {msg}", flush=True)
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str):
    for key in ("H200", "NVL", "PCIe"):
        if key in name:
            return PEAKS["H200" if key == "H200" else f"H100 {key}"]
    return PEAKS["H100 SXM"]


def score_tol(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype, d: int):
    """One ulp of ``dtype`` at the larger magnitude, plus d·2^-24: the bound on
    how far two f32 sum orders of d products of unit vectors can drift."""
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    mant = 7 if dtype == torch.bfloat16 else 23
    return torch.exp2(torch.floor(torch.log2(mag)) - mant) + d * 2.0 ** -24


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_topk(s_k, i_k, s_ref, i_ref, dtype, d, what: str) -> int:
    """Kernel top-k (k columns) against the plain top-(k+1): scores within
    :func:`score_tol`; an index may differ only where the plain scores at
    that rank tie within it. Returns the number of rows with such a swap."""
    k = s_k.shape[1]
    tol = score_tol(s_k, s_ref[:, :k], dtype, d)
    check(bool(((s_k - s_ref[:, :k]).abs() <= tol).all()),
          f"{what}: top-k scores beyond one ulp")
    diff = i_k != i_ref[:, :k]
    prev = torch.cat([torch.full_like(s_ref[:, :1], float("inf")), s_ref[:, :k - 1]], dim=1)
    tie = (((s_ref[:, :k] - prev).abs() <= tol)
           | ((s_ref[:, :k] - s_ref[:, 1:k + 1]).abs() <= tol))
    check(bool((~diff | tie).all()), f"{what}: top-k index differs without a near tie")
    return int(diff.any(dim=1).sum())


def chunkmax_case(gen, d: int, nq: int, n: int, n_tile: int, dtypes, qp: int = 0,
                  topk: bool = True) -> float:
    """``score_chunkmax`` against its plain version on random normalized
    inputs, masks none / int8 / packed, each dtype; then (``topk``) the whole
    fused lane against its plain run on the host. Qp is ``qp`` (default: nq
    rounded up to 128), Np is n rounded up to ``n_tile``. Returns the largest
    |kernel - plain| score."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import normalize_embedding
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_mips import (
        mips_topk_fused, score_chunkmax, score_chunkmax_plain)
    from movie_recommender_system_with_gnns_tpu_torch.ops.topk import (
        NEG_INF, pack_mask_tiles)

    pad = torch.nn.functional.pad
    k = TOP_K
    qp = qp or -(-nq // 128) * 128
    np_ = -(-n // n_tile) * n_tile
    q = torch.randn(nq, d, device="cuda", generator=gen)
    c = torch.randn(n, d, device="cuda", generator=gen)
    dense = torch.rand(nq, n, device="cuda", generator=gen) < 0.1
    rows, cols = dense.nonzero(as_tuple=True)
    packed = pack_mask_tiles(rows, cols, nq, n, n_tile)
    int8 = dense.to(torch.int8)
    worst = 0.0
    for dtype in dtypes:
        qn = pad(normalize_embedding(q).to(dtype), (0, 0, 0, qp - nq))
        cn = pad(normalize_embedding(c).to(dtype), (0, 0, 0, np_ - n))
        for mode in ("none", "int8", "packed"):
            what = (f"d={d} Q={nq} (Qp {qp}) N={n} (Np {np_}) n_tile={n_tile} "
                    f"{str(dtype)[6:]} mask={mode}")
            kw = {}
            if mode == "int8":
                kw["mask"] = pad(int8, (0, np_ - n, 0, qp - nq))
            elif mode == "packed":
                kw["mask_packed"] = pad(packed, (0, 0, 0, qp - nq))
            s_k, cm_k = score_chunkmax(qn, cn, n, n_tile=n_tile, **kw)
            s_p, cm_p = score_chunkmax_plain(qn, cn, n, n_tile=n_tile, **kw)
            torch.cuda.synchronize()
            a, b = s_k.float(), s_p.float()
            err = (a - b).abs()
            check(bool((err <= score_tol(a, b, dtype, d)).all()),
                  f"{what}: scores beyond one ulp of the plain version "
                  f"(max |diff| {err.max().item():.3e})")
            check(torch.equal(cm_k, s_k.view(qp, -1, 128).amax(-1)),
                  f"{what}: chunk max is not the max of the stored tile")
            banned = (pad(int8, (0, np_ - n, 0, qp - nq)) != 0 if mode != "none" else None)
            neg = torch.tensor(NEG_INF, dtype=dtype).item()
            pad_ok = bool((a[:, n:] == neg).all())
            mask_ok = banned is None or bool((a[banned] == neg).all())
            check(pad_ok and mask_ok, f"{what}: pad or masked column not NEG_INF")
            worst = max(worst, err.max().item())
            msg = f"[kernel] {what}: max |s - plain| {err.max().item():.3e}, cm exact"
            if topk:
                # top-k through the whole fused lane vs its plain run on the host
                mk = {} if mode == "none" else (
                    {"exclude_mask": int8} if mode == "int8" else
                    {"exclude_mask_packed": packed})
                s_t, i_t = mips_topk_fused(q, c, k=k, n_tile=n_tile, score_dtype=dtype, **mk)
                s_r, i_r = mips_topk_fused(q.cpu(), c.cpu(), k=k + 1, n_tile=n_tile,
                                           score_dtype=dtype,
                                           **{key: v.cpu() for key, v in mk.items()})
                swaps = check_topk(s_t.cpu(), i_t.cpu(), s_r, i_r, dtype, d, what)
                check(bool((i_t < n).all()), f"{what}: a pad column was returned")
                if mode != "none":
                    check(not bool(dense.gather(1, i_t).any()),
                          f"{what}: an excluded item was returned")
                msg += f", top-{k} ok ({swaps} rows with near-tie swaps)"
            log(msg)
    return worst


def kernel_phase() -> float:
    """Phase 3, kernel B2: kernel vs plain version at three depths, ragged N,
    three mask modes, two score types; then the bf16 lane's edges: n_tile
    1024, 3072 (one mask window per work unit) and 4096, one 128-row band
    (fewer work units than SMs), a band count that does not divide over the
    persistent blocks, d = 8 and 24 (TMA zero fill of the depth), d = 320
    (band streamed, not resident) and N whose last valid column lies inside a
    mask tile. Returns the largest |kernel - plain| score."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    both = (torch.bfloat16, torch.float32)
    worst = 0.0
    for d in (64, 128, 256):
        worst = max(worst, chunkmax_case(gen, d, 1000, 3001, 2048, both, qp=1024))
    bf16 = (torch.bfloat16,)
    for d, nq, n, n_tile in ((64, 1000, 3001, 1024), (64, 100, 3001, 2048),
                             (64, 1000, 5000, 4096), (64, 1000, 5000, 3072),
                             (24, 17_000, 3001, 2048),
                             (8, 1000, 5000, 2048), (320, 1000, 3001, 1024)):
        worst = max(worst, chunkmax_case(gen, d, nq, n, n_tile, bf16, topk=nq <= 1000))
    return worst


def check_served(index, users, s, i, num_items: int) -> None:
    """One dispatch's outputs: shape, finite, sorted, valid, not train-seen."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_mips import unpack_mask_tiles
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import _MASK_TILE

    check(s.shape == (len(users), TOP_K) and i.shape == s.shape, "output shape")
    check(bool(torch.isfinite(s).all()) and bool((s > -1.0001).all()),
          "non-finite or masked score served")
    check(bool((s[:, :-1] >= s[:, 1:]).all()), "scores not descending")
    check(bool(((i >= 0) & (i < num_items)).all()), "item out of range")
    rows = index.mask[torch.as_tensor(users, device="cuda")]
    seen = unpack_mask_tiles(rows, _MASK_TILE).gather(1, i)
    check(not bool(seen.any()), "a train-seen item was served")


def profile_window(what: str, reps: int, top: int, fn) -> dict:
    """Run ``fn`` ``reps`` times under torch.profiler and print the wall time,
    the device-busy time and the kernels that take most of it, per repeat;
    returns the first three and the kernel count, per repeat."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev = sorted(((e.self_device_time_total / (1e3 * reps), e.count / reps, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(ms for ms, _, _ in dev)
    log(f"[trace] per {what} under the profiler: wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms (idle share {1 - busy / wall_ms:.3f}), "
        f"{sum(n for _, n, _ in dev):.0f} kernels")
    for ms, n, key in dev[:top]:
        log(f"[trace]   {ms:.4f} ms  x{n:.0f}  {key[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                kernels=sum(n for _, n, _ in dev))


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def bpr_inputs(gen, d, u_pad, i_pad, b, neg_mode, dup=False, kneg=1,
               item_hub=False, loc_eq_pl=False, all_masked=False):
    """Random inputs of ``bpr_tile`` on the card: a masked tail of b // 5
    triplets (``all_masked``: all of them); ``dup`` puts one user into about
    70 % of them, ``item_hub`` one item as the positive of about 30 % and the
    negative of a tenth; ``loc_eq_pl`` makes every seventh negative its
    triplet's positive, in the cluster."""
    dev = "cuda"
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen) * 0.1
    ints = lambda hi, n: torch.randint(0, hi, (n,), device=dev, generator=gen,
                                       dtype=torch.int32)
    u_tab, i_tab = rnd(u_pad, 2 * d), rnd(i_pad, 2 * d)
    ul, pl = ints(u_pad, b), ints(i_pad, b)
    if dup:
        ul = torch.where(torch.rand(b, device=dev, generator=gen) < 0.7,
                         torch.full_like(ul, 3), ul)
    if item_hub:
        pl = torch.where(torch.rand(b, device=dev, generator=gen) < 0.3,
                         torch.full_like(pl, 5), pl)
    m = torch.ones(b, dtype=torch.int32, device=dev)
    m[b - b // 5:] = 0
    if all_masked:
        m.zero_()
    if kneg > 1:
        ul, pl, m = (t.repeat_interleave(kneg) for t in (ul, pl, m))
    n = b * kneg
    loc = ints(i_pad, n)
    inc = {"all": torch.ones(n, dtype=torch.int32, device=dev),
           "none": torch.zeros(n, dtype=torch.int32, device=dev),
           "mixed": ints(2, n)}[neg_mode]
    if item_hub:
        loc[::10] = 5
    if loc_eq_pl:
        loc[::7], inc[::7] = pl[::7], 1
    return u_tab, i_tab, rnd(n, d), ul, pl, loc, inc, m


def check_bpr(args, what: str, incidence, also=(), **kw) -> float:
    """``bpr_tile`` with the lists ``incidence`` against its plain version on
    the same tensors: loss within 1e-5 relative, gradients within 1e-4 of the
    plain autograd gradients' largest entry, masked rows' gni exactly zero;
    and bit-equal outputs from a second call, from pass 1 on 7 blocks and
    from each other list of the same triplets in ``also``. Returns the
    largest abs error."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr

    out_k = cuda_bpr.bpr_tile(*args, incidence=incidence, **kw)
    again = cuda_bpr.bpr_tile(*args, incidence=incidence, **kw)
    other_grid = cuda_bpr._launch(*args, incidence, kw["scale"], kw["bpr_coeff"],
                                  kw["loss"], grid=7)
    others = [cuda_bpr.bpr_tile(*args, incidence=o, **kw) for o in also]
    out_p = cuda_bpr.bpr_tile_plain(*args, **kw)
    torch.cuda.synchronize()
    lk, lp = out_k[0].item(), out_p[0].item()
    check(abs(lk - lp) <= 1e-5 * abs(lp) + 1e-9,
          f"{what}: loss {lk!r} vs plain {lp!r}")
    worst = abs(lk - lp)
    for name, a, b in zip(("gu", "gi", "gni"), out_k[1:], out_p[1:]):
        check(bool(torch.isfinite(a).all()), f"{what}: {name} not finite")
        r = rel_max(a, b)
        check(r < 1e-4, f"{what}: {name} rel err {r:.3e} vs the plain gradients")
        worst = max(worst, (a - b).abs().max().item())
    check(bool((out_k[3][args[7] == 0] == 0).all()),
          f"{what}: a masked triplet's gni is not exactly zero")
    for name, a, b, c in zip(("loss", "gu", "gi", "gni"), out_k, again, other_grid):
        check(torch.equal(a, b), f"{what}: two calls differ in {name}")
        check(torch.equal(a, c), f"{what}: pass 1 on 7 blocks changes {name}")
    for o in others:
        for name, a, b in zip(("loss", "gu", "gi", "gni"), out_k, o):
            check(torch.equal(a, b), f"{what}: other lists of the same triplets "
                  f"change {name}")
    return worst


def bpr_bound(args, bw: float):
    """Least time (ms) the card could take for one ``bpr_tile`` call on these
    inputs, with what sets it, the bytes and the operations. Counted from the
    data: a masked triplet costs its ``m`` entry and its zero ``gni`` row;
    a valid one its four other indices and its ``ni`` row; of the tables only
    the rows a valid triplet names are read (an item named only as an
    in-cluster negative gives its propagated half alone); ``gni``, both
    gradient tables and the loss are written once in full, the zeros
    included; about 30 d f32 operations per valid triplet."""
    u_tab, i_tab, ni, ul, pl, loc, inc, m = args
    b, d = ni.shape
    v = m != 0
    valid = int(v.sum())
    u_named = torch.unique(ul[v])
    pos = torch.unique(pl[v])
    neg = torch.unique(loc[v & (inc != 0)])
    neg_only = int((~torch.isin(neg, pos)).sum())
    read = (4 * b + 16 * valid + valid * d * 4 + 8
            + (u_named.numel() + pos.numel()) * 2 * d * 4 + neg_only * d * 4)
    write = b * d * 4 + (u_tab.numel() + i_tab.numel()) * 4 + 4
    byts, flops = read + write, 30.0 * d * valid
    t_bytes, t_ops = byts / bw * 1e3, flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            byts, flops)


def device_split(fn, iters: int):
    """[(ms per call, launches per call, name)] of everything ``fn`` enqueues,
    by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.self_device_time_total / (1e3 * iters), e.count / iters, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def time_bpr(args, incidence, neg_prep=None, iters: int = 20, **kw) -> dict:
    """Times (ms per call) of ``bpr_tile`` on these inputs and lists.

    ``device``: what the card spends on one call of the wrapper, summed by the
    profiler over everything the call enqueues (pass 1, pass 2); ``pass1``
    and ``pass2`` split it. ``kernels`` and ``memsets``: launches per call.
    ``wrapper``: CUDA events around ``iters`` calls of the wrapper, which hold
    the host's time to enqueue the work whenever the card finishes it sooner.
    ``neg_prep`` (the step's negative sort and the kernel's negative row
    starts, which the trainer runs once per step outside the call) is timed
    apart: ``neg_sort`` (the sort and its index cast), ``neg_starts`` (the
    searchsorted and the gather of each local item row's run bounds)."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr

    call = lambda: cuda_bpr.bpr_tile(*args, incidence=incidence, **kw)
    wrapper_ms = time_ms(call, iters)
    dev = device_split(call, iters)
    mem = lambda key: key.startswith(("Memset", "Memcpy"))
    own = {p: sum(ms for ms, _, key in dev if f"bpr_{p}_kernel" in key)
           for p in ("pass1", "pass2")}
    check(all(ms > 0 for ms in own.values()),
          f"the profiler missed a kernel of bpr_tile: {own}")
    out = dict(device=sum(ms for ms, _, _ in dev), pass1=own["pass1"],
               pass2=own["pass2"], wrapper=wrapper_ms,
               kernels=sum(n for _, n, key in dev if not mem(key)),
               memsets=sum(n for _, n, key in dev if mem(key)),
               split=[(round(ms, 4), n, key[:70]) for ms, n, key in sorted(dev)])
    if neg_prep is not None:
        prep = device_split(neg_prep, iters)
        starts = lambda key: "searchsorted" in key or "ndex" in key
        out.update(neg_sort=sum(ms for ms, _, key in prep if not starts(key)),
                   neg_starts=sum(ms for ms, _, key in prep if starts(key)),
                   neg_kernels=sum(n for _, n, key in prep if not mem(key)),
                   neg_memsets=sum(n for _, n, key in prep if mem(key)),
                   neg_split=[(round(ms, 4), n, key[:70]) for ms, n, key in sorted(prep)])
    return out


def log_bpr_time(what: str, t: dict, bound: float, by: str, byts: float,
                 flops: float, plain_ms: float) -> None:
    log(f"[kernel] bpr_tile at {what}: {t['device']:.4f} ms of device time per "
        f"wrapper call (profiler): pass 1 {t['pass1']:.4f}, pass 2 {t['pass2']:.4f} ms; "
        f"{t['kernels']:.0f} kernel launches and {t['memsets']:.0f} memsets per "
        f"call; {t['wrapper']:.4f} ms per wrapper call by CUDA events "
        f"(host-bound); plain forward+backward {plain_ms:.4f} ms; bound "
        f"{bound:.4f} ms ({by}: {byts / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP), "
        f"{bound / t['device']:.3f} of the bound")
    for ms, n, key in t["split"]:
        log(f"[kernel]   {ms:.4f} ms  x{n:g}  {key}")
    if "neg_sort" in t:
        log(f"[kernel] the step's negative sort (once per step, outside the call): "
            f"{t['neg_sort']:.4f} ms, then the kernel's negative row starts "
            f"{t['neg_starts']:.4f} ms; {t['neg_kernels']:.0f} kernels and "
            f"{t['neg_memsets']:.0f} memsets; call + sort + starts "
            f"{t['device'] + t['neg_sort'] + t['neg_starts']:.4f} ms")
        for ms, n, key in t["neg_split"]:
            log(f"[kernel]   {ms:.4f} ms  x{n:g}  {key}")


def bpr_kernel_phase(bw: float) -> float:
    """Phase 3, kernel B1: every d, both losses, the three negative mixes,
    then a user hub, an item hub, negatives equal to their positive, an
    all-masked call and four negatives per positive; B is ragged (not a
    multiple of the block's 8 triplets) and has a masked tail. Then the
    kernel's reference shape, the width a refined partition gives (about 40 %
    of the edges kept in 100 clusters), timed: random inputs, every triplet
    valid, 2 % of the negatives in the cluster."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = 0.0
    for d in (16, 64, 128, 256):
        scale = 1.0 / 16.0
        errs = []
        for loss in ("reference", "standard"):
            kw = dict(scale=scale, bpr_coeff=5e-3, loss=loss)
            cases = [dict(neg_mode=mode) for mode in ("all", "none", "mixed")]
            cases += [dict(neg_mode="mixed", dup=True),
                      dict(neg_mode="mixed", item_hub=True),
                      dict(neg_mode="mixed", loc_eq_pl=True),
                      dict(neg_mode="mixed", all_masked=True),
                      dict(neg_mode="mixed", kneg=4)]
            for case in cases:
                args = bpr_inputs(gen, d, u_pad=384, i_pad=640, b=4099, **case)
                if case.get("item_hub"):
                    check(int(((args[4] == 5) & (args[7] != 0)).sum()) >= 800,
                          "the item hub has fewer than 800 positives")
                lists = cuda_bpr.bpr_incidence(*args[3:], 384, 640)
                # four negatives: the trainer's grouped lists give the same bits
                grouped = [cuda_bpr.bpr_incidence(*args[3:], 384, 640, kneg=4)
                           ] if case.get("kneg") else []
                errs.append(check_bpr(args, f"bpr_tile d={d} {loss} {case}", lists,
                                      also=grouped, **kw))
        worst = max(worst, max(errs))
        log(f"[kernel] bpr_tile d={d}: {len(errs)} cases agree with the plain "
            f"version (max abs err {max(errs):.3e}), each bit-equal over two "
            f"calls and over two grids of pass 1 (four negatives: and over the "
            f"grouped lists)")
    kw = dict(scale=1.0 / 16.0, bpr_coeff=5e-3, loss="reference")
    wide = list(bpr_inputs(gen, 64, u_pad=1792, i_pad=1152, b=40_960,
                           neg_mode="mixed"))
    wide[7] = torch.ones_like(wide[7])
    wide[6] = (torch.rand(40_960, device="cuda", generator=gen) < 0.02).to(torch.int32)
    lists = cuda_bpr.bpr_incidence(*wide[3:], 1792, 1152)
    worst = max(worst, check_bpr(wide, "bpr_tile at the reference shape", lists, **kw))
    t = time_bpr(wide, lists, **kw)
    log_bpr_time("its reference shape (u_pad 1792, i_pad 1152, B 40960 all "
                 "valid, 2 % of the negatives in the cluster, d=64, random "
                 "inputs)", t, *bpr_bound(wide, bw),
                 time_ms(lambda: cuda_bpr.bpr_tile_plain(*wide, **kw), 5, warmup=1))
    return worst


def scatter_kernel_phase() -> float:
    """Phase 3, ``sorted_index_add``: repeated ids over 5,000 rows, the upper
    half with none, a hub of 301 entries and the last row used; d 16 / 64 /
    100 in f32 and 64 in bf16. Bit-equal to the plain version's sequential
    sum on the host and over two calls; f32 within 1e-5 of the largest entry
    of ``index_add_`` on the card (its atomics sum in another order). Then
    ``gather_rows`` and ``scatter_rows``: values and gradients bit-equal to
    the host's ``index_select`` / ``index_add``. Returns the largest abs
    error against ``index_add_`` on the card."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_scatter as cs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rows, n = 5000, 12_001
    worst = 0.0
    for d, dtype in ((16, torch.float32), (64, torch.float32), (100, torch.float32),
                     (64, torch.bfloat16)):
        what = f"sorted_index_add d={d} {str(dtype)[6:]}"
        idx = torch.randint(0, rows // 2, (n,), device="cuda", generator=gen,
                            dtype=torch.int32)
        idx[::40] = 11
        idx[:3] = rows - 1
        x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
        order, starts = cs.sort_rows(idx, rows)
        out = cs.sorted_index_add(x, order, starts, rows)
        again = cs.sorted_index_add(x, order, starts, rows)
        host = cs.sorted_index_add_plain(x.cpu(), order.cpu(), starts.cpu(), rows)
        card = torch.zeros(rows, d, dtype=dtype, device="cuda").index_add_(0, idx, x)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == (rows, d), f"{what}: shape or type")
        check(torch.equal(out, again), f"{what}: two calls differ")
        check(torch.equal(out.cpu(), host),
              f"{what}: differs from the plain version's sequential sum on the host "
              f"(max abs {(out.cpu().float() - host.float()).abs().max().item():.3e})")
        check(not bool(out[rows // 2:rows - 1].any()), f"{what}: a row with no entry is not zero")
        err = (out.float() - card.float()).abs().max().item()
        if dtype == torch.float32:
            check(err <= 1e-5 * card.abs().max().item(),
                  f"{what}: {err:.3e} from index_add_ on the card")
            worst = max(worst, err)
        log(f"[kernel] {what}: {n} entries over {rows} rows (hub of "
            f"{int((idx == 11).sum())}): bit-equal to the plain version on the host "
            f"and over two calls; max abs err vs index_add_ on the card {err:.3e}")
    x = torch.randn(rows, 64, device="cuda", generator=gen)
    g = torch.randn(n, 64, device="cuda", generator=gen)
    a = x.clone().requires_grad_(True)
    y = cs.gather_rows(a, idx, order, starts)
    (ga,) = torch.autograd.grad((y * g).sum(), a)
    b = x.cpu().requires_grad_(True)
    (gb,) = torch.autograd.grad((b.index_select(0, idx.cpu()) * g.cpu()).sum(), b)
    check(torch.equal(y.cpu(), x.cpu().index_select(0, idx.cpu())) and torch.equal(ga.cpu(), gb),
          "gather_rows: value or gradient differs from the host's index_select")
    a = g.clone().requires_grad_(True)
    y = cs.scatter_rows(a, idx, order, starts, rows)
    (ga,) = torch.autograd.grad((y * x).sum(), a)
    b = g.cpu().requires_grad_(True)
    ref = torch.zeros(rows, 64).index_add(0, idx.cpu(), b)
    (gb,) = torch.autograd.grad((ref * x.cpu()).sum(), b)
    check(torch.equal(y.detach().cpu(), ref.detach()) and torch.equal(ga.cpu(), gb),
          "scatter_rows: value or gradient differs from the host's index_add")
    log("[kernel] gather_rows / scatter_rows: values and gradients bit-equal to the "
        "host's index_select / index_add")
    return worst


def profiled_ms(fn, iters: int, kernel: str):
    """(device ms per call summed over everything ``fn`` enqueues, of which
    the kernels whose name contains ``kernel``), by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [(e.self_device_time_total, e.key) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    kernel_us = sum(us for us, key in dev if kernel in key)
    check(kernel_us > 0, f"the profiler recorded no {kernel} kernel")
    return sum(us for us, _ in dev) / (1e3 * iters), kernel_us / (1e3 * iters)


def ell_test_graph():
    """(edge_index, num_nodes): a power-law bipartite graph in which node 0 is
    linked to every other node (its bucket is grown to the max degree, far
    past the widest default bucket of its neighbours) and two nodes have no
    edge at all."""
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens)

    d = make_synthetic_movielens(3000, 1500, 60_000, seed=SEED + 4, power=1.1)
    n = d.num_users + d.num_items
    e = d.edge_index.astype(np.int64)
    e = e[:, ~np.isin(e, [17, n - 3]).any(axis=0) & (e[0] != 0) & (e[1] != 0)]
    others = np.setdiff1d(np.arange(1, n), [17, n - 3])
    hub = np.stack([others, np.zeros_like(others)])
    return np.concatenate([e, hub, hub[::-1]], axis=1), n


def ell_case(ell, coo, x, what: str, zero_rows=()) -> float:
    """One B4 case: ``spmm_ell_cuda`` against the plain ``spmm_ell`` and
    ``spmm_segment`` (f32 within rtol 1e-3 / atol 1e-4: the JAX suite's bound
    for its kernel; the three sum the same f32 products in different orders),
    bf16 within one bf16 ulp of the plain version (both round an f32 sum
    once), each bit-equal over two calls; the rows of isolated nodes
    (``zero_rows``) zero. Returns the f32 max abs error."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import spmm_ell, spmm_segment

    out, again = spmm_ell_cuda(ell, x), spmm_ell_cuda(ell, x)
    ref = spmm_ell(ell, x)
    seg = spmm_segment(coo, x)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"ell_spmm {what} f32: two calls differ")
    check(bool((out[list(zero_rows)] == 0).all()), "an isolated node's row is not zero")
    for name, r in (("plain spmm_ell", ref), ("spmm_segment", seg)):
        err = (out - r).abs()
        check(bool((err <= 1e-4 + 1e-3 * r.abs()).all()),
              f"ell_spmm {what} f32 vs {name}: max abs err {err.max().item():.3e}")
    e32 = (out - ref).abs().max().item()
    xb = x.bfloat16()
    outb, againb, refb = spmm_ell_cuda(ell, xb), spmm_ell_cuda(ell, xb), spmm_ell(ell, xb)
    torch.cuda.synchronize()
    check(outb.dtype == torch.bfloat16, "bf16 table did not come back as bf16")
    check(torch.equal(outb, againb), f"ell_spmm {what} bf16: two calls differ")
    eb = (outb.float() - refb.float()).abs()
    check(bool((eb <= 1e-4 + 2.0 ** -7 * refb.float().abs()).all()),
          f"ell_spmm {what} bf16: beyond one ulp of the plain version "
          f"(max abs err {eb.max().item():.3e})")
    log(f"[kernel] ell_spmm {what}: f32 max abs err {e32:.3e} vs plain, "
        f"{(out - seg).abs().max().item():.3e} vs spmm_segment; bf16 max abs "
        f"err {eb.max().item():.3e}; both bit-equal over two calls")
    return e32


def ell_kernel_phase() -> float:
    """Phase 3, kernel B4: :func:`ell_case` on a power-law bipartite graph
    with a hub of ~4,500 neighbours (a row split into many segments) and two
    isolated nodes, aligned and unaligned row counts, d in {16, 64, 100, 256};
    then a graph whose rows all read higher ids (one side of the work list
    empty); given weights that are not the graph's own ``gcn_norm``; a
    remainder with a third of its rows empty (d = 256); the transpose of an
    asymmetric graph, forward and as the backward of the forward graph.
    Returns the largest f32 abs error."""
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import (
        COOGraph, EllGraph, gcn_norm)
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceCOO, DeviceELL

    e, n = ell_test_graph()
    deg = np.bincount(e[1], minlength=n)
    coo = DeviceCOO.from_host(COOGraph.build(e, n), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    worst = 0.0
    for row_align in (8, 4):
        g = EllGraph.build(e, n, row_align=row_align)
        shapes = [(b.rows, b.width) for b in g.blocks]
        check(g.blocks[-1].width >= deg.max() > 2048 and deg[17] == 0,
              "the test graph lost its hub or its isolated node")
        if row_align == 4:
            check(any(r % 8 for r, _ in shapes), "no unaligned bucket in the test graph")
        ell = DeviceELL.from_host(g, "cuda")
        sch = ell.schedule
        check(len(sch.split_rows) and sch.split_rows[:, 3].max() >= 10
              and set(sch.item_side.tolist()) == {0, 1},
              "the hub row is not split into many segments, or a side has no items")
        for d in (16, 64, 100, 256):
            x = torch.randn(n, d, device="cuda", generator=gen)
            worst = max(worst, ell_case(ell, coo, x, f"d={d} row_align={row_align} "
                                        f"buckets {shapes}", zero_rows=(17, n - 3)))
    # every edge from a higher id to a lower one: every row reads higher ids
    down = e[:, e[0] > e[1]]
    g = EllGraph.build(down, n)
    ell = DeviceELL.from_host(g, "cuda")
    check(not ell.schedule.item_side.any(), "a row of the one-sided graph reads lower ids")
    coo1 = DeviceCOO.from_host(COOGraph.build(down, n), "cuda")
    x = torch.randn(n, 64, device="cuda", generator=gen)
    worst = max(worst, ell_case(ell, coo1, x, f"d=64 one side empty, buckets "
                                f"{[(b.rows, b.width) for b in g.blocks]}"))
    # given weights that are not the graph's own gcn_norm
    rng = np.random.default_rng(SEED + 6)
    w = rng.uniform(0.1, 1.0, e.shape[1]).astype(np.float32)
    ell = DeviceELL.from_host(EllGraph.build(e, n, weights=w), "cuda")
    x = torch.randn(n, 64, device="cuda", generator=gen)
    worst = max(worst, ell_case(ell, weighted_coo(e, n, w), x,
                                "d=64 given weights (not gcn_norm)", zero_rows=(17, n - 3)))
    # a remainder: the whole graph's gcn_norm weights on the edges into two
    # thirds of the nodes, the other third's rows empty
    empty = np.flatnonzero(rng.random(n) < 1 / 3)
    keep = ~np.isin(e[1], empty)
    sub, w_sub = e[:, keep], gcn_norm(e, n)[keep]
    ell = DeviceELL.from_host(EllGraph.build(sub, n, weights=w_sub), "cuda")
    x = torch.randn(n, 256, device="cuda", generator=gen)
    worst = max(worst, ell_case(ell, weighted_coo(sub, n, w_sub), x,
                                f"d=256 remainder, {empty.size} of {n} rows empty",
                                zero_rows=tuple(empty)))
    # an asymmetric graph's transpose (src and dst swapped, the same
    # weights): its forward hop, then as the backward of the forward graph
    asym = e[:, rng.random(e.shape[1]) > 0.25]
    w_a = gcn_norm(asym, n)
    ell_f = DeviceELL.from_host(EllGraph.build(asym, n), "cuda")
    ell_t = DeviceELL.from_host(EllGraph.build(asym[::-1], n, weights=w_a), "cuda")
    x = torch.randn(n, 64, device="cuda", generator=gen)
    worst = max(worst, ell_case(ell_t, weighted_coo(asym[::-1], n, w_a), x,
                                "d=64 transpose of an asymmetric graph"))
    worst = max(worst, ell_backward_case(ell_f, ell_t, x))
    return worst


def weighted_coo(e, n: int, w):
    """A ``DeviceCOO`` of edges ``e`` with the weights ``w`` (dst-sorted)."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceCOO

    order = np.argsort(e[1], kind="stable")
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a[order], dt)).to("cuda")
    return DeviceCOO(up(e[0], np.int32), up(e[1], np.int32), up(w, np.float32), n)


def ell_backward_case(ell, ell_t, x) -> float:
    """The gradient of ``spmm_ell_cuda(ell, x, transpose=ell_t)`` (one launch
    forward, one over the transpose backward) against autodiff through the
    plain ``spmm_ell``: within rtol 1e-3 / atol 1e-4 as the f32 cases, and
    bit-equal over two calls. Returns the max abs error."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import spmm_ell

    cot = torch.randn_like(x)
    grads = []
    before = _build.LAUNCHES["ell_spmm"]
    for fn in (lambda v: spmm_ell_cuda(ell, v, transpose=ell_t),) * 2 + (
            lambda v: spmm_ell(ell, v),):
        xr = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xr), xr, cot)[0])
    torch.cuda.synchronize()
    n_launch = _build.LAUNCHES["ell_spmm"] - before
    a, again, ref = grads
    check(n_launch == 4, f"two forward and backward calls launched {n_launch} kernels")
    check(torch.equal(a, again), "ell_spmm transposed backward: two calls differ")
    err = (a - ref).abs()
    check(bool((err <= 1e-4 + 1e-3 * ref.abs()).all()),
          f"ell_spmm transposed backward vs autodiff of the plain spmm_ell: max abs "
          f"err {err.max().item():.3e}")
    log(f"[kernel] ell_spmm backward over the transpose (d={x.shape[1]}): max abs err "
        f"{err.max().item():.3e} vs autodiff of the plain spmm_ell, bit-equal over two "
        f"calls, one launch forward and one backward")
    return err.max().item()


def check_block_topk(s_k, i_k, s_p, i_p, what: str, s_next=None) -> float:
    """Kernel candidates against the plain version's, both (nb, Q, k): scores
    within 1e-5; an index may differ only where the plain scores of
    neighbouring ranks lie within 2e-6 (the kernel's products and the matmul
    sum in different orders, which can swap such a pair). ``s_next`` (nb, Q,
    1) is the plain version's next score past its k (its rank k + 1; -inf
    where there is none): the last rank's neighbour, with which a near tie
    can swap the last candidate. Returns the largest score difference."""
    live = s_p > -1e29
    diff_s = torch.where(live, (s_k - s_p).abs(), torch.zeros_like(s_p))
    check(bool((diff_s <= 1e-5).all()) and bool(((s_k > -1e29) == live).all()),
          f"{what}: scores differ from the plain version by {diff_s.max().item():.3e}")
    diff = i_k != i_p
    inf = torch.full_like(s_p[..., :1], float("inf"))
    prev = torch.cat([inf, s_p[..., :-1]], dim=-1)
    nxt = torch.cat([s_p[..., 1:], -inf if s_next is None else s_next], dim=-1)
    tie = ((s_p - prev).abs() <= 2e-6) | ((s_p - nxt).abs() <= 2e-6)
    bad = diff & ~tie
    check(not bool(bad.any()),
          f"{what}: an index differs from the plain version without a near tie "
          f"(first at {bad.nonzero()[:1].tolist()}: kernel {s_k[bad][:1].tolist()} "
          f"{i_k[bad][:1].tolist()}, plain {s_p[bad][:1].tolist()} {i_p[bad][:1].tolist()})")
    return diff_s.max().item()


def plain_block_topk(q, c, k, block, mask):
    """The plain version's (scores, ids) at k and its score at rank k + 1
    (-inf where k = block), for :func:`check_block_topk`."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_mips import (
        mips_block_topk_plain)

    s_p, i_p = mips_block_topk_plain(q, c, min(k + 1, block), block=block, mask=mask)
    s_next = (s_p[..., k:] if k < block
              else torch.full_like(s_p[..., :1], float("-inf")))
    return s_p[..., :k].contiguous(), i_p[..., :k].contiguous(), s_next


def mips_block_phase() -> float:
    """Phase 3, kernel B3: ``mips_block_topk`` against its plain version on
    the card, then the whole ``method="pallas"`` lane against ``flat``."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import normalize_embedding
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_mips import mips_block_topk
    from movie_recommender_system_with_gnns_tpu_torch.ops.topk import NEG_INF, mips_topk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    nq, n, block = 250, 10_001, 4096           # Q % 32 != 0, N % block != 0
    worst = 0.0
    # d -> the k of its cases: the 12 cases of d 64 and 100, then d % 4 != 0
    # (4-byte copies), a depth past one band window of the kernel's, and a k
    # past its shared-memory buffers (the global-scratch route)
    for d, ks in ((64, (1, 10, 100)), (100, (1, 10, 100)), (30, (10,)), (256, (10,)),
                  (64, (1000,))):
        q = normalize_embedding(torch.randn(nq, d, device="cuda", generator=gen))
        c = normalize_embedding(torch.randn(n, d, device="cuda", generator=gen))
        # planted exact ties: copies of one row in one block and across blocks
        c[4000] = c[12]
        c[9000] = c[12]
        c[13] = c[12]
        q[7] = c[12]
        mask = (torch.rand(nq, n, device="cuda", generator=gen) < 0.1).to(torch.int8)
        mask[:, [12, 13, 4000, 9000]] = 0
        mask[5] = 1
        mask[5, [3, 5000, 5001]] = 0            # three live columns in all
        mask[6] = 1                             # none at all
        for k in ks:
            for m in (None, mask):
                what = f"mips_block d={d} k={k} mask={'int8' if m is not None else 'none'}"
                s_k, i_k = mips_block_topk(q, c, k, block=block, mask=m)
                s_k2, i_k2 = mips_block_topk(q, c, k, block=block, mask=m)
                s_p, i_p, s_next = plain_block_topk(q, c, k, block, m)
                torch.cuda.synchronize()
                check(s_k.shape == (3, nq, k) and i_k.dtype == torch.int32, f"{what}: shape")
                check(torch.equal(s_k, s_k2) and torch.equal(i_k, i_k2),
                      f"{what}: two calls differ")
                worst = max(worst, check_block_topk(s_k, i_k, s_p, i_p, what, s_next))
                check(bool((i_k < n).all()) and bool((i_k >= 0).all()),
                      f"{what}: a column outside the catalog")
                # exact ties: equal scores keep ascending columns (query 7
                # scores 1.0 against its four copies)
                same = s_k[:, :, 1:] == s_k[:, :, :-1]
                live = s_k[:, :, 1:] > -1e29
                check(bool((i_k[:, :, 1:] > i_k[:, :, :-1])[same & live].all()),
                      f"{what}: tied scores not in ascending column order")
                check(torch.equal(i_k[:, 7, :3], i_p[:, 7, :3]),
                      f"{what}: the planted ties' indices differ from the plain version")
                if k >= 2:
                    check(i_k[0, 7, :2].tolist() == [12, 13],
                          f"{what}: planted tie order {i_k[0, 7, :2].tolist()}")
                if m is not None:
                    check(bool((s_k[:, 6] == NEG_INF).all())
                          and i_k[:, 6, 0].tolist() == [0, block, 2 * block],
                          f"{what}: a fully masked row")
                    flat_i = i_k.permute(1, 0, 2).reshape(nq, -1).long()
                    flat_live = s_k.permute(1, 0, 2).reshape(nq, -1) > -1e29
                    check(not bool((m.bool().gather(1, flat_i) & flat_live).any()),
                          f"{what}: an excluded column was returned")
                    if k == 10:
                        check(sorted(i_k[:, 5][s_k[:, 5] > -1e29].tolist()) == [3, 5000, 5001],
                              f"{what}: the row with three live columns")
                # the whole lane against the flat method
                s_b, i_b = mips_topk(q, c, k=k, block=block, method="pallas",
                                     exclude_mask=m, normalize=False)
                s_f, i_f = mips_topk(q, c, k=k + 1, method="flat", exclude_mask=m,
                                     normalize=False)
                check_block_topk(s_b[None], i_b[None], s_f[None, :, :k], i_f[None, :, :k],
                                 what + " merged", s_f[None, :, k:])
        log(f"[kernel] mips_block d={d}: k in {ks} x mask none/int8 agree with the "
            f"plain version and with method='flat', bit-equal over two calls (Q {nq}, "
            f"N {n}, block {block}; max score diff so far {worst:.3e}; planted ties in "
            f"ascending order)")
    return worst


def ell_bound(ell, d: int, itemsize: int, bw: float):
    """Least time (ms) of one hop over these blocks, from their data: the
    slots that hold an edge read once (id + weight, 8 bytes), the one padding
    id that ends a row short of its bucket's width, each row's node id, the
    table read once and written once; 2 d operations per edge. The padding
    behind a row's first padding id is not needed, so it is not counted. Also
    returns the time if every gather were charged its d·itemsize bytes, and
    the time of reading every slot, padding included."""
    slots = sum(b.nbr.numel() for b in ell.blocks)
    rows = sum(b.node_ids.numel() for b in ell.blocks)
    edges = sum(int((b.nbr != ell.num_nodes).sum()) for b in ell.blocks)
    ends = sum(int((b.nbr[:, -1] == ell.num_nodes).sum()) for b in ell.blocks)
    table = ell.num_nodes * d * itemsize
    byts = edges * 8 + ends * 4 + rows * 4 + 2 * table
    flops = 2.0 * d * edges
    t_bytes, t_ops = byts / bw * 1e3, flops / F32_FLOPS * 1e3
    gathered = (edges * 8 + ends * 4 + rows * 4 + edges * d * itemsize + table) / bw * 1e3
    all_slots = (slots * 8 + rows * 4 + 2 * table) / bw * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            byts, flops, slots, edges, gathered, all_slots)


def new_path_phase(data, splits, ckpt_path, cfg, bw: float):
    """Phase 5b: eval and propagated serving at ML-25M width with the trained
    checkpoint. Returns the kernel rows of ``ell_spmm`` and ``mips_block``."""
    from movie_recommender_system_with_gnns_tpu_torch.data import native
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph, EllGraph
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
        LightGCNParams, propagate)
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, bpr, cuda_mips
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import (
        ell_schedule, ell_spmm_into, spmm_ell_cuda)
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import (
        DeviceCOO, DeviceELL, spmm_ell, spmm_segment)
    from movie_recommender_system_with_gnns_tpu_torch.ops.topk import NEG_INF
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
        batch_recommend_users, compute_serving_tables)
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import load_params
    from movie_recommender_system_with_gnns_tpu_torch.training.evaluate import (
        _np_group_by_user, evaluate_full_ranking)

    launches = _build.LAUNCHES
    train_e, _, test_e = splits
    nu, ni = data.num_users, data.num_items
    n, d, layers = nu + ni, FULL["dim"], cfg.model.num_layers
    trained, _ = load_params(ckpt_path, device="cuda")

    # propagated serving tables through the ELL SpMM kernel
    launches.clear()
    t0 = time.time()
    tables = compute_serving_tables(trained, train_e, cfg, mode="propagated")
    torch.cuda.synchronize()
    t_tables = time.time() - t0
    t0 = time.time()
    g = EllGraph.build(train_e, n)
    t_ell = time.time() - t0
    ell = DeviceELL.from_host(g, "cuda")
    shapes = [(b.rows, b.width) for b in g.blocks]
    # one launch per hop over every bucket
    check(launches["ell_spmm"] == layers,
          f"ell_spmm launched {launches['ell_spmm']} kernels for {layers} hops over "
          f"{len(shapes)} buckets")
    # the work list alone, on the host (and its upload)
    t0 = time.perf_counter()
    ell_schedule(g.blocks, n, "cuda")
    torch.cuda.synchronize()
    t_list = time.perf_counter() - t0
    sch = ell.schedule
    coo = DeviceCOO.from_host(COOGraph.build(train_e, n), "cuda")
    ref_u, ref_i = propagate(trained, coo, spmm_segment, layers, cfg.model.readout)
    err_t = max((tables.user_emb - ref_u).abs().max().item(),
                (tables.item_emb - ref_i).abs().max().item())
    scale_t = max(ref_u.abs().max().item(), ref_i.abs().max().item())
    check(err_t <= 1e-4 and err_t <= 1e-3 * scale_t and bool(
        torch.isfinite(tables.user_emb).all() & torch.isfinite(tables.item_emb).all()),
        f"propagated tables differ from spmm_segment propagation by {err_t:.3e} "
        f"(largest entry {scale_t:.3e})")
    log(f"[eval] compute_serving_tables(propagated), {layers} hops over {n} nodes, "
        f"{train_e.shape[1]} directed train edges: {t_tables:.2f} s (EllGraph.build "
        f"alone {t_ell:.2f} s on the host); ELL buckets (rows, width) {shapes}, "
        f"padding ratio {g.padding_ratio:.3f}; max abs err vs spmm_segment "
        f"propagation {err_t:.3e} (largest entry {scale_t:.3e})")

    # full-ranking eval: layer-0, then propagated tables
    for name, kw in (("layer0", {}), ("propagated", dict(use_propagated=True, cfg=cfg))):
        t0 = time.time()
        recall, ndcg = evaluate_full_ranking(trained, train_e, test_e, nu, k=TOP_K,
                                             max_users=EVAL["max_users"], **kw)
        torch.cuda.synchronize()
        tm = evaluate_full_ranking.last_timings
        check(np.isfinite(recall) and np.isfinite(ndcg) and 0.0 <= recall <= 1.0
              and 0.0 <= ndcg <= 1.0 and tm["eval_users"] == EVAL["max_users"],
              f"evaluate_full_ranking {name}: recall {recall!r} ndcg {ndcg!r} {tm}")
        log(f"[eval] evaluate_full_ranking {name} tables, {tm['eval_users']} sampled "
            f"users, k={TOP_K}: Recall@{TOP_K} {recall:.6f}, NDCG@{TOP_K} {ndcg:.6f} in "
            f"{time.time() - t0:.2f} s; last_timings {tm}")
    path_launches = dict(launches)
    check(path_launches["ell_spmm"] == 2 * layers,
          f"ell_spmm launches on the eval path: {path_launches}")
    # the same evaluator on the host, fewer users, layer-0 tables
    host = LightGCNParams(trained.user_emb.cpu(), trained.item_emb.cpu())
    r_dev = evaluate_full_ranking(trained, train_e, test_e, nu, k=TOP_K,
                                  max_users=EVAL["host_users"])
    r_host = evaluate_full_ranking(host, train_e, test_e, nu, k=TOP_K,
                                   max_users=EVAL["host_users"])
    # the two matmuls sum in different orders: a near tie at rank k can move
    # one hit of the few thousand ranks
    check(abs(r_dev[0] - r_host[0]) <= 2e-3 and abs(r_dev[1] - r_host[1]) <= 2e-3,
          f"evaluate_full_ranking on the card {r_dev} vs on the host {r_host}")
    log(f"[eval] {EVAL['host_users']} users on the card {r_dev} vs on the host {r_host}")

    # the per-block serving lane: 256 users, train-seen exclusion
    launches.clear()
    users = np.sort(np.random.default_rng(SEED + 7).choice(nu, EVAL["block_users"],
                                                           replace=False))
    ptr, items = _np_group_by_user(train_e, nu)
    lens = np.diff(ptr)[users]
    pairs = (np.concatenate([[0], np.cumsum(lens)]),
             np.concatenate([items[ptr[u]:ptr[u + 1]] for u in users]))
    s_b, i_b = batch_recommend_users(trained, users, top_k=TOP_K, exclude_pairs=pairs,
                                     method="pallas")
    s_r, i_r = batch_recommend_users(trained, users, top_k=TOP_K + 1, exclude_pairs=pairs,
                                     method="twophase", score_dtype="float32")
    torch.cuda.synchronize()
    block_launches = dict(launches)
    check(block_launches.get("mips_block", 0) == 1,
          f"mips_block launches for one 256-user call: {block_launches}")
    swaps = check_topk(s_b, i_b, s_r, i_r, torch.float32, d, "method='pallas' vs twophase")
    seen = np.zeros((users.size, ni), bool)
    seen[np.repeat(np.arange(users.size), lens), pairs[1]] = True
    check(not seen[np.arange(users.size)[:, None], i_b.cpu().numpy()].any(),
          "method='pallas' served a train-seen item")
    log(f"[eval] batch_recommend_users(method='pallas'), {users.size} users, "
        f"train-seen excluded: same items as method='twophase' in f32 ({swaps} rows "
        f"with near-tie swaps); launches {block_launches}")

    # 7c. ell_spmm per hop at the full graph: time, plain, library, bound
    emb = torch.cat([trained.user_emb, trained.item_emb]).contiguous()
    out_k, out_p = spmm_ell_cuda(ell, emb), spmm_ell(ell, emb)
    b4_err = (out_k - out_p).abs().max().item()
    # per element, relative: the trained table's entries are near 1e-3, so an
    # absolute bound would let a dropped slot pass
    check(bool(((out_k - out_p).abs() <= 1e-6 + 1e-3 * out_p.abs()).all()),
          f"ell_spmm at the full graph vs plain: max abs err {b4_err:.3e} "
          f"(largest entry {out_p.abs().max().item():.3e})")
    del out_p
    # the profiler may lose records: a hop is one launch, so its device time
    # is the mean of the launches recorded
    dev = device_split(lambda: spmm_ell_cuda(ell, emb), 10)
    mem = lambda key: key.startswith(("Memset", "Memcpy"))
    b4_launches = sum(c for _, c, key in dev if not mem(key))
    b4_memsets = sum(c for _, c, key in dev if mem(key))
    check(b4_memsets == 0, f"a hop of ell_spmm enqueues memsets or copies: {dev}")
    own = [(ms, c) for ms, c, key in dev if "ell_spmm_kernel" in key]
    check(own and b4_launches == sum(c for _, c in own),
          f"the profiler recorded no ell_spmm kernel, or other kernels: {dev}")
    b4_dev = sum(ms for ms, _ in own) / sum(c for _, c in own)
    b4_events = time_ms(lambda: spmm_ell_cuda(ell, emb), 10)
    b4_plain = time_ms(lambda: spmm_ell(ell, emb), 3, warmup=1)
    seg_ms = time_ms(lambda: spmm_segment(coo, emb), 5, warmup=1)
    rowptr, col, w = native.build_csr(train_e[0], train_e[1], n)
    # row pointers and columns in one index type (int32: E < 2^31), as the
    # sparse library expects
    csr = torch.sparse_csr_tensor(
        *(torch.from_numpy(a).to("cuda") for a in (rowptr.astype(np.int32), col, w)),
        size=(n, n))
    out_l = torch.sparse.mm(csr, emb)
    check(bool(((out_l - out_k).abs() <= 1e-6 + 1e-3 * out_l.abs()).all()),
          "torch.sparse.mm on the CSR of the same matrix disagrees with ell_spmm")
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, emb), 10)
    # each bucket's items alone (one launch each), by CUDA events; gathered:
    # one table row per edge
    scratch = torch.empty_like(emb)
    buckets = sch.item_bucket
    per_bucket = []
    for b, (rows_b, wd) in enumerate(shapes):
        part = sch.select(buckets == b)
        edges_b = int((ell.blocks[b].nbr != n).sum())
        t = time_ms(lambda part=part: ell_spmm_into(ell, emb, scratch, part), 10)
        per_bucket.append(dict(width=wd, rows=rows_b, edges=edges_b, items=len(part.items),
                               ms=t, gathered_tbps=edges_b * d * 4 / (t * 1e9)))
    b4_bound, b4_by, byts, flops, slots, edges, gathered, all_slots = ell_bound(
        ell, d, 4, bw)
    check(edges == train_e.shape[1], f"the ELL blocks hold {edges} edges, the train "
          f"split {train_e.shape[1]}")
    gathered_bytes = edges * d * 4
    log(f"[kernel] ell_spmm, one hop at ({n} nodes, {edges} edges in {slots} ELL "
        f"slots, d={d}, f32; {len(shapes)} buckets; work list of {len(sch.items)} items, "
        f"{len(sch.split_rows)} split rows in {sch.num_segments} segments, budget "
        f"{sch.budget} live slots, built in {t_list:.4f} s on the host with its upload): "
        f"{b4_dev:.4f} ms of device time per call (profiler, the mean of the "
        f"{b4_launches * 10:g} launches it recorded of 10 calls, no other kernel and "
        f"{b4_memsets:g} memsets), {b4_events:.4f} ms by CUDA events; gathered "
        f"{gathered_bytes / 1e6:.1f} MB (one table row per edge): "
        f"{gathered_bytes / (b4_dev * 1e9):.2f} TB/s by the profiler, "
        f"{gathered_bytes / (b4_events * 1e9):.2f} TB/s by events; plain spmm_ell "
        f"{b4_plain:.4f} ms, spmm_segment {seg_ms:.4f} ms, torch.sparse.mm (CSR) "
        f"{lib_ms:.4f} ms; bound {b4_bound:.4f} ms ({b4_by}: {byts / 1e6:.1f} MB "
        f"compulsory: the edges' slots, one padding id per row, the table read and "
        f"written; {flops / 1e9:.2f} GFLOP), {b4_bound / b4_dev:.3f} of the bound; "
        f"reading every slot, padding included, would take {all_slots:.4f} ms; with "
        f"every gather charged {gathered:.4f} ms; max abs err vs plain {b4_err:.3e}")
    for pb in per_bucket:
        log(f"[kernel]   bucket width {pb['width']}: {pb['rows']} rows, {pb['edges']} "
            f"edges, {pb['items']} items alone {pb['ms']:.4f} ms by events, "
            f"{pb['gathered_tbps']:.2f} TB/s gathered")
    rows = [dict(name="ell_spmm", **KERNEL_ROWS["ell_spmm"],
                 launches=path_launches["ell_spmm"], max_abs_err=b4_err, ms=b4_dev,
                 plain_ms=b4_plain, bound_ms=b4_bound, bound_by=b4_by, library_ms=lib_ms,
                 ms_method="device time of one hop (one launch), torch.profiler",
                 kernel_ms=b4_dev, wrapper_ms=b4_events, segment_ms=seg_ms,
                 memsets_per_call=b4_memsets,
                 list_s=t_list, per_bucket=per_bucket)]
    del csr, out_l, out_k, scratch, coo, ell

    # 7d. mips_block per 256-query call: time, plain, library, bound
    users_d = torch.as_tensor(users, device="cuda")
    q = bpr.normalize_embedding(trained.user_emb[users_d]).contiguous()
    c = bpr.normalize_embedding(trained.item_emb).contiguous()
    mask = torch.from_numpy(seen).to("cuda").to(torch.int8).contiguous()
    block = 4096
    nb = -(-ni // block)
    s_k, i_k = cuda_mips.mips_block_topk(q, c, TOP_K, block=block, mask=mask)
    s_p, i_p, s_next = plain_block_topk(q, c, TOP_K, block, mask)
    b3_err = check_block_topk(s_k, i_k, s_p, i_p, "mips_block at the serving shape", s_next)
    call = lambda: cuda_mips.mips_block_topk(q, c, TOP_K, block=block, mask=mask)
    b3_dev, b3_kernel = profiled_ms(call, 20, "mips_block_kernel")
    b3_events = time_ms(call, 20)
    b3_plain = time_ms(lambda: cuda_mips.mips_block_topk_plain(
        q, c, TOP_K, block=block, mask=mask), 5, warmup=1)
    mb = mask.bool()
    lib = lambda: torch.topk(torch.matmul(q, c.T).masked_fill_(mb, NEG_INF), TOP_K)
    b3_lib = time_ms(lib, 20)
    byts = (c.numel() + q.numel()) * 4 + mask.numel() + nb * users.size * TOP_K * 8
    flops = 2.0 * users.size * ni * d
    # f32-exact scores: f32 FMA, or three TF32 tensor-core products each
    t_bytes = byts / bw * 1e3
    t_ffma, t_tf32 = flops / F32_FLOPS * 1e3, 3 * flops / TF32_FLOPS * 1e3
    t_ops = min(t_ffma, t_tf32)
    b3_bound, b3_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    b3_basis = ("bytes" if b3_by == "bytes"
                else "3 TF32 products" if t_tf32 <= t_ffma else "f32 FMA")
    log(f"[kernel] mips_block at (Q {users.size}, N {ni}, block {block} -> nb {nb}, "
        f"d={d}, k={TOP_K}, int8 mask): {b3_dev:.4f} ms of device time per call "
        f"(profiler; kernel alone {b3_kernel:.4f} ms), {b3_events:.4f} ms by CUDA "
        f"events; plain {b3_plain:.4f} ms; torch.matmul + masked_fill_ + torch.topk "
        f"{b3_lib:.4f} ms; bound {b3_bound:.4f} ms ({b3_basis}: {byts / 1e6:.2f} MB "
        f"take {t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP take {t_ffma:.4f} ms as f32 FMA "
        f"and {t_tf32:.4f} ms as 3 TF32 products), {b3_bound / b3_dev:.3f} of the "
        f"bound; max score diff vs plain {b3_err:.3e}")
    rows.append(dict(name="mips_block", **KERNEL_ROWS["mips_block"],
                     launches=block_launches["mips_block"], max_abs_err=b3_err,
                     ms=b3_dev, plain_ms=b3_plain, bound_ms=b3_bound, bound_by=b3_by,
                     library_ms=b3_lib, bound_basis=b3_basis, bytes_ms=t_bytes,
                     ffma_ms=t_ffma, tf32x3_ms=t_tf32,
                     ms_method="device time of one call, torch.profiler",
                     kernel_ms=b3_kernel, wrapper_ms=b3_events))
    return rows


def fullgraph_phase(data, bw: float, smi: str, b4_row: dict) -> dict:
    """Phase 5c: ``train-fullgraph-full``, the full-graph trainer on the
    interaction split of the same graph at the JAX flagship's width (L = 3,
    d = 256, 100 hybrid parts, bf16 blocks, 8 popularity negatives, 16 steps
    an epoch, cosine lr 3e-3 with 32 warmup steps). Host set-up times; the
    hybrid propagation against ``spmm_segment`` of the whole train graph
    (f32 and bf16 blocks); the symmetric VJP's table gradients against
    autodiff through ``spmm_segment``; the transposed backward on a small
    edge-split graph; one step twice, bit-equal; ``sorted_index_add`` and
    ``gather_rows``' gradient at one step's index sets, bit-equal to the
    host's plain version and within 1e-5 of the largest entry of
    ``index_add_`` on the card; the alias sampler's law;
    ``train_model`` for 2 epochs; a timed epoch and a profiled window of 4
    steps; B4 at the remainder's shape. Adds its numbers to ``b4_row``;
    returns the full-graph config, training data and eval batches."""
    from movie_recommender_system_with_gnns_tpu_torch.config import (
        Config, DataConfig, ModelConfig, TrainConfig)
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import (
        COOGraph, EllGraph, gcn_norm)
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
        forward_half, partition_assignments)
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_scatter, cuda_spmm
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_scatter import sort_rows
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import (
        ell_schedule, spmm_ell_cuda)
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import (
        TripletBatch, item_popularity, sample_negative_alias)
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import (
        DeviceCOO, DeviceELL, block_matmul, build_hybrid_graph, spmm_ell, spmm_hybrid,
        spmm_hybrid_sym, spmm_segment)
    from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import save_params
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
        prepare_training_data)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        AdamState, TrainState, compute_loss, create_train_state, epoch_generator,
        loss_and_grads, train_model)

    launches = _build.LAUNCHES
    nu, ni = data.num_users, data.num_items
    n, d, layers = nu + ni, FG["dim"], FG["layers"]
    cfg = Config(
        data=DataConfig(dataset="synthetic", split_level="interaction", split_seed=SEED,
                        indexes_dir=str(WORK / "fg_indexes")),
        model=ModelConfig(num_layers=layers, dim=d, readout="standard"),
        train=TrainConfig(trainer="fullgraph", loss="standard", negatives="popularity",
                          num_negatives=FG["negatives"], fullgraph_steps=FG["steps"],
                          num_clusters=FG["parts"], lr=FG["lr"], lr_schedule="cosine",
                          lr_warmup_steps=FG["warmup"], epochs=FG["epochs"],
                          checkpoint_path=str(WORK / "fg_best.npz")))

    # 1. set-up on the host: the pipeline as a user calls it, then its parts
    t0 = time.time()
    bundle = prepare_training_data(cfg, data=data, device="cuda")
    torch.cuda.synchronize()
    t_prep = time.time() - t0
    fg, val, test = bundle.train, bundle.val, bundle.test
    train_e = bundle.splits[0]
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, lr_total_steps=fg.num_steps * FG["epochs"]))
    check(fg.symmetric_ok and fg.hybrid.off_ell is not None and fg.hybrid.off_ell_t is None
          and fg.alias_table is not None and fg.batch % 1024 == 0,
          "the interaction split's full-graph data is not symmetric, has no ELL "
          "remainder or alias table, or built a transpose")
    t0 = time.time()
    pu, pi = partition_assignments(train_e, nu, n, FG["parts"], seed=SEED,
                                   uv=forward_half(train_e, nu))
    t_part = time.time() - t0
    node_part = np.concatenate([pu, pi])
    src, dst = train_e[0].astype(np.int64), train_e[1].astype(np.int64)
    intra = node_part[src] == node_part[dst]
    t0 = time.time()
    h32 = build_hybrid_graph(train_e, n, node_part, FG["parts"], block_dtype="float32",
                             device="cuda")
    torch.cuda.synchronize()
    t_h32 = time.time() - t0
    check(torch.equal(h32.ids, fg.hybrid.ids) and torch.equal(h32.pos, fg.hybrid.pos),
          "the pipeline's hybrid graph has another partition than partition_assignments")
    w_off = gcn_norm(train_e, n)[~intra]
    t0 = time.time()
    g_off = EllGraph.build(np.stack([src[~intra], dst[~intra]]), n, weights=w_off)
    t_ell = time.time() - t0
    t0 = time.perf_counter()
    ell_schedule(g_off.blocks, n, "cuda")
    torch.cuda.synchronize()
    t_list = time.perf_counter() - t0
    k_parts, p_w = fg.hybrid.ids.shape
    off = fg.hybrid.off_ell
    sched = off.schedule
    setup = dict(pairs=fg.e_real, batch=fg.batch, steps=fg.num_steps, parts=k_parts,
                 block_width=p_w, blocks_gb_bf16=fg.hybrid.adj.numel() * 2 / 1e9,
                 intra_retention=float(intra.mean()), remainder_edges=int((~intra).sum()),
                 prepare_s=t_prep, partition_s=t_part, hybrid_f32_build_s=t_h32,
                 remainder_ell_build_s=t_ell, remainder_work_list_s=t_list,
                 remainder_buckets=[(b.rows, b.width) for b in g_off.blocks],
                 remainder_items=len(sched.items), remainder_split_rows=len(sched.split_rows))
    log(f"[fullgraph] set-up on the host: {json.dumps(setup)}")
    check(fg.batch * fg.num_steps >= fg.e_real > fg.batch * (fg.num_steps - 1),
          f"batch {fg.batch} x {fg.num_steps} steps does not cover {fg.e_real} pairs")

    # 2. spmm_hybrid against spmm_segment of the whole train graph
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    coo = DeviceCOO.from_host(COOGraph.build(train_e, n), "cuda")
    x = torch.randn(n, d, device="cuda", generator=gen)
    ref = spmm_segment(coo, x)
    top = ref.abs().max().item()
    e32 = (spmm_hybrid(h32, x) - ref).abs().max().item()
    check(e32 <= 1e-5 * top, f"spmm_hybrid (f32 blocks) vs spmm_segment: {e32:.3e} "
          f"of a largest entry {top:.3e}")
    # bf16 blocks round both operands of each intra-part product (2^-8 of
    # each, so 2^-7 + 2^-16 of |w·x| together); the f32 sums add 1e-5 of the top
    bound = (2.0 ** -7 + 2.0 ** -16) * spmm_segment(coo, x.abs()) + 1e-5 * top
    err16 = (spmm_hybrid(fg.hybrid, x) - ref).abs()
    check(bool((err16 <= bound).all()), f"spmm_hybrid (bf16 blocks) vs spmm_segment: max "
          f"abs err {err16.max().item():.3e}, beyond the bf16 operand rounding")
    log(f"[fullgraph] spmm_hybrid vs spmm_segment of the whole train graph (d={d}, "
        f"TF32 {torch.backends.cuda.matmul.allow_tf32}): f32 blocks max abs err "
        f"{e32:.3e}, bf16 blocks {err16.max().item():.3e} (within (2^-7 + 2^-16)·"
        f"|Â|·|x| + 1e-5·{top:.3e} everywhere)")
    del err16, bound

    # 3. the symmetric VJP's table gradients against autodiff through the oracle
    state0 = create_train_state(cfg, nu, ni, generator=torch.Generator().manual_seed(SEED),
                                device="cuda")
    b = fg.batch
    neg = sample_negative_alias(gen, b, ni, *fg.alias_table, num=FG["negatives"])
    tb = TripletBatch(fg.user[:b], fg.pos_item[:b], torch.ones(b, dtype=torch.bool,
                                                               device="cuda"))
    l_h, g_h = loss_and_grads(compute_loss, state0.params, h32, tb, neg, cfg, spmm_hybrid_sym)
    l_s, g_s = loss_and_grads(compute_loss, state0.params, coo, tb, neg, cfg, spmm_segment)
    ru, ri = rel_max(g_h.user_emb, g_s.user_emb), rel_max(g_h.item_emb, g_s.item_emb)
    check(abs(l_h.item() - l_s.item()) < 1e-5 and ru < 1e-4 and ri < 1e-4,
          f"symmetric VJP vs autodiff through spmm_segment: loss {l_h.item()!r} vs "
          f"{l_s.item()!r}, grad rel err user {ru:.3e} item {ri:.3e}")
    log(f"[fullgraph] compute_loss through spmm_hybrid_sym (f32 blocks) vs autodiff "
        f"through spmm_segment, batch {b} x {FG['negatives']} negatives: loss "
        f"{l_h.item():.7f} vs {l_s.item():.7f}, grad rel err user {ru:.3e}, item {ri:.3e}")
    del g_h, g_s, h32, coo, ref, x

    # 4. the transposed backward on a small edge-split graph
    small = make_synthetic_movielens(SMALL["users"], SMALL["items"], SMALL["interactions"],
                                     seed=SEED, power=SMALL["power"],
                                     num_communities=SMALL["communities"])
    s_e = split_edges(small, str(WORK / "fg_small_indexes"), seed=SEED)[0]
    s_n = small.num_users + small.num_items
    spu, spi = partition_assignments(s_e, small.num_users, s_n, SMALL["clusters"], seed=SEED)
    hs = build_hybrid_graph(s_e, s_n, np.concatenate([spu, spi]), SMALL["clusters"],
                            block_dtype="float32", transpose=True, device="cuda")
    full = DeviceELL.from_host(EllGraph.build(s_e, s_n), "cuda")
    xs = torch.randn(s_n, 64, device="cuda", generator=gen)
    cot = torch.randn_like(xs)
    grads = []
    before = launches["ell_spmm"]
    for fn in (lambda v: spmm_hybrid(hs, v), lambda v: spmm_ell(full, v)):
        xr = xs.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xr), xr, cot)[0])
    torch.cuda.synchronize()
    rt = rel_max(*grads)
    check(launches["ell_spmm"] - before == 2 and rt < 1e-5,
          f"transposed backward on the edge split: rel err {rt:.3e} vs autodiff "
          f"through the plain spmm_ell, {launches['ell_spmm'] - before} launches")
    log(f"[fullgraph] spmm_hybrid on the edge split of the {SMALL['users']}-user graph "
        f"(asymmetric, transpose built): gradient rel err {rt:.3e} vs autodiff through "
        f"the plain spmm_ell of the whole graph; 1 ell_spmm launch forward, 1 backward")
    del hs, full, grads

    # 5. one step twice from the same state, shuffle and negatives
    copy = lambda st: TrainState(
        type(st.params)(*(t.clone() for t in st.params)),
        AdamState(st.opt_state.count, *(type(m)(*(t.clone() for t in m))
                                        for m in (st.opt_state.mu, st.opt_state.nu))),
        st.step)
    one = fullgraph.FullGraphTrainData(fg.hybrid, fg.user[:b], fg.pos_item[:b], b, 1, b,
                                       fg.symmetric_ok, alias_table=fg.alias_table)
    fn1 = fullgraph.make_fullgraph_epoch_fn(cfg, one)
    before = dict(launches)
    runs = [fn1(copy(state0), one, torch.Generator(device="cuda").manual_seed(SEED + 9))
            for _ in range(2)]
    torch.cuda.synchronize()
    per_step = {k: (launches[k] - before.get(k, 0)) // 2 for k in launches}
    (a, la), (c, lc) = runs
    same = [torch.equal(u, v) for u, v in zip(a.params + a.opt_state.mu + a.opt_state.nu,
                                              c.params + c.opt_state.mu + c.opt_state.nu)]
    check(all(same) and la == lc, f"a full-graph step is not bit-equal over two runs "
          f"(params and moments equal: {same}, losses {la!r} {lc!r})")
    check(per_step.get("ell_spmm", 0) == 2 * layers,
          f"a full-graph step launched {per_step.get('ell_spmm', 0)} ell_spmm kernels, "
          f"expected {2 * layers} ({layers} hops forward, {layers} backward)")
    log(f"[fullgraph] one step run twice: parameters and Adam moments bit-equal, loss "
        f"{la:.7f}; kernel launches per step {per_step}")
    del runs, a, c

    # 5b. sorted_index_add (gather_rows' backward) at one step's index sets:
    # the users, and the positives with the popularity negatives, d = 256 f32
    perm = torch.randperm(fg.e_real, generator=gen, device="cuda")[:b]
    step_u = fg.user[perm]
    step_i = torch.cat([fg.pos_item[perm],
                        sample_negative_alias(gen, b, ni, *fg.alias_table,
                                              num=FG["negatives"]).reshape(-1)])
    scatter = {}
    for side, idx, rows in (("users", step_u, nu), ("items", step_i, ni)):
        what = f"sorted_index_add at a full-graph step's {side}"
        order, starts = sort_rows(idx, rows)
        g_rows = torch.randn(idx.numel(), d, device="cuda", generator=gen)
        sc = lambda: cuda_scatter.sorted_index_add(g_rows, order, starts, rows)
        lib = lambda: torch.zeros(rows, d, device="cuda").index_add_(0, idx, g_rows)
        out_k, out_l = sc(), lib()
        table = torch.randn(rows, d, device="cuda", generator=gen).requires_grad_(True)
        (g_tab,) = torch.autograd.grad(cuda_scatter.gather_rows(table, idx, order, starts),
                                       table, g_rows)
        torch.cuda.synchronize()
        out_h = cuda_scatter.sorted_index_add_plain(g_rows.cpu(), order.cpu(), starts.cpu(),
                                                    rows)
        top = out_l.abs().max().item()
        err = (out_k - out_l).abs().max().item()
        check(torch.equal(out_k.cpu(), out_h), f"{what}: differs from the plain version's "
              f"sequential sum on the host (max abs "
              f"{(out_k.cpu() - out_h).abs().max().item():.3e})")
        check(torch.equal(out_k, sc()), f"{what}: two calls differ")
        check(err <= 1e-5 * top, f"{what}: {err:.3e} from index_add_ on the card, largest "
              f"entry {top:.3e}")
        check(torch.equal(g_tab, out_k), f"{what}: gather_rows' gradient differs from the "
              f"kernel's sum")
        del out_h, out_l, table, g_tab
        k_ms, l_ms = time_ms(sc, 10), time_ms(lib, 10)
        run = int((starts[1:] - starts[:-1]).max())
        byts = idx.numel() * d * 4 + 4 * idx.numel() + 4 * (rows + 1) + rows * d * 4
        scatter[side] = dict(entries=idx.numel(), rows=rows, longest_run=run, ms=k_ms,
                             index_add_ms=l_ms, bound_ms=byts / bw * 1e3, max_abs_err=err)
        log(f"[kernel] {what} ({idx.numel()} entries over {rows} rows, longest run {run}, "
            f"d={d}, f32): bit-equal to the plain version on the host, over two calls and "
            f"as gather_rows' gradient; max abs err vs index_add_ on the card {err:.3e} "
            f"(largest entry {top:.3e}); {k_ms:.4f} ms by CUDA events, zeros + index_add_ "
            f"{l_ms:.4f} ms, bound {byts / bw * 1e3:.4f} ms (bytes: {byts / 1e6:.1f} MB)")
        del out_k, g_rows, order, starts
    # a step sums four gathered tables' gradients: two over each index set
    det_ms = 2 * (scatter["users"]["ms"] + scatter["items"]["ms"])
    lib_ms = 2 * (scatter["users"]["index_add_ms"] + scatter["items"]["index_add_ms"])
    log(f"[fullgraph] a step's four row-gradient sums: sorted_index_add {det_ms:.4f} ms, "
        f"zeros + index_add_ (float atomics, not reproducible) {lib_ms:.4f} ms")
    del perm, step_u, step_i

    # 6. the alias sampler's law on the card
    draws = 10_000_000
    counts = torch.bincount(sample_negative_alias(gen, draws, ni, *fg.alias_table).long(),
                            minlength=ni).double()
    w = torch.from_numpy(item_popularity(train_e, nu, ni).astype(np.float64) ** 0.75)
    p_exp = (w / w.sum()).to("cuda")
    expect = draws * p_exp
    big = expect >= 100
    z = ((counts - expect).abs() / (expect * (1 - p_exp)).sqrt())[big]
    check(z.max().item() <= 5.0, f"alias draws: an item {z.max().item():.2f} sigma off "
          f"count^0.75 / sum")
    log(f"[fullgraph] sample_negative_alias, {draws} draws: {int(big.sum())} items with "
        f"an expected count >= 100, largest deviation {z.max().item():.2f} sigma")
    del counts, z

    # 7. train_model for 2 epochs, best-val checkpoint; the plain spmm_ell is
    # counted to show that no hop left the kernel
    saved = []

    def save_cb(st, recall):
        saved.append(recall)
        save_params(cfg.train.checkpoint_path, st.params, meta={"val_recall": recall})

    plain = [0]
    real_plain = cuda_spmm.spmm_ell

    def counted(*args, **kw):
        plain[0] += 1
        return real_plain(*args, **kw)

    state = copy(state0)
    launches.clear()
    cuda_spmm.spmm_ell = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state, hist = train_model(cfg, state, fg, val, test, save_checkpoint=save_cb)
        torch.cuda.synchronize()
        t_train = time.time() - t0
    finally:
        cuda_spmm.spmm_ell = real_plain
    fg_launches = dict(launches)
    steps = FG["epochs"] * fg.num_steps
    log(f"[fullgraph] train_model {FG['epochs']} epochs + test eval: {t_train:.2f} s, "
        f"epoch times with the val eval {[round(t, 3) for t in hist['epoch_time_s']]} s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; train loss "
        f"{hist['train_loss']}, val loss {hist['val_loss']}, val recall "
        f"{hist['val_recall']}; kernel launches {fg_launches}")
    check(all(np.isfinite(v) for key in hist for v in hist[key]),
          f"a full-graph loss or metric is not finite: {hist}")
    check(hist["train_loss"][1] < hist["train_loss"][0],
          f"full-graph train loss did not fall: {hist['train_loss']}")
    check(state.step == steps and bool(saved) and Path(cfg.train.checkpoint_path).exists(),
          f"state.step {state.step} != {steps}, or no best-val checkpoint")
    check(fg_launches.get("ell_spmm", 0) == 2 * layers * steps and plain[0] == 0,
          f"ell_spmm launched {fg_launches.get('ell_spmm', 0)} times for {steps} steps "
          f"(expected {2 * layers * steps}); plain spmm_ell calls {plain[0]}")
    evals = (FG["epochs"] + 1) * layers
    check(fg_launches.get("sorted_index_add", 0) == 4 * steps + evals,
          f"sorted_index_add launched {fg_launches.get('sorted_index_add', 0)} times, "
          f"expected 4 per step (the four gathered tables' gradients) and {evals} "
          f"for the evals' propagation hops")

    # 8. a third epoch alone, then 4 steps under the profiler
    epoch_fn = fullgraph.make_fullgraph_epoch_fn(cfg, fg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, loss3 = epoch_fn(state, fg, epoch_generator(cfg, FG["epochs"],
                                                       torch.device("cuda")))
    torch.cuda.synchronize()
    t_epoch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(np.isfinite(loss3), "the third full-graph epoch's loss is not finite")
    four = fullgraph.FullGraphTrainData(fg.hybrid, fg.user[:4 * b], fg.pos_item[:4 * b],
                                        4 * b, 4, b, fg.symmetric_ok,
                                        alias_table=fg.alias_table)
    fn4 = fullgraph.make_fullgraph_epoch_fn(cfg, four)
    gen4 = torch.Generator(device="cuda").manual_seed(SEED + 10)
    box = [state]

    def four_steps():
        box[0], _ = fn4(box[0], four, gen4)

    before = launches["ell_spmm"]
    prof = profile_window("4 full-graph train steps", 1, 14, four_steps)
    # the window runs the 4 steps twice (a warm-up, then the traced run)
    b4_per_traced_step = (launches["ell_spmm"] - before) / 8
    b4_per_step = fg_launches.get("ell_spmm", 0) / steps

    # 9. B4 at the remainder's shape, beside the block product
    emb = torch.cat(list(state.params)).contiguous()
    out_k, out_p = spmm_ell_cuda(off, emb), spmm_ell(off, emb)
    r_err = (out_k - out_p).abs()
    check(bool((r_err <= 1e-6 + 1e-3 * out_p.abs()).all()),
          f"ell_spmm at the remainder vs plain: max abs err {r_err.max().item():.3e}")
    r_err = r_err.max().item()
    del out_p
    hop_ms = time_ms(lambda: spmm_ell_cuda(off, emb), 20)
    hop_plain = time_ms(lambda: spmm_ell(off, emb), 3, warmup=1)
    rows_o = np.argsort(dst[~intra], kind="stable")
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(dst[~intra], minlength=n))])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(rowptr.astype(np.int32)).to("cuda"),
        torch.from_numpy(src[~intra][rows_o].astype(np.int32)).to("cuda"),
        torch.from_numpy(w_off[rows_o]).to("cuda"), size=(n, n))
    check(bool(((torch.sparse.mm(csr, emb) - out_k).abs() <= 1e-6 + 1e-3 * out_k.abs()).all()),
          "torch.sparse.mm on the remainder's CSR disagrees with ell_spmm")
    hop_lib = time_ms(lambda: torch.sparse.mm(csr, emb), 20)
    hop_bound, hop_by, byts, flops, slots, edges, gathered, _ = ell_bound(off, d, 4, bw)
    check(edges == setup["remainder_edges"], f"the remainder ELL holds {edges} edges")
    blk_in = emb.index_select(0, fg.hybrid.ids.reshape(-1)).view(k_parts, p_w, d)
    blk_ms = time_ms(lambda: block_matmul(fg.hybrid.adj, blk_in), 20)
    blk_flops = 2.0 * k_parts * p_w * p_w * d
    del csr, out_k, blk_in
    numbers = dict(
        card=smi, step_ms=1e3 * t_epoch / fg.num_steps, epoch_s=t_epoch,
        profiled_wall_ms_per_step=prof["wall_ms"] / 4, busy_ms_per_step=prof["busy_ms"] / 4,
        idle_share=prof["idle_share"], launches_per_step=prof["kernels"] / 4,
        b4_launches_per_step=b4_per_step, b4_launches_per_traced_step=b4_per_traced_step,
        peak_gb=peak / 1e9,
        epoch_peak_over_resident_gb=(peak - resident) / 1e9,
        train_loss=hist["train_loss"] + [loss3], val_recall=hist["val_recall"],
        b4_remainder_hop_ms=hop_ms, b4_remainder_plain_ms=hop_plain,
        b4_remainder_bound_ms=hop_bound, b4_remainder_bound_by=hop_by,
        b4_remainder_sparse_mm_ms=hop_lib, b4_remainder_edges=edges,
        b4_remainder_slots=slots, b4_remainder_gathered_tbps=edges * d * 4 / (hop_ms * 1e9),
        block_product_ms=blk_ms, block_product_tflops=blk_flops / (blk_ms * 1e9),
        row_grad_sums_ms=det_ms, row_grad_index_add_ms=lib_ms, row_grad_scatter=scatter,
        **setup)
    log(f"[fullgraph] {json.dumps(numbers)}")
    log(f"[kernel] ell_spmm at the full-graph remainder ({n} nodes, {edges} edges in "
        f"{slots} slots, d={d}, f32): {hop_ms:.4f} ms a hop by CUDA events, plain "
        f"{hop_plain:.4f} ms, torch.sparse.mm (CSR) {hop_lib:.4f} ms, bound "
        f"{hop_bound:.4f} ms ({hop_by}: {byts / 1e6:.1f} MB), {hop_bound / hop_ms:.3f} of "
        f"the bound, {edges * d * 4 / (hop_ms * 1e9):.2f} TB/s gathered; max abs err vs "
        f"plain {r_err:.3e}; the bf16 block product ({k_parts} x {p_w}^2, d={d}) "
        f"{blk_ms:.4f} ms, {blk_flops / (blk_ms * 1e9):.1f} TFLOP/s")
    b4_row.update(
        launches=b4_row["launches"] + fg_launches.get("ell_spmm", 0),
        launches_eval=b4_row["launches"], launches_fullgraph=fg_launches.get("ell_spmm", 0),
        launches_per_fullgraph_step=b4_per_step, fullgraph_hop_ms=hop_ms,
        fullgraph_plain_ms=hop_plain, fullgraph_bound_ms=hop_bound,
        fullgraph_bound_by=hop_by, fullgraph_library_ms=hop_lib,
        fullgraph_max_abs_err=r_err)
    del state, state0, bundle, emb
    return dict(cfg=cfg, fg=fg, val=val, test=test)


def states_equal(a, b) -> list:
    """``torch.equal`` (``==`` for the ints) leaf by leaf."""
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        state_leaves)

    return [torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(state_leaves(a), state_leaves(b))]


def recovered_vs_uninterrupted(what: str, cfg, state_fn, train_obj, val, test) -> dict:
    """Run ``cfg`` (full-state checkpoints every 2 epochs) twice in their own
    directories under ``WORK``: once through ``train_model`` uninterrupted,
    once through ``train_with_recovery`` with ``RuntimeError("UNAVAILABLE:
    ...")`` raised from ``on_epoch_end`` after epoch 0 (before the first
    checkpoint) and after epoch 1 (after it). Checks tables, moments, count,
    step, the stitched histories, the best-val checkpoint and the one row
    per epoch of ``metrics.jsonl`` equal; returns both runs' states, wall
    times, epochs run and launches."""
    fail_at = [0, 1]
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_params, save_params)
    from movie_recommender_system_with_gnns_tpu_torch.training.recovery import (
        train_with_recovery)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import train_model
    from movie_recommender_system_with_gnns_tpu_torch.utils.observability import MetricsLogger

    out = {}
    for run in ("uninterrupted", "recovered"):
        run_dir = WORK / f"{what}_{run}"
        run_dir.mkdir(parents=True)
        cfg_r = cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_path=str(run_dir / "best.npz"),
            histories_dir=str(run_dir / "hist"),
            state_checkpoint_path=str(run_dir / "state.npz")))
        logger = MetricsLogger(str(run_dir / "hist" / "metrics.jsonl"))
        armed, calls = list(fail_at) if run == "recovered" else [], []

        def on_epoch_end(epoch, metrics):
            calls.append(epoch)
            if armed and armed[0] == epoch:
                armed.pop(0)
                raise RuntimeError(f"UNAVAILABLE: injected drop after epoch {epoch}")

        def save_cb(st, recall, path=cfg_r.train.checkpoint_path):
            save_params(path, st.params, meta={"val_recall": recall})

        state = state_fn()
        launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kw = dict(on_epoch_end=on_epoch_end, save_checkpoint=save_cb, metrics_logger=logger)
        if run == "uninterrupted":
            state, hist = train_model(cfg_r, state, train_obj, val, test, **kw)
        else:
            state, hist = train_with_recovery(cfg_r, state, train_obj, val, test,
                                              retry_backoff_s=0.0, **kw)
        torch.cuda.synchronize()
        rows = [{k: v for k, v in r.items() if k not in ("ts", "epoch_time_s")}
                for r in MetricsLogger.read(logger.path)]
        out[run] = dict(state=state, hist=hist, wall_s=time.perf_counter() - t0,
                        launches=dict(launches), calls=calls, rows=rows,
                        best=load_params(cfg_r.train.checkpoint_path, device="cuda")[0])
    a, b = out["uninterrupted"], out["recovered"]
    same = states_equal(a["state"], b["state"])
    check(all(same), f"{what}: the recovered run's tables, moments, count and step are "
          f"not equal to the uninterrupted run's ({same})")
    for k in ("train_loss", "val_loss", "val_recall", "test_loss", "test_recall"):
        check(a["hist"][k] == b["hist"][k], f"{what}: the stitched {k} {b['hist'][k]} "
              f"differs from the uninterrupted {a['hist'][k]}")
    check(all(torch.equal(x, y) for x, y in zip(a["best"], b["best"])),
          f"{what}: the best-val checkpoints' tables differ")
    epochs = cfg.train.epochs
    check(b["rows"] == a["rows"] and [r["step"] for r in b["rows"]] == list(range(epochs)),
          f"{what}: metrics.jsonl is not one row per epoch equal to the uninterrupted "
          f"run's: {[r['step'] for r in b['rows']]}")
    check(b["calls"] == [0] + list(range(epochs)), f"{what}: the recovered run ran "
          f"epochs {b['calls']}, not epoch 0 again and then every epoch once")
    log(f"[recovery] {what}: recovered run (drops after epochs {fail_at}; epochs run "
        f"{b['calls']}) torch.equal to the uninterrupted run in tables, moments, count "
        f"{b['state'].opt_state.count} and step {b['state'].step}, histories, best-val "
        f"checkpoint and {epochs} metrics rows; wall {a['wall_s']:.2f} s uninterrupted, "
        f"{b['wall_s']:.2f} s recovered; launches {a['launches']} / {b['launches']}")
    return out


def recovery_phase(data, train_e, cfg, cc, val, test, hist_hybrid: dict,
                   timings: dict, fgp: dict, smi: str) -> None:
    """Phase 5d: full-state checkpoints, elastic recovery and exact-feasible
    negatives at full width. (a) 10 M feasible draws against the train
    split's member table, equal to the rule run on the host (NumPy) from the
    same candidates, residual members within 5 sigma of Σ (deg_u / I)^(R+1),
    timed; (b) ``hybrid_adam`` with the fused kernel under feasible
    negatives, 2 epochs through ``train_model`` (200 B1 launches, falling
    losses, a step bit-equal over two runs, val recall beside uniform's), a
    timed epoch and a profiled window beside uniform's; (c) the compact
    trainer recovered from a drop before its first checkpoint and one after
    epoch 1, ``torch.equal`` to an uninterrupted 4-epoch run; (d) the same
    for the full-graph trainer at ``FG`` over 3 epochs (B4 counted); the
    save and load seconds of both full states; (e) a state saved on the
    card, loaded on the CPU and saved again, byte-equal per array; (f) ``cli
    train --max-retries 1 --negatives feasible --fused-bpr --optimizer
    hybrid_adam`` at the small synthetic size."""
    from movie_recommender_system_with_gnns_tpu_torch import cli
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import forward_half
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import (
        _member_probe, build_member_table, feasible_from_draws, member_keys,
        sample_negative_feasible)
    from movie_recommender_system_with_gnns_tpu_torch.training import compact
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_state_meta, load_train_state, save_train_state)
    from movie_recommender_system_with_gnns_tpu_torch.training.recovery import state_to
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        TrainState, create_train_state, epoch_generator, train_model)
    from movie_recommender_system_with_gnns_tpu_torch.utils.observability import MetricsLogger

    t_phase = time.time()
    nu, ni = data.num_users, data.num_items
    numbers = dict(card=smi)

    # (a) feasible draws at the full graph
    t0 = time.time()
    u, it = forward_half(train_e, nu)
    table = build_member_table(u.astype(np.int32), it.astype(np.int32))
    keys = member_keys(table, "cuda")
    torch.cuda.synchronize()
    numbers.update(member_pairs=int((table[0] < np.iinfo(np.int32).max).sum()),
                   member_table_mb=table.nbytes / 1e6, member_keys_mb=keys.numel() * 8 / 1e6,
                   member_build_s=time.time() - t0)
    draws_n, rounds = 10_000_000, 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    users = torch.from_numpy(u.astype(np.int32)).to("cuda")[
        torch.randint(0, u.shape[0], (draws_n,), generator=gen, device="cuda")]
    cand = torch.randint(0, ni, (rounds + 1, draws_n), generator=gen, device="cuda",
                         dtype=torch.int32)
    neg = feasible_from_draws(users, cand, keys)
    # the rule on the host, in NumPy, from the same candidates: a candidate
    # that is a train pair of its user is replaced by the next round's
    host_keys = keys.cpu().numpy()
    hu, hc = users.cpu().numpy().astype(np.int64), cand.cpu().numpy()
    want = hc[0].copy()
    live = np.arange(draws_n)
    for r in range(1, rounds + 1):
        q = (hu[live] << 31) | want[live].astype(np.int64)
        pos = np.minimum(np.searchsorted(host_keys, q), host_keys.size - 1)
        live = live[host_keys[pos] == q]
        want[live] = hc[r][live]
    check(np.array_equal(neg.cpu().numpy(), want),
          "feasible draws on the card differ from the rule run on the host")
    hits = int(_member_probe(keys, users, neg).sum())
    deg = torch.from_numpy(np.bincount(table[0][table[0] < nu], minlength=nu)).to("cuda")
    p = (deg[users.long()].double() / ni) ** (rounds + 1)
    expect, sigma = p.sum().item(), (p * (1 - p)).sum().sqrt().item()
    check(abs(hits - expect) <= 5 * sigma + 1, f"feasible draws: {hits} residual train "
          f"pairs, expected {expect:.3f} (sigma {sigma:.3f})")
    draw_ms = time_ms(lambda: sample_negative_feasible(gen, users, ni, keys, rounds), 5)
    b = cc.user_local.shape[1]
    step_users = cc.user_ids[7].index_select(0, cc.user_local[7])
    step_ms = time_ms(lambda: sample_negative_feasible(gen, step_users, ni, keys, rounds), 50)
    uni_ms = time_ms(lambda: torch.randint(0, ni, (b,), generator=gen, device="cuda",
                                           dtype=torch.int32), 50)
    numbers.update(draws=draws_n, residual_members=hits, residual_expected=expect,
                   residual_sigma=sigma, draw_10m_ms=draw_ms, draw_compact_step_ms=step_ms,
                   uniform_compact_step_ms=uni_ms,
                   first_round_members=int((hc[0] != want).sum()))
    log(f"[feasible] {draws_n} draws against {numbers['member_pairs']} train pairs "
        f"({numbers['member_keys_mb']:.1f} MB of int64 keys, built in "
        f"{numbers['member_build_s']:.1f} s): equal to the rule on the host; "
        f"{numbers['first_round_members']} first candidates were train pairs, {hits} "
        f"remain (expected {expect:.3f}, sigma {sigma:.3f}); {draw_ms:.3f} ms for 10 M by "
        f"events, {step_ms:.4f} ms at a compact step's {b} triplets (uniform "
        f"{uni_ms:.4f}), {smi}")
    del users, cand, neg, p, hc, hu, want

    # (b) compact training under feasible negatives, hybrid_adam + fused B1
    cc_f = compact.attach_member_table(cc, train_e, nu)
    cfg_f = cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer="hybrid_adam", negatives="feasible",
        checkpoint_path=str(WORK / "best_feasible.npz")))
    new_state = lambda: create_train_state(cfg_f, nu, ni, device="cuda",
                                           generator=torch.Generator().manual_seed(SEED))
    launches.clear()
    t0 = time.time()
    state, hist = train_model(cfg_f, new_state(), cc_f, val, test)
    torch.cuda.synchronize()
    got = dict(launches)
    steps = TRAIN["epochs"] * cc.num_clusters
    check(got.get("bpr_tile", 0) == steps, f"feasible: bpr_tile launched "
          f"{got.get('bpr_tile', 0)} times, expected {steps}")
    check(all(np.isfinite(v) for k in hist for v in hist[k])
          and hist["train_loss"][1] < hist["train_loss"][0],
          f"feasible: losses not finite or not falling: {hist}")
    log(f"[feasible] hybrid_adam, fused B1, feasible negatives: train_model "
        f"{TRAIN['epochs']} epochs {time.time() - t0:.2f} s; train loss {hist['train_loss']}, "
        f"val recall {hist['val_recall']} (uniform {hist_hybrid['val_recall']}), test "
        f"recall {hist['test_recall']} (uniform {hist_hybrid['test_recall']}); launches {got}")
    fn = compact.make_compact_epoch_fn(cfg_f)
    runs = [fn(state_to(state, "cuda"), cc_f,
               torch.Generator(device="cuda").manual_seed(SEED + 21), perm=[7])[0]
            for _ in range(2)]
    same = states_equal(*runs)
    check(all(same), f"feasible: one step twice is not bit-equal ({same})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st3, loss3 = fn(state, cc_f, epoch_generator(cfg_f, TRAIN["epochs"], torch.device("cuda")))
    torch.cuda.synchronize()
    t_epoch = time.perf_counter() - t0
    check(np.isfinite(loss3), "feasible: the third epoch's loss is not finite")
    gen_p = torch.Generator(device="cuda").manual_seed(SEED + 3)
    box = [st3]

    def ten_steps():
        box[0], _ = fn(box[0], cc_f, gen_p, perm=list(range(10)))

    prof = profile_window("10 hybrid_adam steps, feasible negatives", 2, 8, ten_steps)
    uni = timings["hybrid_adam"]
    numbers.update(
        feasible_step_ms=1e3 * t_epoch / cc.num_clusters, uniform_step_ms=uni["step_ms"],
        feasible_busy_ms_per_step=prof["busy_ms"] / 10,
        uniform_busy_ms_per_step=uni["busy_ms_per_step"],
        feasible_launches_per_step=prof["kernels"] / 10,
        uniform_launches_per_step=uni["launches_per_step"],
        feasible_idle_share=prof["idle_share"], uniform_idle_share=uni["idle_share"],
        feasible_val_recall=hist["val_recall"], uniform_val_recall=hist_hybrid["val_recall"],
        feasible_test_recall=hist["test_recall"],
        uniform_test_recall=hist_hybrid["test_recall"])
    log(f"[feasible] one step twice bit-equal; epoch 3 alone {t_epoch:.3f} s, "
        f"{numbers['feasible_step_ms']:.3f} ms a step (uniform {uni['step_ms']:.3f}), "
        f"{numbers['feasible_launches_per_step']:.1f} launches a step (uniform "
        f"{uni['launches_per_step']:.1f})")
    del runs, st3, box, state

    # full-state save and load at the compact width (lazy moments: 3 table pairs)
    path = WORK / "compact_state.npz"
    st = create_train_state(cfg_f, nu, ni, device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
    st = TrainState(st.params, compact.init_lazy_adam(st.params), 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(str(path), st, meta={"epoch": 0})
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_train_state(str(path), st)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(all(states_equal(back, st)), "compact state: save/load changed a leaf")
    numbers.update(compact_state_mb=path.stat().st_size / 1e6, compact_save_s=t_save,
                   compact_load_s=t_load)

    # (e) saved on the card, loaded on the CPU, saved again: byte-equal arrays
    cpu_like = state_to(st, "cpu")
    on_cpu = load_train_state(str(path), cpu_like)
    check(on_cpu.params.user_emb.device.type == "cpu", "the CPU load is not on the CPU")
    save_train_state(str(WORK / "compact_state_cpu.npz"), on_cpu, meta={"epoch": 0})
    with np.load(path) as za, np.load(WORK / "compact_state_cpu.npz") as zb:
        check(sorted(za.files) == sorted(zb.files) and all(
            za[f].dtype == zb[f].dtype and za[f].tobytes() == zb[f].tobytes()
            for f in za.files), "a state saved on the card and again from the CPU differs")
    log(f"[recovery] full state at the compact width ({path.stat().st_size / 1e6:.1f} MB): "
        f"save {t_save:.3f} s, load {t_load:.3f} s; card -> file -> CPU -> file byte-equal "
        f"per array")
    del st, back, on_cpu, cpu_like

    # (c) the compact trainer, recovered against uninterrupted, 4 epochs
    cfg_c = cfg_f.replace(train=dataclasses.replace(cfg_f.train, epochs=4,
                                                    state_checkpoint_every=2))
    res = recovered_vs_uninterrupted("compact", cfg_c, new_state, cc_f, val, test)
    for run in res.values():
        check(run["launches"].get("bpr_tile", 0) == len(run["calls"]) * cc.num_clusters,
              f"compact recovery: bpr_tile launched {run['launches'].get('bpr_tile', 0)} "
              f"times for {len(run['calls'])} epochs")
    numbers.update(compact_uninterrupted_s=res["uninterrupted"]["wall_s"],
                   compact_recovered_s=res["recovered"]["wall_s"],
                   compact_epochs_run=res["recovered"]["calls"])
    del res, cc_f

    # (d) the full-graph trainer at FG, 3 epochs
    fg, fcfg = fgp["fg"], fgp["cfg"]
    cfg_g = fcfg.replace(train=dataclasses.replace(
        fcfg.train, epochs=3, state_checkpoint_every=2,
        lr_total_steps=fg.num_steps * 3))
    new_fg = lambda: create_train_state(cfg_g, nu, ni, device="cuda",
                                        generator=torch.Generator().manual_seed(SEED))
    res = recovered_vs_uninterrupted("fullgraph", cfg_g, new_fg, fg, fgp["val"], fgp["test"])
    for run in res.values():
        want_b4 = 2 * FG["layers"] * fg.num_steps * len(run["calls"])
        check(run["launches"].get("ell_spmm", 0) == want_b4,
              f"fullgraph recovery: ell_spmm launched {run['launches'].get('ell_spmm', 0)} "
              f"times, expected {want_b4}")
    path = WORK / "fullgraph_state.npz"
    st = res["recovered"]["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(str(path), st, meta={"epoch": 2}, schedule_count=True)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_train_state(str(path), st)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(all(states_equal(back, st)) and load_state_meta(str(path))["num_leaves"] == 9,
          "full-graph state: save/load changed a leaf, or the schedule's count is missing")
    numbers.update(fullgraph_uninterrupted_s=res["uninterrupted"]["wall_s"],
                   fullgraph_recovered_s=res["recovered"]["wall_s"],
                   fullgraph_epochs_run=res["recovered"]["calls"],
                   fullgraph_b4_launches=[r["launches"].get("ell_spmm", 0)
                                          for r in res.values()],
                   fullgraph_state_mb=path.stat().st_size / 1e6, fullgraph_save_s=t_save,
                   fullgraph_load_s=t_load)
    log(f"[recovery] full state at the full-graph width ({path.stat().st_size / 1e6:.1f} MB): "
        f"save {t_save:.3f} s, load {t_load:.3f} s")
    del res, st, back

    # (f) the CLI: elastic driver, feasible negatives, fused B1, hybrid_adam
    run_dir = WORK / "cli_run"
    args = ["--device", "cuda", "--dataset", "synthetic",
            "--synthetic-users", str(SMALL["users"]), "--synthetic-items", str(SMALL["items"]),
            "--synthetic-interactions", str(SMALL["interactions"]),
            "--synthetic-communities", str(SMALL["communities"]),
            "--synthetic-power", str(SMALL["power"]),
            "--indexes-dir", str(WORK / "cli_run_indexes"),
            "--checkpoint", str(run_dir / "model.npz"),
            "--histories-dir", str(run_dir / "hist"),
            "--clusters", str(SMALL["clusters"]), "--epochs", "2",
            "train", "--max-retries", "1", "--negatives", "feasible", "--fused-bpr",
            "--optimizer", "hybrid_adam"]
    run_dir.mkdir()
    launches.clear()
    t0 = time.time()
    rc = cli.main(args)
    torch.cuda.synchronize()
    cli_l = dict(launches)
    check(rc == 0, f"cli train --max-retries 1 --negatives feasible exited {rc}")
    rows = MetricsLogger.read(str(run_dir / "hist" / "metrics.jsonl"))
    check([r["step"] for r in rows] == [0, 1]
          and cli_l.get("bpr_tile", 0) == 2 * SMALL["clusters"]
          and load_state_meta(str(run_dir / "recovery_state.npz"))["epoch"] == 1,
          f"cli train --max-retries: metrics rows {[r['step'] for r in rows]}, launches "
          f"{cli_l}, or no recovery checkpoint in the run's directory")
    log(f"[cli] train --max-retries 1 --negatives feasible --fused-bpr --optimizer "
        f"hybrid_adam: rc 0 in {time.time() - t0:.1f} s; {len(rows)} metrics rows; "
        f"launches {cli_l}")
    numbers["phase_s"] = time.time() - t_phase
    log(f"[recovery] {json.dumps(numbers)}")


#: the mesh phase: the sharded step's batch (uniform samples of the train
#: positives) and the steps it is timed over
MESH = dict(batch=2 ** 20, timed_steps=3)


def _grad_probe(out: list):
    """An optimizer that keeps the step's clipped gradient (this rank's
    rows) in ``out`` and leaves the tables as they are: the gradient itself,
    which Adam's first update (``±lr`` wherever ``|g| ≫ eps``) would hide and
    ``p0 - p1`` would round to the tables' ulp."""
    from movie_recommender_system_with_gnns_tpu_torch.training.train import Optimizer

    def update(params, grads, opt_state):
        out[:] = [g.clone() for g in grads]
        return params, opt_state

    return Optimizer(lambda params: None, update)


def _mesh_step(mesh, z, device) -> tuple:
    """One sharded step of ``mesh_phase`` from the tables, batch and
    negatives in ``z``: (loss, the whole clipped gradient, users then
    items)."""
    from movie_recommender_system_with_gnns_tpu_torch.config import Config, ModelConfig
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
        LightGCNParams, params_from_numpy)
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import TripletBatch
    from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as sh
    from movie_recommender_system_with_gnns_tpu_torch.training.train import TrainState

    cfg = Config(model=ModelConfig(num_layers=TRAIN["layers"], dim=FULL["dim"]))
    u, i = z["u"], z["i"]
    plan = sh.ShardPlan.create(u.shape[0], i.shape[0], mesh.mp)
    m = mesh.coords[1]
    coos = sh.shard_coos(sh.shard_graph(z["train_e"], plan), plan, m, device)
    local = sh.shard_params(sh.pad_params(params_from_numpy(u, i, device), plan), plan, m)
    grads = []
    step = sh.make_sharded_train_step(cfg, mesh, plan, opt=_grad_probe(grads))
    batch = TripletBatch(*(torch.from_numpy(z[k]).to(device) for k in ("user", "pos", "mask")))
    _, loss = step(TrainState(local, None, 0), coos, batch, torch.from_numpy(z["neg"]).to(device))
    g = sh.unpad_params(sh.gather_params(LightGCNParams(*grads), mesh), plan)
    return float(loss), torch.cat(list(g)).cpu().numpy()


def _mesh_rank(rank: int, world: int, dp: int, mp: int, port: int, path: str,
               device_type: str = "cuda") -> None:
    """One rank of a multi-card mesh (spawned when the machine has several
    cards; ``device_type="cpu"`` runs it over gloo): :func:`_mesh_step`;
    rank 0 writes the loss and the gradient."""
    from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as pmesh

    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    pmesh.distributed_init(device, init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank, timeout_s=300)
    try:
        with np.load(path) as z:
            loss, grad = _mesh_step(pmesh.make_mesh(dp, mp, device=device), z, device)
        if rank == 0:
            np.savez(path.replace(".npz", f"_{dp}x{mp}.npz"), loss=loss, grad=grad)
    finally:
        torch.distributed.destroy_process_group()


def mesh_batch(train_e: np.ndarray, num_users: int, num_items: int):
    """The mesh phase's step inputs: ``MESH["batch"]`` uniform samples of the
    train positives and one negative each, on the card, from the seed."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import (
        TripletBatch, sample_negative, triplets_from_edges)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    trip = triplets_from_edges(train_e, num_users, device="cuda")
    b = min(MESH["batch"], trip.user.shape[0])
    idx = torch.randint(0, trip.user.shape[0], (b,), generator=gen, device="cuda")
    batch = TripletBatch(trip.user[idx], trip.pos_item[idx],
                         torch.ones(b, dtype=torch.bool, device="cuda"))
    return batch, sample_negative(gen, b, num_items)


def save_mesh_inputs(p0, train_e, batch, neg) -> str:
    """The tables, graph, batch and negatives the spawned ranks read."""
    path = str(WORK / "mesh_inputs.npz")
    np.savez(path, u=p0.user_emb.cpu().numpy(), i=p0.item_emb.cpu().numpy(),
             train_e=train_e, user=batch.user.cpu().numpy(),
             pos=batch.pos_item.cpu().numpy(), mask=batch.mask.cpu().numpy(),
             neg=neg.cpu().numpy())
    return path


def mesh_cards_only(t_start: float, smi: str) -> int:
    """``--mesh-only``: what exists only across cards and what it is held
    against, and nothing else. The full graph and the mesh phase's step
    inputs, then :func:`mesh_cards` over every mesh the cards allow (2×1,
    1×2; with four, also 2×2, 4×1, 1×4) against the 1×1 mesh."""
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import init_params
    from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as pmesh

    n = torch.cuda.device_count()
    check(n >= 2, f"--mesh-only needs two or more cards, found {n}")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        data = make_synthetic_movielens(
            FULL["users"], FULL["items"], FULL["interactions"], seed=SEED,
            power=FULL["power"], num_communities=FULL["communities"])
        train_e, _, _ = split_edges(data, str(WORK / "indexes"), seed=SEED)
        batch, neg = mesh_batch(train_e, data.num_users, data.num_items)
        p0 = init_params(data.num_users, data.num_items, FULL["dim"],
                         generator=torch.Generator().manual_seed(SEED + 6), device="cuda")
        path = save_mesh_inputs(p0, train_e, batch, neg)
        pmesh.distributed_init("cuda")
        shapes = [(2, 1), (1, 2)] + ([(2, 2), (4, 1), (1, 4)] if n >= 4 else [])
        done = mesh_cards(pmesh.make_mesh(1, 1, device="cuda"), path, shapes)
        torch.distributed.destroy_process_group()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"[mesh] --mesh-only, {smi}: shapes {['1x1'] + done} in {time.time() - t_start:.1f} s")
    return 0


def mesh_cards(mesh, path: str, shapes, device_type: str = "cuda") -> list:
    """Each of ``shapes`` (dp, mp) spawned over dp·mp ranks, one card each,
    against the 1×1 mesh's step in this process: loss within rtol 2e-5, the
    clipped gradient within 1e-5 of its largest entry. Returns the shapes
    run."""
    import torch.multiprocessing as mp

    with np.load(path) as z:
        ref_loss, ref = _mesh_step(mesh, z, mesh.device)
    top = float(np.abs(ref).max())
    done = []
    for dp_, mp_ in shapes:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        mp.start_processes(_mesh_rank, args=(dp_ * mp_, dp_, mp_, port, path, device_type),
                           nprocs=dp_ * mp_, start_method="spawn", join=True)
        with np.load(path.replace(".npz", f"_{dp_}x{mp_}.npz")) as z:
            loss, err = float(z["loss"]), float(np.abs(z["grad"] - ref).max())
        check(abs(loss - ref_loss) <= 2e-5 * abs(ref_loss) and err <= 1e-5 * top,
              f"mesh {dp_}x{mp_}: loss {loss!r} vs 1x1 {ref_loss!r}, clipped gradient "
              f"{err:.3e} from 1x1's (largest entry {top:.3e})")
        log(f"[mesh] {dp_}x{mp_} on {dp_ * mp_} cards: loss {loss:.8f} (1x1 {ref_loss:.8f}), "
            f"clipped gradient within {err:.3e} of 1x1's (largest entry {top:.3e})")
        done.append(f"{dp_}x{mp_}")
    return done


def mesh_phase(data, train_e, val_e, test_e, cfg, cc, val, test, smi: str) -> dict:
    """Phase 5e: the multi-device slice at full width on a one-rank NCCL group
    (mesh 1×1; a one-card machine gives one rank, and NCCL refuses two ranks
    on one card); with two or more cards also 2×1 and 1×2 meshes, one card a
    rank, each step's clipped gradient against the 1×1 mesh's
    (:func:`mesh_cards`).
    (a) one sharded step (batch ``MESH["batch"]`` of the train positives,
    L = 3, d = 64) against the single-device full-node step through
    ``spmm_rows`` and through ``spmm_segment`` (the plain ``index_add``)
    from the same tables and negatives: loss rtol 2e-5, tables rtol 2e-4 /
    atol 1e-6, and Adam's first moments, ``(1 - b1)`` times the clipped
    gradient, of the sharded and the ``spmm_rows`` step within 1e-5 of the
    plain step's largest entry; ``sorted_index_add`` at the train graph's
    row runs (the propagation's sums and its gather's backward) bit-equal
    to its plain version on the host; the sharded step bit-equal over two
    runs, timed over ``MESH["timed_steps"]`` steps with its launches, NCCL
    calls and peak memory, beside the full-node step through either sum;
    (b) fault C5: two full-node steps bit-equal; (c)
    ``make_compact_sharded_epoch_fn`` with the fused BPR kernel over the
    compact clusters, one epoch against the single-device compact epoch
    from the same order and negatives (``torch.equal``, accepting 1e-6),
    B1 counted; (d) on phase 5's trained checkpoint, the mesh's propagated
    tables against the single-device ones (ELL kernel; 1e-5 of the largest
    entry), and its full-ranking eval,
    layer-0 and propagated, against the single-device eval of the same
    tables (for the propagated one, the mesh's own) within 1e-6; (e) ``cli
    train --mesh 1x1 --full-eval`` at the small size, its recall equal to
    the unsharded eval of its checkpoint. One ``[mesh]`` JSON line."""
    import torch.distributed as dist

    from movie_recommender_system_with_gnns_tpu_torch import cli
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import COOGraph
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
        LightGCNParams, init_params)
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_scatter
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceCOO, spmm_segment
    from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as pmesh
    from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as sh
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
        compute_serving_tables)
    from movie_recommender_system_with_gnns_tpu_torch.training import compact
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import load_params
    from movie_recommender_system_with_gnns_tpu_torch.training.compact_sharded import (
        make_compact_sharded_epoch_fn)
    from movie_recommender_system_with_gnns_tpu_torch.training.evaluate import (
        evaluate_full_ranking)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        TrainState, make_adam, make_optimizer, make_train_step)
    from movie_recommender_system_with_gnns_tpu_torch.utils.observability import MetricsLogger

    t_phase = time.time()
    nu, ni = data.num_users, data.num_items
    L, d = TRAIN["layers"], FULL["dim"]
    numbers = dict(card=smi)
    # the earlier phases' cached blocks would leave NCCL no device memory for
    # its communicators' buffers
    torch.cuda.empty_cache()
    pmesh.distributed_init("cuda")
    mesh = pmesh.make_mesh(1, 1, device="cuda")
    shapes = ["1x1"]
    log(f"[mesh] one-rank NCCL group: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}, {torch.cuda.device_count()} card(s)")

    # (a) the sharded step against the single-device full-node step
    t0 = time.time()
    plan = sh.ShardPlan.create(nu, ni, 1)
    coos = sh.shard_coos(sh.shard_graph(train_e, plan), plan, 0, "cuda")
    t_shard = time.time() - t0
    t0 = time.time()
    g = COOGraph.build(train_e, nu + ni)
    coo = DeviceCOO.from_host(g, "cuda", row_runs=True)
    torch.cuda.synchronize()
    t_coo = time.time() - t0
    check(torch.equal(coos[0].src[:g.num_edges].long(), coo.src[:g.num_edges].long())
          and torch.equal(coos[0].dst[:g.num_edges].long(), coo.dst[:g.num_edges].long()),
          "the 1x1 shard does not hold the full-node graph's edges in its order")
    batch, neg = mesh_batch(train_e, nu, ni)
    b = batch.user.shape[0]
    cfg_m = cfg.replace(train=dataclasses.replace(cfg.train, fused_bpr=False))
    adam = make_adam(cfg_m, lr_of=lambda t: cfg_m.train.lr)
    p0 = init_params(nu, ni, d, generator=torch.Generator().manual_seed(SEED + 6),
                     device="cuda")
    copy = lambda p: LightGCNParams(p.user_emb.clone(), p.item_emb.clone())
    step = sh.make_sharded_train_step(cfg_m, mesh, plan, opt=adam)

    def sharded():
        local = sh.shard_params(sh.pad_params(copy(p0), plan), plan, 0)
        return step(TrainState(local, adam.init(local), 0), coos, batch, neg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    calls0 = dict(pmesh.COLLECTIVES)
    t0 = time.perf_counter()
    st_a, loss_a = sharded()
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    step_launches = dict(launches)
    step_calls = {k: v - calls0.get(k, 0) for k, v in pmesh.COLLECTIVES.items()}
    peak = torch.cuda.max_memory_allocated()
    st_b, loss_b = sharded()
    same = [torch.equal(x, y) for x, y in zip(
        st_a.params + st_a.opt_state.mu + st_a.opt_state.nu + (loss_a,),
        st_b.params + st_b.opt_state.mu + st_b.opt_state.nu + (loss_b,))]
    check(all(same), f"the sharded step is not bit-equal over two runs: {same}")
    check(step_launches.get("sorted_index_add", 0) == 2 * L + 4,
          f"the sharded step launched sorted_index_add {step_launches} times, "
          f"expected {2 * L + 4} (a sum and a gather's backward per hop, four "
          "triplet gathers' backward)")
    del st_b
    fn_step = make_train_step(cfg_m)
    opt = make_optimizer(cfg_m)

    def single():
        p = copy(p0)
        return fn_step(TrainState(p, opt.init(p), 0), coo, batch, None, neg=neg)

    launches.clear()
    st_s, loss_s = single()
    single_launches = dict(launches)
    st_s2, loss_s2 = single()
    same_s = [torch.equal(x, y) for x, y in zip(
        st_s.params + st_s.opt_state.mu + st_s.opt_state.nu + (loss_s,),
        st_s2.params + st_s2.opt_state.mu + st_s2.opt_state.nu + (loss_s2,))]
    check(all(same_s), f"(b) C5: two full-node steps differ: {same_s}")
    del st_s2
    full_a = sh.unpad_params(sh.gather_params(st_a.params, mesh), plan)
    la, ls = loss_a.item(), loss_s.item()
    errs = [((x - y).abs() - (2e-4 * y.abs() + 1e-6)).max().item()
            for x, y in zip(full_a, st_s.params)]
    check(abs(la - ls) <= 2e-5 * abs(ls) and max(errs) <= 0,
          f"(a) sharded step vs full-node step: loss {la!r} vs {ls!r}, tables beyond "
          f"rtol 2e-4 / atol 1e-6 by {errs}")
    diff = max((x - y).abs().max().item() for x, y in zip(full_a, st_s.params))
    # the clipped gradients, as Adam's first moments (1 - b1)·g after one
    # update from zero, against the full-node step through the plain index_add
    fn_plain = make_train_step(cfg_m, spmm=spmm_segment)

    def plain():
        p = copy(p0)
        return fn_plain(TrainState(p, opt.init(p), 0), coo, batch, None, neg=neg)

    st_p, loss_p = plain()
    mu_ref = torch.cat(list(st_p.opt_state.mu))
    mu_top = mu_ref.abs().max().item()
    mu_a = sh.unpad_params(sh.gather_params(st_a.opt_state.mu, mesh), plan)
    mu_err = {name: (torch.cat(list(m)) - mu_ref).abs().max().item()
              for name, m in (("sharded", mu_a), ("full_node", st_s.opt_state.mu))}
    lp = loss_p.item()
    check(max(mu_err.values()) <= 1e-5 * mu_top and abs(la - lp) <= 2e-5 * abs(lp),
          f"(a) first moments (1 - b1)·clipped gradient vs the full-node step through "
          f"spmm_segment: {mu_err} (largest entry {mu_top:.3e}); loss {la!r} vs {lp!r}")
    del full_a, st_s, st_p, mu_a, mu_ref
    # sorted_index_add at the train graph's row runs: the propagation's sums
    # over dst and its gather's backward over src, against the plain version
    cot = torch.randn(coo.src.shape[0], d, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(SEED + 9))
    runs_checked = {}
    for label, order, starts, rows_ in (
            ("row sums", coo.order, coo.starts, coo.num_nodes),
            ("gather backward", coo.src_order, coo.src_starts, coo.num_src)):
        out_k = cuda_scatter.sorted_index_add(cot, order, starts, rows_)
        again = cuda_scatter.sorted_index_add(cot, order, starts, rows_)
        torch.cuda.synchronize()
        host = cuda_scatter.sorted_index_add_plain(cot.cpu(), order.cpu(), starts.cpu(),
                                                   rows_)
        run = int((starts[1:] - starts[:-1]).max())
        what = (f"(a) sorted_index_add, {label} of the train graph ({cot.shape[0]} "
                f"entries over {rows_} rows, longest run {run}, d={d}, f32)")
        check(torch.equal(out_k, again), f"{what}: two calls differ")
        check(torch.equal(out_k.cpu(), host), f"{what}: differs from the plain version's "
              "sequential sum on the host")
        runs_checked[label] = dict(entries=int(cot.shape[0]), rows=rows_, longest_run=run)
    del cot, out_k, again, host
    log(f"[mesh] (a) sharded step 1x1 (batch {b}, L={L}, d={d}) vs the full-node step "
        f"(spmm_rows): loss {la:.8f} vs {ls:.8f}, max table diff {diff:.3e}; first "
        f"moments (1 - b1)·clipped gradient vs the full-node step through spmm_segment "
        f"(loss {lp:.8f}): sharded {mu_err['sharded']:.3e}, full-node "
        f"{mu_err['full_node']:.3e} (largest entry {mu_top:.3e}); sorted_index_add at "
        f"the train graph's runs {runs_checked} bit-equal to the plain version on the "
        f"host and over two calls; the sharded step bit-equal over two runs; "
        f"sorted_index_add {step_launches.get('sorted_index_add', 0)} launches a step "
        f"({single_launches.get('sorted_index_add', 0)} in the full-node step); "
        f"collectives a step {step_calls}; first step {first_ms:.1f} ms; (b) two "
        f"full-node steps bit-equal (C5)")
    local = sh.shard_params(sh.pad_params(copy(p0), plan), plan, 0)
    st = TrainState(local, adam.init(local), 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH["timed_steps"]):
        st, _ = step(st, coos, batch, neg)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / MESH["timed_steps"]
    p = copy(p0)
    st1 = TrainState(p, opt.init(p), 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH["timed_steps"]):
        st1, _ = fn_step(st1, coo, batch, None, neg=neg)
    torch.cuda.synchronize()
    single_ms = 1e3 * (time.perf_counter() - t0) / MESH["timed_steps"]
    p = copy(p0)
    st2 = TrainState(p, opt.init(p), 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH["timed_steps"]):
        st2, _ = fn_plain(st2, coo, batch, None, neg=neg)
    torch.cuda.synchronize()
    segment_ms = 1e3 * (time.perf_counter() - t0) / MESH["timed_steps"]
    del st2
    prof = profile_window("sharded step (1x1)", 2, 8,
                          lambda: step(st, coos, batch, neg))
    numbers.update(step=dict(batch=b, loss=la, single_loss=ls, max_table_diff=diff,
                             plain_loss=lp, mu_err=mu_err, mu_largest=mu_top,
                             row_runs_checked=runs_checked, ms=step_ms,
                             single_device_ms=single_ms,
                             single_device_spmm_segment_ms=segment_ms, first_ms=first_ms,
                             launches=step_launches, collectives=step_calls,
                             peak_gb=peak / 1e9, busy_ms=prof["busy_ms"],
                             idle_share=prof["idle_share"], shard_s=t_shard,
                             full_node_graph_s=t_coo))
    log(f"[mesh] (a) sharded step {step_ms:.2f} ms, full-node step {single_ms:.2f} ms "
        f"through spmm_rows, {segment_ms:.2f} ms through spmm_segment (mean of "
        f"{MESH['timed_steps']}), peak device memory {peak / 1e9:.2f} GB")
    del st, st1, st_a, coo

    # with several cards: 2x1 and 1x2 meshes, one card a rank, against 1x1
    if torch.cuda.device_count() >= 2:
        shapes += mesh_cards(mesh, save_mesh_inputs(p0, train_e, batch, neg),
                             ((2, 1), (1, 2)))
    log(f"[mesh] mesh shapes run: {shapes}")
    numbers["shapes"] = shapes
    del batch, neg, coos

    # (c) the data-parallel compact epoch with B1 against the single-device one
    cfg_c = cfg.replace(train=dataclasses.replace(cfg.train, fused_bpr=True))
    k = cc.num_clusters
    gen_c = torch.Generator(device="cuda").manual_seed(SEED + 7)
    perm = torch.randperm(k, generator=gen_c, device="cuda").tolist()
    negs = torch.stack([compact._step_negatives(cfg_c, gen_c, cc, c, ni) for c in perm])
    opt_c = make_optimizer(cfg_c)
    p0c = init_params(nu, ni, d, generator=torch.Generator().manual_seed(SEED + 8),
                      device="cuda")
    fresh = lambda: TrainState(copy(p0c), opt_c.init(copy(p0c)), 0)
    epoch_sh = make_compact_sharded_epoch_fn(cfg_c, mesh)(cc)
    launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, la_c = epoch_sh(fresh(), cc, None, perm=perm, neg=negs)
    torch.cuda.synchronize()
    sh_epoch_s = time.perf_counter() - t0
    compact_launches = dict(launches)
    t0 = time.perf_counter()
    b_, lb_c = compact.make_compact_epoch_fn(cfg_c)(fresh(), cc, None, perm=perm, neg=negs)
    torch.cuda.synchronize()
    single_epoch_s = time.perf_counter() - t0
    pairs = list(zip(a.params + a.opt_state.mu + a.opt_state.nu,
                     b_.params + b_.opt_state.mu + b_.opt_state.nu))
    equal = all(torch.equal(x, y) for x, y in pairs) and la_c == lb_c
    worst = max((x - y).abs().max().item() for x, y in pairs)
    check(worst <= 1e-6 and abs(la_c - lb_c) <= 1e-6,
          f"(c) compact superstep 1x1 vs the single-device step: max diff {worst:.3e}, "
          f"loss {la_c!r} vs {lb_c!r}")
    check(compact_launches.get("bpr_tile", 0) == k,
          f"(c) bpr_tile launched {compact_launches.get('bpr_tile', 0)} times for {k} "
          "supersteps")
    numbers.update(compact=dict(supersteps=k, bit_equal=equal, max_diff=worst,
                                launches=compact_launches, epoch_s=sh_epoch_s,
                                single_device_epoch_s=single_epoch_s, loss=la_c))
    log(f"[mesh] (c) compact epoch 1x1 with B1 ({k} supersteps, one cluster each) vs "
        f"the single-device epoch: bit-equal {equal} (max diff {worst:.3e}); launches "
        f"{compact_launches}; {sh_epoch_s:.3f} s vs {single_epoch_s:.3f} s")
    del a, b_, negs, p0c

    # (d) mesh propagation and eval against the single-device ones, on the
    # trained checkpoint of phase 5 (untrained tables hit almost nothing)
    trained, _ = load_params(cfg.train.checkpoint_path, "cuda")
    t_mesh = compute_serving_tables(trained, train_e, cfg_c, mode="propagated", mesh=mesh)
    t_one = compute_serving_tables(trained, train_e, cfg_c, mode="propagated")
    tab_err = max(rel_max(x, y) for x, y in zip(t_mesh, t_one))
    check(tab_err <= 1e-5, f"(d) mesh propagated tables vs single-device: {tab_err:.3e} "
          "of the largest entry")
    evals = {}
    kw = dict(k=TOP_K, max_users=EVAL["max_users"], cfg=cfg_c)
    for prop in (False, True):
        r_m = evaluate_full_ranking(trained, train_e, test_e, nu, mesh=mesh,
                                    use_propagated=prop, **kw)
        sharded_flag = evaluate_full_ranking.last_timings["sharded"]
        # the single-device eval of the same tables: the mesh's own propagation
        r_1 = evaluate_full_ranking(t_mesh if prop else trained, train_e, test_e, nu, **kw)
        check(sharded_flag and max(abs(x - y) for x, y in zip(r_m, r_1)) <= 1e-6,
              f"(d) mesh eval (propagated={prop}) {r_m} vs single-device {r_1}")
        evals["propagated" if prop else "layer0"] = dict(mesh=r_m, single=r_1)
    # recorded beside them: the single-device eval through its own (ELL) tables
    evals["propagated"]["single_ell"] = evaluate_full_ranking(
        trained, train_e, test_e, nu, use_propagated=True, **kw)
    numbers.update(tables_rel_err=tab_err, eval=evals)
    log(f"[mesh] (d) propagated tables 1x1 vs single-device (ELL kernel): {tab_err:.3e} "
        f"of the largest entry; full-ranking eval (recall, ndcg) of the trained "
        f"checkpoint, mesh vs single-device on the same tables: {evals}")
    del t_mesh, t_one, trained

    # (e) cli train --mesh 1x1 --full-eval at the small size
    hist_dir = WORK / "mesh_hist"
    ckpt = WORK / "mesh_model.npz"
    shutil.rmtree(hist_dir, ignore_errors=True)
    ckpt.unlink(missing_ok=True)
    args = ["--device", "cuda", "--dataset", "synthetic",
            "--synthetic-users", str(SMALL["users"]), "--synthetic-items", str(SMALL["items"]),
            "--synthetic-interactions", str(SMALL["interactions"]),
            "--synthetic-communities", str(SMALL["communities"]),
            "--synthetic-power", str(SMALL["power"]),
            "--indexes-dir", str(WORK / "mesh_indexes"), "--checkpoint", str(ckpt),
            "--histories-dir", str(hist_dir), "--epochs", "1",
            "train", "--mesh", "1x1", "--full-eval", "--full-eval-users", "2000"]
    launches.clear()
    t0 = time.time()
    rc = cli.main(args)
    t_cli = time.time() - t0
    check(rc == 0, f"(e) cli train --mesh 1x1 exited {rc}")
    rows = MetricsLogger.read(str(hist_dir / "metrics.jsonl"))
    check([r["step"] for r in rows] == [0, 1] and rows[1].get("sharded") is True,
          f"(e) cli train --mesh 1x1 metrics rows: {rows}")
    small = make_synthetic_movielens(      # the graph the CLI generated
        SMALL["users"], SMALL["items"], SMALL["interactions"], seed=SEED,
        power=SMALL["power"], num_communities=SMALL["communities"])
    tr_s, _, te_s = split_edges(small, str(WORK / "mesh_indexes"), seed=SEED)
    params_s, meta = load_params(str(ckpt), "cuda")
    r_ref = evaluate_full_ranking(params_s, tr_s, te_s, small.num_users, k=TOP_K,
                                  max_users=2000)
    check(abs(rows[1]["test_full_recall"] - r_ref[0]) <= 1e-6
          and abs(rows[1]["test_full_ndcg"] - r_ref[1]) <= 1e-6,
          f"(e) cli --mesh 1x1 recall {rows[1]['test_full_recall']} vs the unsharded "
          f"eval of its checkpoint {r_ref}")
    numbers.update(cli=dict(s=t_cli, recall=rows[1]["test_full_recall"],
                            unsharded_recall=r_ref[0], launches=dict(launches)))
    log(f"[mesh] (e) cli train --mesh 1x1 --full-eval: rc 0 in {t_cli:.1f} s, recall "
        f"{rows[1]['test_full_recall']:.6f} = the unsharded eval of its checkpoint "
        f"{r_ref[0]:.6f}; launches {dict(launches)}")
    dist.destroy_process_group()
    numbers["phase_s"] = time.time() - t_phase
    log(f"[mesh] {json.dumps(numbers)}")
    return numbers


def lazy_phase(cfg, cc, cc_seg, main_path: str, c_id: int, neg, data, val, test,
               hist_adam: dict, copy, steps: int, scatters: int):
    """Phase 5a: the lazy-row optimizers at full width. ``hybrid_adam`` (the
    JAX package's headline optimizer) through ``train_model`` for 2 epochs
    from the Adam run's initial tables and epoch generators, with its launch
    counts and best-val checkpoint; one step of each of ``lazy_adam``,
    ``hybrid_adam`` and ``lazy_item_adam`` run twice from the same state,
    bit-equal on the main path and the segment path; from fresh moments,
    hybrid's item table against Adam's and lazy-item's tables against
    hybrid's after one step; each optimizer's update with host syncs made
    errors. Returns the hybrid run's state and histories."""
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.training import compact
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import save_params
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        TrainState, create_train_state, loss_and_grads, make_optimizer, train_model)

    cfg_of = lambda opt, **kw: cfg.replace(
        train=dataclasses.replace(cfg.train, optimizer=opt, **kw))
    cfg_h = cfg_of("hybrid_adam", checkpoint_path=str(WORK / "best_hybrid.npz"))
    saved = []

    def save_cb(st, recall):
        saved.append(recall)
        save_params(cfg_h.train.checkpoint_path, st.params, meta={"val_recall": recall})

    # the Adam run's initial tables: the same seed through the same
    # initializer; train_model swaps fresh lazy moments in for Adam's
    state = create_train_state(cfg_h, data.num_users, data.num_items,
                               generator=torch.Generator().manual_seed(SEED),
                               device="cuda")
    launches.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, hist = train_model(cfg_h, state, cc, val, test, save_checkpoint=save_cb)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    got = dict(launches)
    log(f"[lazy] hybrid_adam train_model {TRAIN['epochs']} epochs + test eval: "
        f"{t_train:.2f} s; epoch times with the val eval "
        f"{[round(t, 3) for t in hist['epoch_time_s']]} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[lazy] kernel launches on the hybrid_adam training path: {got}")
    check(isinstance(state.opt_state, compact.LazyAdamState),
          "train_model did not give hybrid_adam a lazy state")
    check(got.get("bpr_tile", 0) == steps,
          f"hybrid_adam: bpr_tile launched {got.get('bpr_tile', 0)} times, expected {steps}")
    # per step: the dense item gradient's negative rows; on the segment path
    # also each hop's message sum and its gather's backward; the evals' hops
    check(got.get("sorted_index_add", 0) == scatters,
          f"hybrid_adam: sorted_index_add launched {got.get('sorted_index_add', 0)} "
          f"times, expected {scatters}")
    check(all(np.isfinite(v) for key in hist for v in hist[key]),
          f"hybrid_adam: a loss or metric is not finite: {hist}")
    check(hist["train_loss"][1] < hist["train_loss"][0],
          f"hybrid_adam: train loss did not fall: {hist['train_loss']}")
    check(state.step == steps and state.opt_state.count == steps,
          f"hybrid_adam: step {state.step}, count {state.opt_state.count} != {steps}")
    check(bool(saved) and Path(cfg_h.train.checkpoint_path).exists(),
          "hybrid_adam: no best-val checkpoint was written")
    log(f"[lazy] hybrid_adam train loss {hist['train_loss']}, val loss "
        f"{hist['val_loss']}, val recall {hist['val_recall']} (adam "
        f"{hist_adam['val_recall']}), test recall {hist['test_recall']} (adam "
        f"{hist_adam['test_recall']})")

    # one step of each twice from the same state, order and negatives
    for opt in compact.LAZY_OPTIMIZERS:
        fn = compact.make_compact_epoch_fn(cfg_of(opt))
        for path, cc_p in ((main_path, cc), ("segment", cc_seg)):
            runs = [fn(copy(state), cc_p, None, perm=[c_id], neg=neg[None])[0]
                    for _ in range(2)]
            torch.cuda.synchronize()
            a, b = runs
            same = [torch.equal(x, y) for x, y in zip(
                a.params + a.opt_state.mu + a.opt_state.nu,
                b.params + b.opt_state.mu + b.opt_state.nu)]
            check(all(same), f"{opt}: cluster {c_id}'s step on the {path} path is not "
                  f"bit-equal over two runs (params and moments equal: {same})")
            check(not torch.equal(a.params.item_emb, state.params.item_emb)
                  and not torch.equal(a.params.user_emb, state.params.user_emb),
                  f"{opt}: the {path} step left a table unchanged")
            log(f"[lazy] {opt}: cluster {c_id}, one step run twice on the {path} "
                f"path: parameters and both moment tables bit-equal")
            del runs, a, b

    # from fresh moments, the same cluster and negatives: one step each
    fresh = {}
    for opt in ("adam", "hybrid_adam", "lazy_item_adam"):
        p = type(state.params)(*(t.clone() for t in state.params))
        ost = (make_optimizer(cfg).init(p) if opt == "adam" else compact.init_lazy_adam(p))
        fresh[opt] = compact.make_compact_epoch_fn(cfg_of(opt))(
            TrainState(p, ost, 0), cc, None, perm=[c_id], neg=neg[None])[0].params
    a_item, h = fresh["adam"].item_emb, fresh["hybrid_adam"]
    err = (h.item_emb - a_item).abs().max().item()
    top = a_item.abs().max().item()
    check(err <= 1e-6 * top, f"hybrid's item table after one step is {err:.3e} from "
          f"Adam's (largest entry {top:.3e})")
    errs = []
    for name, x, y in zip(("user", "item"), fresh["lazy_item_adam"], h):
        errs.append((x - y).abs().max().item())
        check(torch.allclose(x, y, rtol=1e-6, atol=1e-7),
              f"lazy_item_adam's {name} table after one step is not hybrid's within "
              f"rtol 1e-6 / atol 1e-7 (max |diff| {errs[-1]:.3e})")
    log(f"[lazy] one step from fresh moments, cluster {c_id}: hybrid's item table "
        f"{err:.3e} from Adam's (largest entry {top:.3e}); lazy_item_adam's user / "
        f"item tables {errs[0]:.3e} / {errs[1]:.3e} from hybrid's")
    del fresh, a_item, h

    # host syncs: each optimizer's update must make none; the gradient code's
    # first, if any, is logged with the Python frames that reached it
    st = copy(state)
    rg = compact.compact_row_grads(st.params, cc, c_id, neg, cfg_h)
    p = type(state.params)(*(t.clone() for t in state.params))
    adam_grads = lambda: loss_and_grads(
        compact.compact_cluster_loss, p, cc.cluster(c_id), neg, cfg, cc.u_pad,
        cc.i_pad, None if cc.adj is None else cc.adj[c_id], cc.lists(c_id))
    opt_a = make_optimizer(cfg)
    g_adam = adam_grads()[1]
    for what, fn in (
            ("the row gradients of one step",
             lambda: compact.compact_row_grads(st.params, cc, c_id, neg, cfg_h)),
            ("adam's gradients of one step", adam_grads),
            ("adam's clip + update", lambda: opt_a.update(p, g_adam, opt_a.init(p)))):
        log(f"[lazy] {what}: first host sync {sync_site(fn) or 'none'}")
    for opt in compact.LAZY_OPTIMIZERS:
        st = copy(state)
        update = compact.make_row_update(cfg_of(opt))
        site = sync_site(lambda: update(st.params, st.opt_state, cc, c_id, rg))
        check(site is None, f"{opt}: the update synchronised with the host at {site}")
        log(f"[lazy] {opt}: the update ran with host syncs made errors: none")
    del st, rg, p, g_adam
    return state, hist


def sync_site(fn):
    """Run ``fn`` with host syncs made errors: None when it makes none, else
    the last Python frames (file:line function) that reached the first."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return None
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return " <- ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in
                           reversed(traceback.extract_tb(e.__traceback__)[-5:]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from movie_recommender_system_with_gnns_tpu_torch import cli
    from movie_recommender_system_with_gnns_tpu_torch.config import (
        Config, ModelConfig, TrainConfig)
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
        edge_retention, partition_bipartite_greedy)
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import init_params
    from movie_recommender_system_with_gnns_tpu_torch.ops import (
        _build, bpr, cuda_bpr, cuda_mips, cuda_scatter)
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_scatter import sort_rows
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import sample_negative
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
        _MASK_TILE, ServingIndex)
    from movie_recommender_system_with_gnns_tpu_torch.training import compact
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_params, save_params)
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
        densify_if_fits)
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import spmm_rows, spmm_segment
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        TrainState, build_eval_batch, create_train_state, epoch_generator,
        loss_and_grads, make_eval_step, make_optimizer, train_model)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    launches = _build.LAUNCHES

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[card] torch: {name}, count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    bw, bf16_flops = peaks_for(smi)

    # 2. build
    t0 = time.time()
    built = _build.build(*KERNEL_ROWS, "graphcore")
    for kname, path in built.items():
        log(f"[build] {kname}: {path.name} in {time.time() - t0:.1f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")
            elif "Compiling entry function" in line:
                log(f"[build]   {line.strip()[:120]}")

    if "--mesh-only" in sys.argv[1:]:
        return mesh_cards_only(t_start, smi)

    # 3. kernels against their plain versions
    kernel_err = kernel_phase()
    bpr_err = bpr_kernel_phase(bw)
    scatter_err = scatter_kernel_phase()
    ell_err = ell_kernel_phase()
    block_err = mips_block_phase()
    if "--kernels-only" in sys.argv[1:]:
        log(f"[done] kernels only: {time.time() - t_start:.1f} s")
        return 0

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        # 4. the serving path at ML-25M width
        t0 = time.time()
        data = make_synthetic_movielens(
            FULL["users"], FULL["items"], FULL["interactions"], seed=SEED,
            power=FULL["power"], num_communities=FULL["communities"])
        train_e, val_e, test_e = split_edges(data, str(WORK / "indexes"), seed=SEED)
        log(f"[path] graph {data.num_users} users x {data.num_items} items, "
            f"{data.edge_index.shape[1]} directed edges, train {train_e.shape[1]}: "
            f"{time.time() - t0:.1f} s")
        check(data.num_users == FULL["users"] and data.num_items == FULL["items"],
              "synthetic graph lost users or items")
        num_nodes = data.num_users + data.num_items
        gen = torch.Generator().manual_seed(SEED)
        params0 = init_params(data.num_users, data.num_items, FULL["dim"],
                              generator=gen, device="cuda")
        ckpt = WORK / "model.npz"
        save_params(str(ckpt), params0, meta={"seed": SEED})
        params, meta = load_params(str(ckpt), device="cuda")
        check(torch.equal(params.user_emb, params0.user_emb)
              and torch.equal(params.item_emb, params0.item_emb)
              and meta == {"seed": SEED}, "checkpoint round trip changed the tables")

        launches.clear()
        t0 = time.time()
        index = ServingIndex.build(params, train_e, data.num_users)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        log(f"[path] ServingIndex mask {tuple(index.mask.shape)} uint8 "
            f"({index.mask.numel() / 1e9:.3f} GB) in {t_build:.2f} s")
        perm = np.random.default_rng(SEED).permutation(data.num_users)
        times, outs = [], []
        for b in range(DISPATCHES + 1):
            users = np.take(perm, np.arange(b * DISPATCH, (b + 1) * DISPATCH), mode="wrap")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, i = index.batch_recommend(users, top_k=TOP_K)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outs.append((users, s, i))
        serve_launches = dict(launches)
        steady = sorted(times[1:])
        ms = 1e3 * steady[len(steady) // 2]
        log(f"[path] batch_recommend {DISPATCH} users, top-{TOP_K}, masked: "
            f"{ms:.3f} ms per dispatch (median of {len(steady)}; all "
            f"{[round(1e3 * t, 3) for t in times]} ms), "
            f"{DISPATCH / ms * 1e3:.0f} queries/s")
        log(f"[path] kernel launches on the serving path: {serve_launches}")
        check(serve_launches.get("score_chunkmax", 0) == DISPATCHES + 1,
              f"score_chunkmax launched {serve_launches.get('score_chunkmax', 0)} times "
              f"for {DISPATCHES + 1} dispatches, not once each")

        # outputs: shape, finite, sorted, valid, not train-seen, plain agreement
        for users, s, i in outs:
            check_served(index, users, s, i, data.num_items)
        users, s, i = outs[1]
        sub = torch.as_tensor(users[:1024])
        s_r, i_r = cuda_mips.mips_topk_fused(
            params.user_emb.cpu()[sub], params.item_emb.cpu(), k=TOP_K + 1,
            n_tile=_MASK_TILE, exclude_mask_packed=index.mask.cpu()[sub])
        swaps = check_topk(s[:1024].cpu(), i[:1024].cpu(), s_r, i_r,
                           torch.bfloat16, FULL["dim"], "main path vs plain")
        log(f"[path] 1024 served users agree with the plain version "
            f"({swaps} rows with near-tie swaps)")
        del outs, s_r, i_r

        # where a dispatch's device time goes (profiler over 3 dispatches)
        profile_window("dispatch", 3, 8,
                       lambda: index.batch_recommend(users, top_k=TOP_K))

        # 7a. score_chunkmax at the serving shape: time, plain, library, bound
        q = bpr.normalize_embedding(params.user_emb[torch.as_tensor(users, device="cuda")])
        c = bpr.normalize_embedding(params.item_emb)
        np_ = -(-data.num_items // _MASK_TILE) * _MASK_TILE
        qb = q.to(torch.bfloat16).contiguous()
        cb = torch.nn.functional.pad(c.to(torch.bfloat16), (0, 0, 0, np_ - data.num_items)).contiguous()
        mp = index.mask[torch.as_tensor(users, device="cuda")].contiguous()
        n = data.num_items
        s_k, cm_k = cuda_mips.score_chunkmax(qb, cb, n, mask_packed=mp, n_tile=_MASK_TILE)
        s_p, cm_p = cuda_mips.score_chunkmax_plain(qb, cb, n, mask_packed=mp, n_tile=_MASK_TILE)
        a, b = s_k.float(), s_p.float()
        err = (a - b).abs()
        check(bool((err <= score_tol(a, b, torch.bfloat16, FULL["dim"])).all()),
              "serving shape: kernel scores beyond one ulp of the plain version")
        check(torch.equal(cm_k, s_k.view(DISPATCH, -1, 128).amax(-1)),
              "serving shape: chunk max is not the max of the stored tile")
        main_err = err.max().item()
        del s_k, cm_k, s_p, cm_p, a, b, err
        k_ms = time_ms(lambda: cuda_mips.score_chunkmax(qb, cb, n, mask_packed=mp,
                                                        n_tile=_MASK_TILE), 20)
        p_ms = time_ms(lambda: cuda_mips.score_chunkmax_plain(
            qb, cb, n, mask_packed=mp, n_tile=_MASK_TILE), 3, warmup=1)
        lib_ms = time_ms(lambda: torch.matmul(qb, cb.T), 20)
        d = FULL["dim"]
        byts = (qb.numel() + cb.numel()) * 2 + mp.numel() + DISPATCH * np_ * 2 \
            + DISPATCH * (np_ // 128) * 2
        flops = 2.0 * DISPATCH * np_ * d
        t_bytes, t_ops = byts / bw * 1e3, flops / bf16_flops * 1e3
        bound = max(t_bytes, t_ops)
        log(f"[kernel] score_chunkmax at ({DISPATCH} x {np_}, d={d}, bf16, packed "
            f"mask): {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}: "
            f"{byts / 1e9:.3f} GB, {flops / 1e12:.3f} TFLOP), "
            f"{bound / k_ms:.3f} of the bound; max |s - plain| {main_err:.3e} "
            f"(phase 3 max {kernel_err:.3e})")
        rows = [dict(name="score_chunkmax", **KERNEL_ROWS["score_chunkmax"],
                     launches=serve_launches["score_chunkmax"], max_abs_err=main_err,
                     ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     library_ms=lib_ms,
                     ms_method="CUDA events around the wrapper")]
        del q, c, qb, cb, mp

        # 5. the training path at the same width, same graph and split
        cfg = Config(
            model=ModelConfig(num_layers=TRAIN["layers"], dim=FULL["dim"]),
            train=TrainConfig(epochs=TRAIN["epochs"], num_clusters=TRAIN["clusters"],
                              trainer="compact", optimizer="adam", fused_bpr=True,
                              checkpoint_path=str(WORK / "best_model.npz")))
        t0 = time.time()
        parts = partition_bipartite_greedy(train_e, data.num_users, num_nodes,
                                           TRAIN["clusters"], seed=SEED)
        t_part = time.time() - t0
        retention = edge_retention(parts, train_e.shape[1])
        t0 = time.time()
        cc = compact.build_compact_clusters(parts, data.num_users, device="cuda")
        t_cc = time.time() - t0
        del parts
        n_local, width = cc.u_pad + cc.i_pad, cc.user_local.shape[1]
        # as prepare_training_data does: dense blocks while they fit
        # cfg.train.dense_adjacency_max_nodes, else the segment path
        t0 = time.time()
        cc = densify_if_fits(cc, cfg.train)
        torch.cuda.synchronize()
        t_dense = time.time() - t0
        dense = cc.adj is not None
        log(f"[train] native partitioner (greedy + 4 rounds of label-propagation "
            f"refinement), {cc.num_clusters} clusters: u_pad {cc.u_pad}, i_pad {cc.i_pad}, "
            f"n_local {n_local}, triplet width {width}, "
            f"{int(cc.mask.sum())} valid triplets per epoch, edge retention "
            f"{retention:.4f}; partition {t_part:.1f} s, compact clusters "
            f"{t_cc:.1f} s; propagation: " + (
                f"dense adjacency {tuple(cc.adj.shape)} {str(cc.adj.dtype)[6:]} "
                f"({cc.adj.numel() * 2 / 1e9:.3f} GB) in {t_dense:.2f} s" if dense else
                f"segment path over {cc.src.shape[1]} padded edges per cluster "
                f"(n_local exceeds dense_adjacency_max_nodes "
                f"{cfg.train.dense_adjacency_max_nodes})"))
        check(cc.num_clusters == TRAIN["clusters"], "a cluster came out empty")
        t0 = time.time()
        val = build_eval_batch(val_e, num_nodes, data.num_users, "cuda")
        test = build_eval_batch(test_e, num_nodes, data.num_users, "cuda")
        state = create_train_state(cfg, data.num_users, data.num_items,
                                   generator=torch.Generator().manual_seed(SEED),
                                   device="cuda")
        log(f"[train] eval batches ({val[1].user.shape[0]} val, "
            f"{test[1].user.shape[0]} test triplets) and state: {time.time() - t0:.1f} s")

        saved = []

        def save_cb(st, recall):
            saved.append(recall)
            save_params(cfg.train.checkpoint_path, st.params,
                        meta={"val_recall": recall})

        launches.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state, hist = train_model(cfg, state, cc, val, test, save_checkpoint=save_cb)
        torch.cuda.synchronize()
        t_train = time.time() - t0
        train_launches = dict(launches)
        log(f"[train] train_model {TRAIN['epochs']} epochs + test eval: {t_train:.2f} s; "
            f"epoch times with the val eval {[round(t, 3) for t in hist['epoch_time_s']]} s; "
            f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"[train] kernel launches on the training path: {train_launches}")
        steps = TRAIN["epochs"] * cc.num_clusters
        check(train_launches.get("bpr_tile", 0) == steps,
              f"bpr_tile launched {train_launches.get('bpr_tile', 0)} times, "
              f"expected one per step ({steps})")
        # per step: the negatives' gradient rows; on the segment path also
        # each hop's message sum and its gather's backward; per eval (a val
        # eval each epoch, the test eval) each hop of spmm_rows' sum
        scatters = (steps * (1 + (0 if dense else 2 * TRAIN["layers"]))
                    + (TRAIN["epochs"] + 1) * TRAIN["layers"])
        check(train_launches.get("sorted_index_add", 0) == scatters,
              f"sorted_index_add launched {train_launches.get('sorted_index_add', 0)} "
              f"times, expected {scatters}")
        check(all(np.isfinite(v) for key in hist for v in hist[key]),
              f"a loss or metric is not finite: {hist}")
        check(hist["train_loss"][1] < hist["train_loss"][0],
              f"train loss did not fall: {hist['train_loss']}")
        check(state.step == steps, f"state.step {state.step} != {steps}")
        check(bool(saved) and Path(cfg.train.checkpoint_path).exists(),
              "no best-val checkpoint was written")
        log(f"[train] train loss {hist['train_loss']}, val loss {hist['val_loss']}, "
            f"val recall {hist['val_recall']}, test recall {hist['test_recall']}")

        # one cluster's gradients: the kernel route against the plain route,
        # both through the segment path, so that every step is f32 and the
        # two differ only in summation order. (Through a bf16 adjacency the
        # backward rounds the cotangent to bf16, and an f32 difference of one
        # ulp between the two routes' summation orders can flip that rounding:
        # a one-bf16-ulp difference that says nothing of the kernel.)
        cfg_plain = cfg.replace(train=TrainConfig(fused_bpr=False))
        adj_of = lambda c: None if cc.adj is None else cc.adj[c]
        gen_c = torch.Generator(device="cuda").manual_seed(SEED + 2)
        c_id = 7
        neg = sample_negative(gen_c, width, data.num_items)
        l_k, g_k = loss_and_grads(compact.compact_cluster_loss, state.params,
                                  cc.cluster(c_id), neg, cfg, cc.u_pad, cc.i_pad, None)
        l_s, g_s = loss_and_grads(compact.compact_cluster_loss, state.params,
                                  cc.cluster(c_id), neg, cfg_plain, cc.u_pad,
                                  cc.i_pad, None)
        ru, ri = rel_max(g_k.user_emb, g_s.user_emb), rel_max(g_k.item_emb, g_s.item_emb)
        check(abs(l_k.item() - l_s.item()) <= 1e-5 * abs(l_s.item()) and ru < 1e-4
              and ri < 1e-4, f"cluster {c_id}: kernel route loss {l_k.item()!r} vs "
              f"plain {l_s.item()!r}, grad rel err user {ru:.3e} item {ri:.3e}")
        log(f"[train] cluster {c_id} step gradients, kernel route vs plain route "
            f"(segment path, f32): loss {l_k.item():.6f} vs {l_s.item():.6f}, "
            f"rel err user {ru:.3e}, item {ri:.3e}")
        del g_k

        # the same cluster through a dense bf16 adjacency block (f32 result
        # from torch.mm's out_dtype) against the segment path: bf16 operand
        # rounding only
        one = dataclasses.replace(cc, adj=None, **{
            f: getattr(cc, f)[c_id:c_id + 1] for f in (
                "user_ids", "item_ids", "src", "dst", "w", "user_local",
                "pos_local", "mask", "edge_counts", "user_valid", "item_valid")})
        one = compact.densify_adjacency(one, max_local_nodes=n_local)
        l_d, g_d = loss_and_grads(compact.compact_cluster_loss, state.params,
                                  cc.cluster(c_id), neg, cfg_plain, cc.u_pad,
                                  cc.i_pad, one.adj[0])
        ri = rel_max(g_d.item_emb, g_s.item_emb)
        check(abs(l_d.item() - l_s.item()) < 5e-4 and ri < 5e-2,
              f"dense bf16 adjacency vs segment path: loss {l_d.item()!r} vs "
              f"{l_s.item()!r}, item grad rel err {ri:.3e}")
        log(f"[train] cluster {c_id}, dense bf16 adjacency vs segment path: loss "
            f"{l_d.item():.6f} vs {l_s.item():.6f}, item grad rel err {ri:.3e}")
        del one, g_d, g_s

        # one step twice from the same state, order and negatives: parameters
        # and Adam moments bit-equal, on the dense bf16 block (the main path)
        # and on the segment path
        epoch_fn = compact.make_compact_epoch_fn(cfg)
        # a copy of a state: tables and moments cloned (Adam's or the lazy
        # optimizers' state, whose fields are the count and two table pairs)
        tables = lambda p: type(p)(*(t.clone() for t in p))
        copy = lambda st: TrainState(
            tables(st.params), type(st.opt_state)(*(
                f if isinstance(f, int) else tables(f) for f in st.opt_state)),
            st.step)
        cc_seg = dataclasses.replace(cc, adj=None)
        main_path = "dense bf16" if dense else "segment"
        for path, cc_p in ((main_path, cc), ("segment", cc_seg)):
            before = dict(launches)
            runs = [epoch_fn(copy(state), cc_p, None, perm=[c_id], neg=neg[None])[0]
                    for _ in range(2)]
            torch.cuda.synchronize()
            a, b = runs
            pairs = list(zip(a.params + a.opt_state.mu + a.opt_state.nu,
                             b.params + b.opt_state.mu + b.opt_state.nu))
            same = [torch.equal(x, y) for x, y in pairs]
            check(all(same), f"cluster {c_id}'s step on the {path} path is not "
                  f"bit-equal over two runs (params and moments equal: {same})")
            check(not torch.equal(a.params.item_emb, state.params.item_emb),
                  f"the {path} step changed nothing")
            n_sc = launches["sorted_index_add"] - before.get("sorted_index_add", 0)
            log(f"[train] cluster {c_id}, one step run twice on the {path} path: "
                f"parameters and Adam moments bit-equal ({n_sc // 2} sorted_index_add "
                f"launches per step)")
            del runs, a, b, pairs

        state_h, hist_h = lazy_phase(cfg, cc, cc_seg, main_path, c_id, neg, data, val, test,
                             hist, copy, steps, scatters)

        # a third epoch, timed alone (no eval), then a profiled window of steps;
        # then the same for each lazy-row optimizer from the hybrid run's state
        timings = {}
        for opt in ("adam",) + compact.LAZY_OPTIMIZERS:
            fn = epoch_fn if opt == "adam" else compact.make_compact_epoch_fn(
                cfg.replace(train=dataclasses.replace(cfg.train, optimizer=opt)))
            st = [state if opt == "adam" else copy(state_h)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            st[0], loss3 = fn(st[0], cc, epoch_generator(cfg, TRAIN["epochs"],
                                                         torch.device("cuda")))
            torch.cuda.synchronize()
            t_epoch = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            check(np.isfinite(loss3), f"{opt}: the third epoch's loss is not finite")
            log(f"[train] {opt}: epoch 3 alone: {t_epoch:.3f} s per epoch, "
                f"{1e3 * t_epoch / cc.num_clusters:.3f} ms per step, train loss "
                f"{loss3:.4f}; peak device memory {peak / 1e9:.3f} GB "
                f"({(peak - resident) / 1e9:.3f} GB over the resident {resident / 1e9:.3f})")
            gen_p = torch.Generator(device="cuda").manual_seed(SEED + 3)

            def ten_steps():
                st[0], _ = fn(st[0], cc, gen_p, perm=list(range(10)))

            prof = profile_window(f"10 {opt} train steps", 2, 14 if opt == "adam" else 8,
                                  ten_steps)
            timings[opt] = dict(
                step_ms=1e3 * t_epoch / cc.num_clusters, busy_ms_per_step=prof["busy_ms"] / 10,
                profiled_wall_ms_per_step=prof["wall_ms"] / 10,
                idle_share=prof["idle_share"], launches_per_step=prof["kernels"] / 10,
                peak_gb=peak / 1e9, epoch_peak_over_resident_gb=(peak - resident) / 1e9)
            if opt == "adam":
                state = st[0]
            del st
        log(f"[train] per optimizer, {smi}: {json.dumps(timings)}")
        del state_h

        # 7b. bpr_tile at a real cluster's shape: time, plain, bound
        with torch.no_grad():
            user_ids, item_ids, src, dst, w, ul, pl, mask = cc.cluster(c_id)
            u_rows = state.params.user_emb.index_select(0, user_ids)
            i_rows = state.params.item_emb.index_select(0, item_ids)
            k1 = TRAIN["layers"] + 1
            scale = 1.0 / (k1 * k1)
            acc = compact._propagate_local(torch.cat([u_rows, i_rows]), src, dst, w,
                                           adj_of(c_id), TRAIN["layers"], n_local)
            final = acc.float() * scale
            u_tab = torch.cat([final[:cc.u_pad], u_rows], dim=1)
            i_tab = torch.cat([final[cc.u_pad:], i_rows], dim=1)
            ni = state.params.item_emb.index_select(0, neg)
            loc, inc = compact._neg_local_index(item_ids, neg, cc.i_pad)
            kargs = (u_tab, i_tab, ni, ul, pl, loc, inc.to(torch.int32),
                     mask.to(torch.int32))
            # the trainer's lists: the cluster's, and the step's negative runs
            lists = cc.lists(c_id)
            neg_prep = lambda: compact.step_incidence(
                lists, sort_rows(neg, data.num_items))
            step_lists = neg_prep()
        kw = dict(scale=scale, bpr_coeff=cfg.train.bpr_coeff, loss="reference")
        b1_err = check_bpr(kargs, f"bpr_tile at cluster {c_id}'s shape", step_lists,
                           also=[cuda_bpr.bpr_incidence(*kargs[3:], cc.u_pad, cc.i_pad)],
                           **kw)
        b1 = time_bpr(kargs, step_lists, neg_prep=neg_prep, **kw)
        check(b1["kernels"] <= 2 and b1["memsets"] == 0,
              f"bpr_tile enqueues {b1['kernels']} kernels and {b1['memsets']} "
              f"memsets per call")
        b1_plain = time_ms(lambda: cuda_bpr.bpr_tile_plain(*kargs, **kw), 5, warmup=1)
        valid, in_cl = int(mask.sum()), int((inc & mask).sum())
        d = FULL["dim"]
        b1_bound, b1_by, byts, flops = bpr_bound(kargs, bw)
        log_bpr_time(f"cluster {c_id}'s shape (u_pad {cc.u_pad}, i_pad {cc.i_pad}, "
                     f"B {width} of which {valid} valid and {in_cl} negatives in "
                     f"the cluster, d={d})", b1, b1_bound, b1_by, byts, flops, b1_plain)
        log(f"[kernel] bpr_tile at cluster {c_id}'s shape: max abs err "
            f"{b1_err:.3e}, bit-equal over two calls, two grids of pass 1 and "
            f"the lists bpr_incidence builds from the same arrays (phase 3 max "
            f"err {bpr_err:.3e})")
        rows.append(dict(name="bpr_tile", **KERNEL_ROWS["bpr_tile"],
                         launches=train_launches["bpr_tile"], max_abs_err=b1_err,
                         ms=b1["device"], plain_ms=b1_plain, bound_ms=b1_bound,
                         bound_by=b1_by, library_ms=None,
                         ms_method="device time of one wrapper call, torch.profiler",
                         launches_per_call=b1["kernels"],
                         memsets_per_call=b1["memsets"], pass1_ms=b1["pass1"],
                         pass2_ms=b1["pass2"], step_neg_sort_ms=b1["neg_sort"],
                         step_neg_starts_ms=b1["neg_starts"],
                         wrapper_ms=b1["wrapper"]))

        # 7e. sorted_index_add at the step's negatives: their gradient rows
        # over the catalog (B entries, 59,047 rows, d 64, f32)
        order, starts = sort_rows(neg, data.num_items)
        g_rows = torch.randn(width, d, device="cuda", generator=gen_c)
        sc = lambda: cuda_scatter.sorted_index_add(g_rows, order, starts, data.num_items)
        out_k = sc()
        out_h = cuda_scatter.sorted_index_add_plain(g_rows.cpu(), order.cpu(),
                                                    starts.cpu(), data.num_items)
        lib = lambda: torch.zeros(data.num_items, d, device="cuda").index_add_(0, neg, g_rows)
        out_l = lib()
        torch.cuda.synchronize()
        sc_err = (out_k - out_l).abs().max().item()
        check(torch.equal(out_k.cpu(), out_h) and torch.equal(out_k, sc())
              and sc_err <= 1e-5 * out_l.abs().max().item(),
              f"sorted_index_add at the step's negatives: {sc_err:.3e} from "
              f"index_add_, or not bit-equal to the host's plain version")
        sc_dev, _ = profiled_ms(sc, 20, "sorted_index_add_kernel")
        sc_events = time_ms(sc, 20)
        sc_plain = time_ms(lambda: cuda_scatter.sorted_index_add_plain(
            g_rows, order, starts, data.num_items), 5, warmup=1)
        sc_lib = time_ms(lib, 20)
        byts = (width * d * 4 + 4 * width + 4 * (data.num_items + 1)
                + data.num_items * d * 4)
        t_bytes, t_ops = byts / bw * 1e3, width * d / F32_FLOPS * 1e3
        sc_bound, sc_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernel] sorted_index_add at the step's negatives ({width} entries, "
            f"{int(torch.unique(neg).numel())} distinct, over {data.num_items} rows, "
            f"d={d}, f32): {sc_dev:.4f} ms of device time per call (profiler), "
            f"{sc_events:.4f} ms by CUDA events; plain {sc_plain:.4f} ms; "
            f"zeros + index_add_ {sc_lib:.4f} ms; bound {sc_bound:.4f} ms ({sc_by}: "
            f"{byts / 1e6:.2f} MB), {sc_bound / sc_dev:.3f} of the bound; max abs err vs "
            f"index_add_ {sc_err:.3e}, bit-equal to the host's plain version "
            f"(phase 3 max err {scatter_err:.3e})")
        rows.append(dict(name="sorted_index_add", **KERNEL_ROWS["sorted_index_add"],
                         launches=train_launches["sorted_index_add"],
                         max_abs_err=sc_err, ms=sc_dev, plain_ms=sc_plain,
                         bound_ms=sc_bound, bound_by=sc_by, library_ms=sc_lib,
                         ms_method="device time of one call, torch.profiler",
                         wrapper_ms=sc_events))
        del kargs, u_tab, i_tab, ni, acc, final, g_rows, out_k, out_l

        # 7f. the evaluations' propagation (spmm_rows): sorted_index_add at
        # the val graph's row runs (its own edges in their own order, every
        # node a row, d 64) on one hop of the trained tables
        coo = val[0]
        x = torch.cat(list(state.params))
        msg = x.index_select(0, coo.src) * coo.w[:, None]
        sc = lambda: cuda_scatter.scatter_rows(msg, coo.dst, coo.order, coo.starts,
                                               coo.num_nodes)
        out_k, out_l = sc(), spmm_segment(coo, x)
        torch.cuda.synchronize()
        out_h = cuda_scatter.sorted_index_add_plain(msg.cpu(), coo.order.cpu(),
                                                    coo.starts.cpu(), coo.num_nodes)
        ev_err, ev_top = (out_k - out_l).abs().max().item(), out_l.abs().max().item()
        run = int((coo.starts[1:] - coo.starts[:-1]).max())
        what = (f"sorted_index_add at the val graph ({coo.src.shape[0]} edges over "
                f"{coo.num_nodes} rows, longest run {run}, d={d}, f32)")
        check(torch.equal(out_k.cpu(), out_h), f"{what}: differs from the plain version's "
              f"sequential sum on the host")
        check(torch.equal(out_k, sc()), f"{what}: two calls differ")
        check(torch.equal(spmm_rows(coo, x), out_k), f"{what}: spmm_rows differs")
        check(ev_err <= 1e-5 * ev_top, f"{what}: {ev_err:.3e} from spmm_segment's index_add "
              f"on the card, largest entry {ev_top:.3e}")
        # one val evaluation (loss and sampled recall, 3 hops) through either sum
        evals = {}
        for label, fn in (("spmm_rows", spmm_rows), ("spmm_segment", spmm_segment)):
            ev = make_eval_step(cfg, fn)
            once = lambda: ev(state.params, *val, torch.Generator(device="cuda").manual_seed(3))
            pairs = [tuple(float(v) for v in once()) for _ in range(3)]
            evals[label] = dict(ms=time_ms(once, 5), repeats_equal=len(set(pairs)) == 1)
        check(evals["spmm_rows"]["repeats_equal"], f"{what}: three val evaluations through "
              f"spmm_rows are not bit-equal")
        scatter_eval = dict(edges=int(coo.src.shape[0]), rows=coo.num_nodes, longest_run=run,
                            max_abs_err=ev_err, scatter_ms=time_ms(sc, 10),
                            index_add_ms=time_ms(lambda: spmm_segment(coo, x), 10),
                            eval_ms=evals["spmm_rows"]["ms"],
                            eval_index_add_ms=evals["spmm_segment"]["ms"],
                            eval_index_add_repeats_equal=evals["spmm_segment"]["repeats_equal"])
        rows[-1].update(eval_graph=scatter_eval)
        log(f"[kernel] {what}: bit-equal to the plain version on the host, over two calls "
            f"and through spmm_rows; max abs err vs spmm_segment on the card {ev_err:.3e} "
            f"(largest entry {ev_top:.3e}); one hop's sum {scatter_eval['scatter_ms']:.4f} "
            f"ms, spmm_segment's whole hop (gather + index_add) "
            f"{scatter_eval['index_add_ms']:.4f} ms; one val evaluation through spmm_rows "
            f"{scatter_eval['eval_ms']:.4f} ms (three repeats bit-equal), through "
            f"spmm_segment {scatter_eval['eval_index_add_ms']:.4f} ms (three repeats "
            f"bit-equal: {scatter_eval['eval_index_add_repeats_equal']})")
        del coo, x, msg, out_k, out_l, out_h

        # 5b. eval and propagated serving at the same width
        rows += new_path_phase(data, (train_e, val_e, test_e),
                               cfg.train.checkpoint_path, cfg, bw)
        log(f"[eval] phase 3 max errs: ell_spmm {ell_err:.3e}, mips_block {block_err:.3e}")

        # 5c. the full-graph trainer at the JAX flagship's width
        fgp = fullgraph_phase(data, bw, smi, next(r for r in rows if r["name"] == "ell_spmm"))

        # 5d. full-state checkpoints, recovery and feasible negatives
        recovery_phase(data, train_e, cfg, cc, val, test, hist_h, timings, fgp, smi)

        # 5e. the multi-device slice on a one-rank NCCL group
        mesh_phase(data, train_e, val_e, test_e, cfg, cc, val, test, smi)
        del cc, val, test, fgp

        # 6. trained -> served, then the CLI at a small synthetic size
        launches.clear()
        trained, tmeta = load_params(cfg.train.checkpoint_path, device="cuda")
        check(tmeta == {"val_recall": saved[-1]}, "trained checkpoint's meta changed")
        check(not torch.equal(trained.item_emb, params0.item_emb),
              "the trained checkpoint holds the initial tables")
        tindex = ServingIndex(trained, index.mask, index.num_items, user_lo=index.user_lo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, i = tindex.batch_recommend(users, top_k=TOP_K)
        torch.cuda.synchronize()
        log(f"[meet] trained checkpoint served: {DISPATCH} users in "
            f"{1e3 * (time.perf_counter() - t0):.3f} ms")
        check_served(tindex, users, s, i, data.num_items)

        small = make_synthetic_movielens(
            SMALL["users"], SMALL["items"], SMALL["interactions"], seed=SEED,
            power=SMALL["power"], num_communities=SMALL["communities"])
        cli_base = ["--device", "cuda", "--dataset", "synthetic",
                    "--synthetic-users", str(SMALL["users"]),
                    "--synthetic-items", str(SMALL["items"]),
                    "--synthetic-interactions", str(SMALL["interactions"]),
                    "--synthetic-communities", str(SMALL["communities"]),
                    "--synthetic-power", str(SMALL["power"]),
                    "--indexes-dir", str(WORK / "small_indexes"),
                    "--checkpoint", str(WORK / "small_model.npz"),
                    "--histories-dir", str(WORK / "small_hist"),
                    "--clusters", str(SMALL["clusters"]), "--epochs", "1"]
        users_file = WORK / "users.txt"
        batch_raw = small.raw_user_id(np.arange(2048))
        users_file.write_text("\n".join(map(str, batch_raw)) + "\n999999999\n")
        for extra in (["train", "--fused-bpr", "--full-eval", "--full-eval-users", "2000"],
                      ["recommend", "--user-id", str(int(small.user_ids[0]))],
                      ["recommend", "--propagated", "--user-id", str(int(small.user_ids[0]))],
                      ["recommend", "--movie-id", str(int(small.movie_ids[0]))],
                      ["recommend", "--users-file", str(users_file),
                       "--out", str(WORK / "recs.csv")]):
            t0 = time.time()
            rc = cli.main(cli_base + extra)
            check(rc == 0, f"cli {' '.join(extra[:2])} exited {rc}")
            log(f"[cli] {' '.join(extra[:2])}: rc 0 in {time.time() - t0:.1f} s")
        lines = (WORK / "recs.csv").read_text().splitlines()
        check(len(lines) == 1 + 2048 * TOP_K, f"recs.csv has {len(lines)} lines")
        check((WORK / "small_model.npz").exists()
              and (WORK / "small_hist" / "hist_train_loss.npy").exists(),
              "cli train wrote no checkpoint or histories")
        torch.cuda.synchronize()
        meet_launches = dict(launches)
        log(f"[meet] kernel launches, trained -> served and the CLI: {meet_launches}")
        check(meet_launches.get("bpr_tile", 0) == SMALL["clusters"]
              and meet_launches.get("sorted_index_add", 0) >= SMALL["clusters"]
              and meet_launches.get("score_chunkmax", 0) >= 2
              and meet_launches.get("ell_spmm", 0) >= TRAIN["layers"],
              "the CLI phase did not go through its four kernels")
        # the CLI's hybrid_adam training at the same size, beside its own
        # checkpoint and histories
        launches.clear()
        t0 = time.time()
        rc = cli.main(cli_base + ["--checkpoint", str(WORK / "small_hybrid.npz"),
                                  "--histories-dir", str(WORK / "small_hybrid_hist"),
                                  "train", "--optimizer", "hybrid_adam", "--fused-bpr"])
        check(rc == 0, f"cli train --optimizer hybrid_adam exited {rc}")
        torch.cuda.synchronize()
        cli_h = dict(launches)
        log(f"[cli] train --optimizer hybrid_adam --fused-bpr: rc 0 in "
            f"{time.time() - t0:.1f} s; kernel launches {cli_h}")
        check(cli_h.get("bpr_tile", 0) == SMALL["clusters"]
              and (WORK / "small_hybrid.npz").exists()
              and (WORK / "small_hybrid_hist" / "hist_train_loss.npy").exists(),
              "cli train --optimizer hybrid_adam did not train through bpr_tile or "
              "wrote no checkpoint or histories")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    log(f"[done] {time.time() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
