#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --mesh-only | --infonce-only | --triplet-only]

``--kernels-only`` stops after phase 3 (a new kernel's first, short run).
``--infonce-only`` builds the fused InfoNCE alone and runs its phase
(``infonce_phase``) alone; ``--triplet-only`` likewise the fused triplet
loss and the row sums (``triplet_phase``).
``--mesh-only`` (two or more cards) runs after the build only the meshes of
several cards against the 1×1 mesh (``mesh_cards_only``): the segment step
and the hybrid step.

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
     sequential sum on the host and over two calls; then its long lane
     (:func:`scatter_long_cases`: runs of 60,000, 20,000, T and T + 1
     entries, every row long, long rows side by side, each copy width),
     bit-equal too, with the long lane's tally counted.
     ``ell_spmm``: d in {16, 64, 100, 256}, f32 and bf16 tables, a graph with
     an isolated node and a hub whose bucket is grown to the max degree (its
     row split into many segments), aligned and unaligned row counts, and a
     graph whose rows all read higher ids (one side of the work list empty),
     weights that are not the graph's own gcn_norm, a remainder with a third
     of its rows empty (d = 256), the transpose of an asymmetric graph and
     the backward over it; rectangular graphs with a source table of their
     own size (fewer rows than sources with emptied rows and a split hub
     row, d 64 and 30; its transpose, more rows than sources; the backward
     of one over the other); every case bit-equal over two calls.
     ``mips_block``: with and without mask,
     N no multiple of the block, k in {1, 10, 100}, Q no multiple of the query
     band, a row with fewer than k live columns, planted exact ties, d in
     {64, 100}; then d = 30 (4-byte copies), d = 256 and k = 1000 (candidate
     buffers in global scratch); every case bit-equal over two calls.
     ``triplet_loss`` (:func:`triplet_phase`): d 32 to 512, K 8, 3, 1 and
     (B,) negatives, a masked tail and every triplet masked, then the
     full-graph cells' shapes, bit-equal over two calls and timed beside
     its bound, its plain version and the gather route;
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
  5f. the sharded hybrid path (``sharded_hybrid_phase``) at the JAX
     package's bench configuration on a one-rank NCCL group: 64 parts
     (doubled while a block is too wide), ghost columns up to 4,608, bf16
     blocks, the symmetric VJP, over the interaction split. Host times of
     the partition and of ``shard_hybrid_graph``; one step with f32 blocks
     against the single-device ``spmm_hybrid_sym`` step (loss rtol 2e-5,
     Adam's first moments within 1e-5 of the largest entry), and without
     the symmetric VJP; with bf16 blocks a step bit-equal over two runs
     (6 B4 launches, its collectives), timed at the epoch's batch and at
     2^20 and profiled; three epochs of ``make_sharded_epoch_fn``, one with
     host syncs made errors, the third timed; the mesh's propagated tables
     against the ELL route; B4 at a 4-rank shard's shape (55,398 rows from
     221,592 sources) and its transpose against the plain version, timed
     beside ``torch.sparse.mm``; one ``[sharded-hybrid]`` JSON line;
  5h. the full-node trainer's fused epoch (``fullnode_phase``) as
     ``bench.py``'s ``bench_tpu_epoch(trainer="full")`` builds it: phase 5's
     100 native clusters as ``build_cluster_batches(..., bucket_floor=4096)``
     stacked on the card (``StackedClusters``), L = 3, d = 64, Adam. The
     epoch's step captured once as a CUDA graph and replayed per cluster
     (``make_epoch_fn``): ``train_model`` for 2 epochs (falling losses; the
     row scatter counted at the warm-up step and the capture only, so the
     second epoch replays); the captured epoch ``torch.equal`` to the eager
     body's from the same state and generator under constant and cosine lr
     (tables, moments, loss, count, step; the generators and the val evals
     after them equal); the eager body's steps with host syncs made errors;
     the row scatter's widest call at each shape of one eager epoch held
     against its plain version (bit-equal to the host's sequential sum,
     within 1e-5 of ``index_add_``), its largest error folded into the
     kernels line's row; each route's epoch timed and profiled (idle share, kernels a step, peak
     memory); a 3-epoch run recovered from two drops ``torch.equal`` to the
     uninterrupted one; one ``[fullnode]`` JSON line;
  6. trained -> served: the checkpoint of phase 5 behind the ``ServingIndex``
     for one 32,768-user dispatch; then the CLI at a small synthetic size:
     ``train --fused-bpr --full-eval --epochs 1``, the three ``recommend``
     modes and ``recommend --propagated``, and ``train --optimizer
     hybrid_adam --fused-bpr`` beside its own checkpoint;
  6b. the user-facing surface at ML-25M width (``surface_phase``): phase 4's
     graph written as ML-25M's CSVs (its pairs rated 4.0 to 5.0, about 1.2 M
     other pairs rated lower, quoted titles with commas, tags);
     ``MovieLensDataHandler`` over them against ``load_movielens`` and its
     100 cluster batches on the card; ``cli --dataset ml-25m`` at
     ``ml25m_config()``'s 4 layers, d = 128 and 100 clusters: ``train
     --fused-bpr`` (100 B1 launches) with its history plot, B1 held against
     its plain version on the inputs of the widest cluster that run gave it,
     the trained tables finite and moved, ``eda`` (its counts against the
     rows written) and ``recommend --plots``; the
     analysis' selection on the card against its host copy's; step-numbered
     parameter checkpoints of the trained tables on the card; the PNGs where
     matplotlib is installed, else the "skipped" lines naming it; one
     ``[surface]`` JSON line, the phase within 120 s;
  6c. the four example drivers (``examples_phase``), each's ``main`` in this
     process on the card, phase 4's graph answering their builds of it:
     ``torch_train_ml25m_scale.py`` at the d = 512 microbatched full-graph
     flags of its run log (1 epoch), ``torch_train_bridge.py`` at the d = 128
     hybrid bridge's flags (a compact epoch and a refresh),
     ``torch_train_sharded.py --mesh 1x1`` and ``torch_profile_epoch.py``;
     each returns, its launches counted, each kernel it launched held
     against its plain version at every shape it gave it (B4 and the row
     scatter at one kept call per shape, B1 at its widest call), the
     trainers' losses finite and tables moved, their headline lines held,
     one ``[examples]`` JSON line, the phase within 300 s;
  7. each kernel timed at its main-path shape beside its plain version, one
     library call where one computes the same function, and its bound;
  7r. (after 5f) the epochs' row-op roofline (``roofline_phase``): the
     primitive rates measured at the main path's shapes from captured CUDA
     graphs, the compact floor under Adam and ``hybrid_adam`` and the
     sharded hybrid floor, each over its timed epoch of 5a / 5f as
     ``rowop_util`` in (0, 1]; one ``[roofline]`` JSON line.

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

# the published peaks and the BPR kernel's byte count, shared with the
# epochs' floors (phase 7r)
from movie_recommender_system_with_gnns_tpu_torch.utils.roofline import (
    F32_FLOPS, TF32_FLOPS, bpr_tile_bytes, bpr_tile_counts, bpr_tile_flops, peaks_for)
from movie_recommender_system_with_gnns_tpu_torch.data.movielens import ML25M_SYNTHETIC

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke_work"
#: bench.py SCALES["full"]: ML-25M statistics with 200 planted communities, d = 64
FULL = dict(ML25M_SYNTHETIC, dim=64)
DISPATCH = 32_768
DISPATCHES = 5
TOP_K = 10
SEED = 0
#: the training path: reference defaults (100 clusters, L = 3, d = 64)
TRAIN = dict(clusters=100, layers=3, epochs=2)
#: the full-graph phase: the JAX flagship's configuration
#: (runs/ml25m_fg150_k8_d256_pop.log), 2 epochs
FG = dict(dim=256, layers=3, parts=100, steps=16, negatives=8, lr=3e-3, warmup=32,
          epochs=2)
#: the microbatched full-graph step: JAX's ml25m_fg150_k8_d512_pop width
#: (runs/ml25m_fg150_k8_d512_pop.log: --dim 512 --loss-microbatches 16)
FG_MICRO = dict(chunks=16, dim=512, timed=5)
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
    # no Pallas kernel: the JAX package has no XSimGCL
    "infonce": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/infonce.cu",
        replaces="none (XSimGCL's in-batch InfoNCE, models/xsimgcl.py)"),
    # no Pallas kernel: XLA fuses the JAX package's triplet loss
    "triplet_loss": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/triplet_loss.cu",
        replaces="none (the full-graph trainers' standard BPR loss, ops/bpr.py)"),
}
#: the XSimGCL cell's InfoNCE shapes: a step's distinct users and items (the
#: benchmark's graph and split, 349,184 pairs a step) in buffers of every
#: user and every item, d 64
INFONCE = dict(users=113_000, items=55_000, user_cap=162_541, item_cap=59_047, dim=64,
               tau=0.15, timed=5)
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
    inputs, with what sets it, the bytes and the operations, counted from the
    data by the port's ``utils/roofline.py`` (``bpr_tile_counts``,
    ``bpr_tile_bytes``, ``bpr_tile_flops``), the count the compact epoch's
    floor charges the kernel."""
    counts = bpr_tile_counts(*args)
    byts = bpr_tile_bytes(**counts)
    flops = bpr_tile_flops(d=counts["d"], valid=counts["valid"])
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
    scatter_long_cases(gen)
    return worst


def infonce_case(n: int, cap: int, d: int, gen, what: str, tau: float = 0.15) -> dict:
    """The three InfoNCE kernels against the plain version on the card, over
    ``n`` real rows in buffers of ``cap``: a view and a noisy copy of it,
    rows over their norms, rounded to bfloat16. The log-sum-exp within 1e-4
    plus 2e-6 of its size (``ex2.approx`` against ``exp``, sums reordered);
    each product with P within 2^-8 × the largest operand entry + 1e-5: P
    rounded to bfloat16 on both sides may round the other way where the
    two f32 values straddle a boundary, by one unit of 2^-8 of P, and P's
    row sums to 1. Bit-equal over two calls; whole blocks past ``n`` zero.
    Returns the largest errors."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_infonce as ci

    x = torch.randn(cap, d, device="cuda", generator=gen)
    y = x + 0.5 * torch.randn(cap, d, device="cuda", generator=gen)
    qa = torch.nn.functional.normalize(x, dim=-1).to(torch.bfloat16).contiguous()
    qb = torch.nn.functional.normalize(y, dim=-1).to(torch.bfloat16).contiguous()
    count = torch.tensor([n], dtype=torch.int32, device="cuda")
    lse = ci.lse_cuda(qa, qb, count, tau)
    pa = ci.pmul_cuda(qa, qb, lse, count, tau, column_bias=False)
    pb = ci.pmul_cuda(qb, qa, lse, count, tau, column_bias=True)
    again = (ci.lse_cuda(qa, qb, count, tau), ci.pmul_cuda(qa, qb, lse, count, tau, False),
             ci.pmul_cuda(qb, qa, lse, count, tau, True))
    ref_lse = ci.lse_plain(qa, qb, count, tau)
    ref_pa, ref_pb = ci.grads_plain(qa, qb, ref_lse, count, tau)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip((lse, pa, pb), again)),
          f"{what}: two calls differ")
    live = slice(0, n)
    lse_err = (lse[live] - ref_lse[live]).abs().max().item()
    check(lse_err <= 1e-4 + 2e-6 * ref_lse[live].abs().max().item(),
          f"{what}: log-sum-exp {lse_err:.3e} from the plain version")
    bound = 2.0 ** -8 * qa.float().abs().max().item() + 1e-5
    pa_err = (pa[live] - ref_pa[live]).abs().max().item()
    pb_err = (pb[live] - ref_pb[live]).abs().max().item()
    check(pa_err <= bound and pb_err <= bound,
          f"{what}: P products {pa_err:.3e} / {pb_err:.3e} from the plain version "
          f"(bound {bound:.3e})")
    tail = slice((n + 127) // 128 * 128, cap)      # whole blocks past the count
    check(not bool(lse[tail].any()) and not bool(pa[tail].any()) and not bool(pb[tail].any()),
          f"{what}: a block past the count wrote something other than zeros")
    log(f"[kernel] {what}: n {n} in {cap}, d {d}: bit-equal over two calls; "
        f"lse err {lse_err:.3e}, P·B err {pa_err:.3e}, Pt·A err {pb_err:.3e}")
    return {"lse": lse_err, "pa": pa_err, "pb": pb_err}


def infonce_phase(smi: str, bf16_flops: float) -> dict:
    """The fused InfoNCE (``csrc/infonce.cu``): small cases (n of 1, under a
    tile, ragged, a multiple of the 128-row block; d 32 / 64), the
    whole op (loss and both views' gradients through autograd) against the
    plain version on the host, then the XSimGCL cell's shapes (``INFONCE``:
    113,000 users in 162,541 rows, 55,000 items in 59,047, d 64) against the
    plain version on the card, forward and backward; each timed by CUDA
    events (median of ``timed``) beside its bound (6·n²·d at the dense bf16
    peak), beside the exponentials' bound (3·n² ``ex2`` at 16 a clock an
    SM, at the card's SM count and its highest SM clock) and beside the
    plain chunked PyTorch version. One ``[infonce]`` JSON line."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_infonce as ci

    t0 = time.time()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    ex2_per_s = 16.0 * sms * sm_hz
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    worst = {"lse": 0.0, "pa": 0.0, "pb": 0.0}
    for n, cap, d in ((1, 64, 64), (37, 64, 64), (200, 333, 32), (1000, 1000, 64),
                      (1024, 1300, 64), (4133, 5000, 64)):
        errs = infonce_case(n, cap, d, gen, f"infonce n={n} cap={cap} d={d}")
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
    # the op, through autograd, against the plain version on the host
    cap, n, d = 3000, 2777, 64
    za = torch.randn(cap, d, device="cuda", generator=gen)
    zb = za + 0.3 * torch.randn(cap, d, device="cuda", generator=gen)
    count = torch.tensor([n], dtype=torch.int32, device="cuda")
    a, b = za.clone().requires_grad_(True), zb.clone().requires_grad_(True)
    loss = ci.infonce(a, b, count, 0.15, "bfloat16")
    loss.backward()
    ha, hb = za.cpu().requires_grad_(True), zb.cpu().requires_grad_(True)
    hloss = ci.infonce(ha, hb, count.cpu(), 0.15, "bfloat16")
    hloss.backward()
    loss_err = abs(float(loss.detach()) - float(hloss.detach())) / abs(float(hloss.detach()))
    grad_err = max(rel_max(a.grad.cpu(), ha.grad), rel_max(b.grad.cpu(), hb.grad))
    check(loss_err < 1e-5 and grad_err < 2e-2,
          f"infonce op: loss {loss_err:.3e}, gradients {grad_err:.3e} from the host's")
    check(not bool(a.grad[n:].any()) and not bool(b.grad[n:].any()),
          "infonce op: rows past the count got a gradient")
    log(f"[kernel] infonce op (autograd, n {n} in {cap}): loss {loss_err:.3e}, "
        f"gradients {grad_err:.3e} of the largest from the host's plain version")

    out = {"card": smi, "small_cases_max_err": worst, "op_loss_err": loss_err,
           "op_grad_err": grad_err}
    for side, n, cap in (("users", INFONCE["users"], INFONCE["user_cap"]),
                         ("items", INFONCE["items"], INFONCE["item_cap"])):
        d, tau = INFONCE["dim"], INFONCE["tau"]
        out[side] = infonce_case(n, cap, d, gen, f"infonce {side} at the cell's shape", tau)
        x = torch.randn(cap, d, device="cuda", generator=gen)
        qa = torch.nn.functional.normalize(x, dim=-1).to(torch.bfloat16).contiguous()
        qb = torch.nn.functional.normalize(
            x + 0.5 * torch.randn(cap, d, device="cuda", generator=gen),
            dim=-1).to(torch.bfloat16).contiguous()
        count = torch.tensor([n], dtype=torch.int32, device="cuda")
        lse = ci.lse_cuda(qa, qb, count, tau)
        fwd = [time_ms(lambda: ci.lse_cuda(qa, qb, count, tau), 1, 1)
               for _ in range(INFONCE["timed"])]
        bwd = [time_ms(lambda: (ci.pmul_cuda(qa, qb, lse, count, tau, False),
                                ci.pmul_cuda(qb, qa, lse, count, tau, True)), 1, 1)
               for _ in range(INFONCE["timed"])]
        plain = [time_ms(lambda: ci.grads_plain(qa, qb, ci.lse_plain(qa, qb, count, tau),
                                                count, tau), 1, 0) for _ in range(2)]
        bound_ms = 6.0 * n * n * d / bf16_flops * 1e3
        exp_bound_ms = 3.0 * n * n / ex2_per_s * 1e3
        fwd_ms, bwd_ms = float(np.median(fwd)), float(np.median(bwd))
        out[side].update(fwd_ms=fwd_ms, bwd_ms=bwd_ms, bound_ms=bound_ms,
                         roofline=bound_ms / (fwd_ms + bwd_ms), exp_bound_ms=exp_bound_ms,
                         exp_share=exp_bound_ms / (fwd_ms + bwd_ms),
                         plain_chunked_ms=float(np.median(plain)))
        log(f"[infonce] {side}: n {n}, d {d}: forward {fwd_ms:.3f} ms, backward "
            f"{bwd_ms:.3f} ms (both views), bound {bound_ms:.3f} ms "
            f"({100 * out[side]['roofline']:.1f} %), exponentials' bound "
            f"{exp_bound_ms:.3f} ms ({100 * out[side]['exp_share']:.1f} %, {sms} SMs at "
            f"{sm_hz / 1e9:.3f} GHz); plain chunked {out[side]['plain_chunked_ms']:.1f} ms")
    step_ms = sum(out[s]["fwd_ms"] + out[s]["bwd_ms"] for s in ("users", "items"))
    out.update(step_ms=step_ms, epoch_s_16_steps=16 * step_ms / 1e3,
               seconds=time.time() - t0)
    log(f"[infonce] {json.dumps(out)}")
    return out


#: the full-graph cells' triplet losses: the d-256 flagship (8 popularity
#: negatives) and XSimGCL (1 uniform negative, d 64), 349,184 triplets a step
#: over the benchmark graph's tables
TRIPLET = dict(batch=349_184, users=162_541, items=59_047, timed=5,
               cells=(("d256-pop8", 8, 256, 0.75), ("d64-k1", None, 64, 0.0)))


def triplet_inputs(gen, b, k, d, users, items, power, masked=0, scale=0.1):
    """Four f32 tables and a batch of ``b`` triplets on the card: users and
    positives drawn by a power law of their rank (exponent 0.9, ids
    shuffled), negatives by the positives' law to the ``power`` (0: uniform);
    ``k`` None gives (B,) negatives; the last ``masked`` triplets masked."""
    def law(n, p):
        w = torch.arange(1, n + 1, device="cuda", dtype=torch.float64) ** -0.9
        return w[torch.randperm(n, device="cuda", generator=gen)] ** p

    def draw(w, shape):
        n = int(np.prod(shape))
        return torch.multinomial(w, n, replacement=True, generator=gen).view(shape)

    tabs = [torch.randn(n, d, device="cuda", generator=gen) * scale
            for n in (users, items, users, items)]
    user = draw(law(users, 1.0), (b,))
    item_w = law(items, 1.0)
    pos = draw(item_w, (b,))
    neg = draw(item_w ** power, (b,) if k is None else (b, k))
    mask = torch.ones(b, dtype=torch.bool, device="cuda")
    if masked:
        mask[b - masked:] = False
    return tabs, user, pos, neg, mask


def triplet_case(inputs, what: str, coeff: float = 5e-3) -> dict:
    """The kernel pair against the plain versions on the card, upstream
    scalar 0.5: loss within 2e-6 relative (f32 sums of the same terms in
    another order), sig and each gradient buffer within 1e-5 of its largest
    entry; the two outputs bit-equal over two calls; a masked triplet's sig
    and gradient rows zero. Returns the errors."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_triplet as ct

    tabs, user, pos, neg, mask = inputs
    args = (tabs, user, pos, neg, mask)
    up = torch.tensor(0.5, device="cuda")
    runs = []
    for _ in range(2):
        loss, sig, stats = ct.triplet_fwd(*args, coeff)
        runs.append((loss, sig, stats) + ct.triplet_bwd(*args, sig, stats, up, coeff))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)), f"{what}: two calls differ")
    pl, psig, pstats = ct.triplet_fwd_plain(*args, coeff)
    want = (pl, psig, pstats) + ct.triplet_bwd_plain(*args, psig, pstats, up, coeff)
    got = runs[0]
    loss_err = abs(float(got[0]) - float(want[0])) / max(abs(float(want[0])), 1e-30)
    errs = {name: rel_max(a, b) for name, a, b in
            zip(("sig", "stats", "g_uf", "g_ue", "g_if", "g_ie"), got[1:], want[1:])}
    check(loss_err < 2e-6 and max(errs.values()) < 1e-5,
          f"{what}: loss {loss_err:.3e}, outputs {errs} from the plain version's")
    off = ~mask
    if bool(off.any()):
        b = user.shape[0]
        kk = got[1].shape[1]
        off_i = torch.cat([off, off.repeat_interleave(kk)])
        check(not bool(got[1][off].any()) and not bool(got[3][off].any())
              and not bool(got[5][off_i].any()), f"{what}: a masked triplet has a gradient")
    log(f"[kernel] {what}: loss {loss_err:.3e}, largest output errors "
        f"{max(errs.values()):.3e} of the plain version's; bit-equal over two calls")
    return dict(loss=loss_err, **errs)


def triplet_phase(smi: str, bw: float) -> dict:
    """The fused triplet loss (``csrc/triplet_loss.cu``): small cases (d 32
    to 512; K 8, 3, 1 and (B,) negatives; repeated rows, a masked tail, every
    triplet masked) by :func:`triplet_case`, then the full-graph cells'
    shapes (``TRIPLET``: 349,184 triplets, 8 popularity negatives at d 256,
    and 1 uniform negative at d 64, over the benchmark graph's tables). At
    each cell's shape: the pair by :func:`triplet_case`, the pair timed by
    CUDA events (median of ``timed``) beside its bound (the compulsory
    bytes at the card's memory peak: each distinct table row read once, the
    indices, the mask, sig written and read, the gradient buffers written)
    and beside the per-occurrence bytes, the plain versions timed, and the
    whole loss with its gradients through autograd, fused against the
    gather route (sort, gathers, the eager loss, its backward and the same
    four row sums), both timed and their table gradients compared. One
    ``[triplet]`` JSON line."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import bpr, cuda_triplet as ct
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import TripletBatch

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    worst = 0.0
    for d in ct.DIMS:
        for k, b, masked in ((8, 1000, 100), (3, 777, 0), (None, 1200, 200), (1, 64, 64)):
            errs = triplet_case(triplet_inputs(gen, b, k, d, 50, 80, 0.75, masked),
                                f"triplet d={d} K={k} B={b} masked={masked}")
            worst = max(worst, max(errs.values()))
    out = {"card": smi, "small_cases_max_err": worst}
    for name, k, d, power in TRIPLET["cells"]:
        b = TRIPLET["batch"]
        inputs = triplet_inputs(gen, b, k, d, TRIPLET["users"], TRIPLET["items"], power,
                                masked=734)
        tabs, user, pos, neg, mask = inputs
        kk = 1 if k is None else k
        errs = triplet_case(inputs, f"triplet at the {name} cell's shape (B {b}, K {kk}, d {d})")
        args = (tabs, user, pos, neg, mask)
        up = torch.tensor(1.0, device="cuda")
        _, sig, stats = ct.triplet_fwd(*args, 5e-3)
        fwd = [time_ms(lambda: ct.triplet_fwd(*args, 5e-3), 1, 1)
               for _ in range(TRIPLET["timed"])]
        bwd = [time_ms(lambda: ct.triplet_bwd(*args, sig, stats, up, 5e-3), 1, 1)
               for _ in range(TRIPLET["timed"])]
        plain = [time_ms(lambda: ct.triplet_loss_plain(*args, 5e-3, up), 1, 0)
                 for _ in range(2)]
        fwd_ms, bwd_ms = float(np.median(fwd)), float(np.median(bwd))
        rows_u = int(torch.unique(user).numel())
        rows_i = int(torch.unique(torch.cat([pos, neg.reshape(-1)])).numel())
        row = 4 * d
        compulsory = (2 * (rows_u + rows_i) * row + 8 * b * (2 + kk) + b + 2 * 4 * b * kk
                      + 2 * b * row + 2 * b * (1 + kk) * row)
        per_occurrence = 2 * (2 * b * (kk + 2) * row) + 2 * b * (kk + 2) * row
        bound_ms = compulsory / bw * 1e3

        # the whole loss through autograd: fused against the gather route
        batch = TripletBatch(user, pos, mask)
        leaves = [t.clone().requires_grad_(True) for t in tabs]

        def fused():
            return torch.autograd.grad(
                ct.triplet_loss_fused(leaves[:2], leaves[2:], user, pos, neg, mask, 5e-3),
                leaves)

        def gathered():
            rows = bpr.triplet_rows(leaves[:2], leaves[2:], batch, neg)
            return torch.autograd.grad(bpr.triplet_loss(rows, mask, "standard", 5e-3),
                                       leaves)

        g_f, g_g = fused(), gathered()
        grad_err = max(rel_max(a, b_) for a, b_ in zip(g_f, g_g))
        check(grad_err < 1e-5, f"triplet {name}: fused table gradients {grad_err:.3e} "
              f"from the gather route's")
        torch.cuda.reset_peak_memory_stats()
        fused_ms = float(np.median([time_ms(fused, 1, 1) for _ in range(TRIPLET["timed"])]))
        fused_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gather_ms = float(np.median([time_ms(gathered, 1, 1)
                                     for _ in range(TRIPLET["timed"])]))
        gather_peak = torch.cuda.max_memory_allocated()
        out[name] = dict(errs, B=b, K=kk, d=d, distinct_users=rows_u, distinct_items=rows_i,
                         fwd_ms=fwd_ms, bwd_ms=bwd_ms, pair_ms=fwd_ms + bwd_ms,
                         compulsory_bytes=compulsory, bound_ms=bound_ms,
                         roofline=bound_ms / (fwd_ms + bwd_ms),
                         per_occurrence_bytes=per_occurrence,
                         per_occurrence_ms=per_occurrence / bw * 1e3,
                         plain_ms=float(np.median(plain)), table_grad_err=grad_err,
                         fused_autograd_ms=fused_ms, gather_autograd_ms=gather_ms,
                         fused_peak_bytes=fused_peak, gather_peak_bytes=gather_peak)
        log(f"[triplet] {name}: forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({100 * bound_ms / (fwd_ms + bwd_ms):.1f} %; per occurrence "
            f"{per_occurrence / bw * 1e3:.3f} ms); plain {out[name]['plain_ms']:.1f} ms; "
            f"through autograd with the row sums: fused {fused_ms:.3f} ms, gather route "
            f"{gather_ms:.3f} ms; table gradients {grad_err:.3e} apart")
        del inputs, tabs, leaves, g_f, g_g, sig, stats
        torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    log(f"[triplet] {json.dumps(out)}")
    return out


def scatter_long_cases(gen) -> None:
    """Phase 3, ``sorted_index_add``'s long lane (rows of more than
    ``long_run(d)`` entries): a 60,000-entry row at d 64 f32; rows of T and
    T + 1 entries at d 64 and 256; a 20,000-entry row at d 256 f32 and at d
    64 bf16; calls in which every row is long (d 100 and 30 f32: a last
    column group of 4 and 30 columns, 16- and 8-byte copies); two long rows
    side by side, then short rows with empty rows between them; 4-byte
    copies (d 33 f32), a bf16 width whose rows are copied 2 bytes at a time
    (d 33) and d 512 f32. Each bit-equal to the plain version's sequential
    sum on the host and over two calls, and the long lane's tally up by the
    long rows and entries of both calls."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_scatter as cs

    rng = np.random.default_rng(SEED + 23)
    rand = lambda rows, n: rng.integers(0, rows, n)
    cases = []   # (what, rows, d, dtype, {row: entries}, ids of further entries)
    t64, t256 = cs.long_run(64), cs.long_run(256)
    cases.append(("a 60,000-entry row", 1000, 64, torch.float32, {5: 60_000},
                  rand(1000, 12_000)))
    cases.append((f"rows of T and T + 1 entries (T = {t64})", 500, 64, torch.float32,
                  {3: t64, 4: t64 + 1, 9: t64 - 1}, rand(500, 4000)))
    cases.append((f"rows of T and T + 1 entries (T = {t256})", 500, 256, torch.float32,
                  {3: t256, 4: t256 + 1, 9: t256 - 1}, rand(500, 2000)))
    cases.append(("a 20,000-entry row", 2000, 256, torch.float32, {1999: 20_000},
                  rand(2000, 6000)))
    cases.append(("a 20,000-entry row", 2000, 64, torch.bfloat16, {0: 20_000},
                  rand(2000, 6000)))
    for d in (100, 30):
        t = cs.long_run(d)
        cases.append(("every row long", 300, d, torch.float32,
                      {r: t + 1 + int(rng.integers(0, 3 * t)) for r in range(300)},
                      rand(300, 0)))
    cases.append(("two long rows side by side, then short rows with empty rows between",
                  64, 64, torch.float32, {10: 5000, 11: 3 * t64},
                  np.repeat(np.arange(12, 64, 2), 3)))
    cases.append(("4-byte copies", 800, 33, torch.float32, {7: 9000, 8: 200},
                  rand(800, 3000)))
    cases.append(("2-byte copies", 800, 33, torch.bfloat16, {7: 9000, 8: 200},
                  rand(800, 3000)))
    cases.append(("16 column groups", 400, 512, torch.float32, {0: 3000, 399: 500},
                  rand(400, 2000)))
    for what, rows, d, dtype, long_rows, extra in cases:
        what = f"sorted_index_add long lane, {what}, d={d} {str(dtype)[6:]}"
        extra = extra[~np.isin(extra, list(long_rows))]   # the listed runs stay exact
        parts = [np.full(n, r, np.int64) for r, n in long_rows.items()] + [extra]
        idx_np = np.concatenate(parts)
        rng.shuffle(idx_np)
        idx = torch.from_numpy(idx_np.astype(np.int32)).cuda()
        x = torch.randn(idx.numel(), d, device="cuda", generator=gen).to(dtype)
        order, starts = cs.sort_rows(idx, rows)
        runs = np.bincount(idx_np, minlength=rows)
        t = cs.long_run(d)
        want = (2 * int((runs > t).sum()), 2 * int(runs[runs > t].sum()))
        before = cs.scatter_long_stats()
        out = cs.sorted_index_add(x, order, starts, rows)
        again = cs.sorted_index_add(x, order, starts, rows)
        after = cs.scatter_long_stats()
        host = cs.sorted_index_add_plain(x.cpu(), order.cpu(), starts.cpu(), rows)
        got = (after[0] - before[0], after[1] - before[1])
        check(torch.equal(out, again), f"{what}: two calls differ")
        check(torch.equal(out.cpu(), host),
              f"{what}: differs from the plain version's sequential sum on the host "
              f"(max abs {(out.cpu().float() - host.float()).abs().max().item():.3e})")
        check(not bool(out[torch.from_numpy(runs == 0).cuda()].any()),
              f"{what}: a row with no entry is not zero")
        check(got == want, f"{what}: the long lane's tally rose by {got} (rows, entries) "
              f"over two calls, expected {want}")
        log(f"[kernel] {what}: {idx.numel()} entries over {rows} rows, longest run "
            f"{int(runs.max())}, T {t}: bit-equal to the plain version on the host and "
            f"over two calls; long lane tally +{got[0]} rows, +{got[1]} entries")


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
    ``spmm_segment`` over ``coo`` where one is given (f32 within rtol 1e-3 /
    atol 1e-4: the JAX suite's bound for its kernel; the three sum the same
    f32 products in different orders), bf16 within one bf16 ulp of the
    plain version (both round an f32 sum once), each bit-equal over two
    calls; the rows of isolated nodes (``zero_rows``) zero. Returns the f32
    max abs error."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import spmm_ell, spmm_segment

    out, again = spmm_ell_cuda(ell, x), spmm_ell_cuda(ell, x)
    ref = spmm_ell(ell, x)
    seg = None if coo is None else spmm_segment(coo, x)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"ell_spmm {what} f32: two calls differ")
    check(bool((out[list(zero_rows)] == 0).all()), "an isolated node's row is not zero")
    for name, r in (("plain spmm_ell", ref), ("spmm_segment", seg)):
        if r is None:
            continue
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
    vs_seg = "" if seg is None else f", {(out - seg).abs().max().item():.3e} vs spmm_segment"
    log(f"[kernel] ell_spmm {what}: f32 max abs err {e32:.3e} vs plain{vs_seg}; bf16 max abs "
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
    return max(worst, ell_rect_cases(e, n, gen))


def ell_rect_cases(e, n: int, gen) -> float:
    """Phase 3, B4 with a source table of its own size: the edges into the
    first ``r = n // 3`` nodes, with a fifth of those rows emptied, as
    ``r`` rows read from the ``n``-row table (``num_src > num_nodes``; the
    hub's row split into segments, d 64 and 30), and its transpose, ``n``
    rows from ``r`` sources (``num_src < num_nodes``; a row of every
    source, isolated rows empty), each by :func:`ell_case`, then the
    backward of the first over the second. Padding slots point at
    ``num_src``, rows padding a bucket at ``num_nodes``. Returns the
    largest f32 abs error."""
    from movie_recommender_system_with_gnns_tpu_torch.data.graph import EllGraph, gcn_norm
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceELL

    r = n // 3
    rng = np.random.default_rng(SEED + 7)
    emptied = np.flatnonzero(rng.random(r) < 0.2)
    emptied = emptied[emptied != 0]            # the hub's row stays
    keep = (e[1] < r) & ~np.isin(e[1], emptied)
    sub, w = e[:, keep], gcn_norm(e, n)[keep]
    down = EllGraph.build(sub, r, weights=w, num_src=n)
    up = EllGraph.build(sub[::-1], n, weights=w, num_src=r)
    ell = DeviceELL.from_host(down, "cuda")
    ell_t = DeviceELL.from_host(up, "cuda")
    check(len(ell.schedule.split_rows) and len(ell_t.schedule.split_rows)
          and (ell.num_nodes, ell.num_src, ell_t.num_nodes, ell_t.num_src) == (r, n, n, r),
          "the rectangular test graphs lost their split rows or their shapes")
    worst = 0.0
    for d in (64, 30):
        x = torch.randn(n, d, device="cuda", generator=gen)
        worst = max(worst, ell_case(ell, weighted_coo(sub, n, w, rows=r), x,
                                    f"rectangular d={d}: {r} rows from {n} sources, "
                                    f"{emptied.size} emptied", zero_rows=tuple(emptied)))
    x = torch.randn(r, 64, device="cuda", generator=gen)
    no_edge = np.setdiff1d(np.arange(n), sub[0])
    worst = max(worst, ell_case(ell_t, weighted_coo(sub[::-1], r, w, rows=n), x,
                                f"rectangular transpose d=64: {n} rows from {r} sources",
                                zero_rows=tuple(no_edge)))
    x = torch.randn(n, 64, device="cuda", generator=gen)
    return max(worst, ell_backward_case(ell, ell_t, x))


def weighted_coo(e, n: int, w, rows: int = None):
    """A ``DeviceCOO`` of edges ``e`` with the weights ``w`` (dst-sorted):
    ``rows`` outputs (``n`` unless given) from a table of ``n`` rows."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceCOO

    order = np.argsort(e[1], kind="stable")
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a[order], dt)).to("cuda")
    return DeviceCOO(up(e[0], np.int32), up(e[1], np.int32), up(w, np.float32),
                     n if rows is None else rows, num_src=n)


def ell_backward_case(ell, ell_t, x) -> float:
    """The gradient of ``spmm_ell_cuda(ell, x, transpose=ell_t)`` (one launch
    forward, one over the transpose backward) against autodiff through the
    plain ``spmm_ell``: within rtol 1e-3 / atol 1e-4 as the f32 cases, and
    bit-equal over two calls. Returns the max abs error."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import spmm_ell

    cot = torch.randn(ell.num_nodes, x.shape[1], device=x.device, dtype=x.dtype)
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
    log(f"[kernel] ell_spmm backward over the transpose ({ell.num_nodes} rows from "
        f"{ell.num_src}, d={x.shape[1]}): max abs err "
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
    table read once (``num_src`` rows) and the result written once
    (``num_nodes`` rows); 2 d operations per edge. The padding
    behind a row's first padding id is not needed, so it is not counted. Also
    returns the time if every gather were charged its d·itemsize bytes, and
    the time of reading every slot, padding included."""
    slots = sum(b.nbr.numel() for b in ell.blocks)
    rows = sum(b.node_ids.numel() for b in ell.blocks)
    edges = sum(int((b.nbr != ell.num_src).sum()) for b in ell.blocks)
    ends = sum(int((b.nbr[:, -1] == ell.num_src).sum()) for b in ell.blocks)
    table_in, table_out = (k * d * itemsize for k in (ell.num_src, ell.num_nodes))
    byts = edges * 8 + ends * 4 + rows * 4 + table_in + table_out
    flops = 2.0 * d * edges
    t_bytes, t_ops = byts / bw * 1e3, flops / F32_FLOPS * 1e3
    gathered = (edges * 8 + ends * 4 + rows * 4 + edges * d * itemsize + table_out) / bw * 1e3
    all_slots = (slots * 8 + rows * 4 + table_in + table_out) / bw * 1e3
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


def scatter_case(idx, rows: int, d: int, gen, what: str, bw: float) -> dict:
    """``sorted_index_add`` (``gather_rows``' backward) at one index set
    ``idx`` over ``rows`` rows, on a random f32 cotangent of width ``d``:
    bit-equal to the plain version's sequential sum on the host and over
    two calls, within 1e-5 of the largest entry of ``index_add_`` on the
    card, and equal to ``gather_rows``' gradient; timed beside ``zeros`` +
    ``index_add_``, with its bound (bytes)."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_scatter
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_scatter import sort_rows

    order, starts = sort_rows(idx, rows)
    g_rows = torch.randn(idx.numel(), d, device="cuda", generator=gen)
    sc = lambda: cuda_scatter.sorted_index_add(g_rows, order, starts, rows)
    lib = lambda: torch.zeros(rows, d, device="cuda").index_add_(0, idx, g_rows)
    tally = cuda_scatter.scatter_long_stats()
    out_k = sc()
    long_rows, long_entries = (a - b for a, b in zip(cuda_scatter.scatter_long_stats(), tally))
    out_l = lib()
    table = torch.randn(rows, d, device="cuda", generator=gen).requires_grad_(True)
    (g_tab,) = torch.autograd.grad(cuda_scatter.gather_rows(table, idx, order, starts),
                                   table, g_rows)
    torch.cuda.synchronize()
    out_h = cuda_scatter.sorted_index_add_plain(g_rows.cpu(), order.cpu(), starts.cpu(), rows)
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
    log(f"[kernel] {what} ({idx.numel()} entries over {rows} rows, longest run {run}, "
        f"d={d}, f32): bit-equal to the plain version on the host, over two calls and "
        f"as gather_rows' gradient; max abs err vs index_add_ on the card {err:.3e} "
        f"(largest entry {top:.3e}); {k_ms:.4f} ms by CUDA events, zeros + index_add_ "
        f"{l_ms:.4f} ms, bound {byts / bw * 1e3:.4f} ms (bytes: {byts / 1e6:.1f} MB); "
        f"long lane {long_rows} rows, {long_entries / idx.numel():.4f} of the entries")
    return dict(entries=idx.numel(), rows=rows, longest_run=run, ms=k_ms, index_add_ms=l_ms,
                bound_ms=byts / bw * 1e3, max_abs_err=err, long_rows=long_rows,
                long_share=long_entries / idx.numel())


def f64_step_reference(params, coo, tb, neg, cfg, chunks: int):
    """``(loss, (g_user, g_item))`` of ``compute_loss`` on a symmetric graph,
    in float64 by plain PyTorch: each hop an ``index_add_`` over ``coo``'s
    edges in 16 slices; the triplet loss in ``chunks`` chunks, each weighted
    by its real triplets (exact in any precision), its rows gathered by
    ``index_select``; the propagation's adjoint Σ_l Â^l applied to the
    finals' cotangent (Â = Âᵀ)."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import select_bpr_loss

    src, dst, w = coo.src.long(), coo.dst.long(), coo.w.double()
    step = -(-src.numel() // 16)

    def hop(x):
        out = torch.zeros_like(x)
        for s in range(0, src.numel(), step):
            out.index_add_(0, dst[s:s + step],
                           x.index_select(0, src[s:s + step]) * w[s:s + step, None])
        return out

    layers, k1 = cfg.model.num_layers, cfg.model.num_layers + 1
    scale = 1.0 / (k1 * k1) if cfg.model.readout == "reference" else 1.0 / k1
    nu, d = params.user_emb.shape
    x = torch.cat(list(params)).double()
    acc, cur = x, x
    for _ in range(layers):
        cur = hop(cur)
        acc = acc + cur
    final = acc * scale
    uf, itf = (t.detach().requires_grad_(True) for t in (final[:nu], final[nu:]))
    ue, ie = (t.double().requires_grad_(True) for t in params)
    loss_fn = select_bpr_loss(cfg.train.loss)
    total = tb.mask.sum().double().clamp_min(1.0)
    bc = tb.user.shape[0] // chunks
    lsum = 0.0
    for c in range(chunks):
        sl = slice(c * bc, (c + 1) * bc)
        u, p, m, n_ = tb.user[sl], tb.pos_item[sl], tb.mask[sl], neg[sl]
        rows = lambda t, i: t.index_select(0, i.reshape(-1)).view(*i.shape, d)
        l = loss_fn(rows(uf, u), rows(ue, u), rows(itf, p), rows(ie, p), rows(itf, n_),
                    rows(ie, n_), cfg.train.bpr_coeff, mask=m)
        w_c = m.sum().double()
        (l * w_c / total).backward()
        lsum = lsum + l.detach() * w_c
    g = torch.cat([uf.grad, itf.grad]) * scale
    gacc, cur = g, g
    for _ in range(layers):
        cur = hop(cur)
        gacc = gacc + cur
    return (lsum / total).item(), (gacc[:nu] + ue.grad, gacc[nu:] + ie.grad)


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
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_spmm
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
        AdamState, TrainState, compute_loss, compute_loss_grads_microbatched,
        create_train_state, epoch_generator, loss_and_grads, train_model)

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
    # 3b. the microbatched loss (16 chunks) and the one-batch step, both held
    # against the same step in float64 (plain PyTorch), with f32 blocks so
    # that no cotangent is rounded to bf16. Both f32 steps sum each table
    # row's triplets in sequence (sorted_index_add): the batch here holds the
    # first positives, grouped by user, so a heavy user's rows form runs of
    # hundreds of equal terms, whose f32 sum drifts by about n·2^-24 of
    # itself. The check: the chunks' loss within 1e-5 relative of the
    # float64 loss, and their gradients no farther from float64 than the
    # one-batch step's, plus 1e-5 of the largest entry
    chunks = FG_MICRO["chunks"]
    l_m, g_m = compute_loss_grads_microbatched(state0.params, h32, tb, neg, cfg,
                                               spmm_hybrid_sym, chunks)
    l_64, g_64 = f64_step_reference(state0.params, coo, tb, neg, cfg, chunks)
    top = [g.abs().max().item() for g in g_64]
    over = lambda gs: [(g.double() - r).abs().max().item() / t
                       for g, r, t in zip(gs, g_64, top)]
    micro = dict(card=smi, chunks=chunks, batch=b, d256_loss_f64=l_64,
                 d256_loss_rel_err=abs(l_m.item() - l_64) / abs(l_64),
                 d256_loss_one_batch_rel_err=abs(l_h.item() - l_64) / abs(l_64),
                 d256_grad_err_over_max=over(g_m), d256_one_batch_grad_err_over_max=over(g_h),
                 d256_micro_vs_one_batch_over_max=[
                     (gm - gh).abs().max().item() / t for gm, gh, t in zip(g_m, g_h, top)])
    log(f"[fullgraph] compute_loss_grads_microbatched, {chunks} chunks of {b // chunks} "
        f"triplets (f32 blocks, d={d}) vs the float64 step: loss rel err "
        f"{micro['d256_loss_rel_err']:.3e}, gradient errs over their largest entry user "
        f"{micro['d256_grad_err_over_max'][0]:.3e}, item "
        f"{micro['d256_grad_err_over_max'][1]:.3e}; the one-batch f32 step's "
        f"{micro['d256_one_batch_grad_err_over_max'][0]:.3e}, "
        f"{micro['d256_one_batch_grad_err_over_max'][1]:.3e} (loss "
        f"{micro['d256_loss_one_batch_rel_err']:.3e}); microbatched vs one-batch "
        f"{micro['d256_micro_vs_one_batch_over_max'][0]:.3e}, "
        f"{micro['d256_micro_vs_one_batch_over_max'][1]:.3e}")
    check(micro["d256_loss_rel_err"] <= 1e-5 and all(
        m <= o + 1e-5 for m, o in zip(micro["d256_grad_err_over_max"],
                                      micro["d256_one_batch_grad_err_over_max"])),
          f"microbatched loss ({chunks} chunks) at d={d} vs the float64 step: loss rel err "
          f"{micro['d256_loss_rel_err']:.3e}, gradient errs over their largest entry "
          f"{micro['d256_grad_err_over_max']} against the one-batch step's "
          f"{micro['d256_one_batch_grad_err_over_max']} + 1e-5")
    del g_h, g_s, g_m, g_64, h32, coo, ref, x

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

    # 5a. the microbatched step (bf16 blocks, the trainer's) twice from the same
    # state and draws: bit-equal, one propagation and one backward through B4
    cfg_m = cfg.replace(train=dataclasses.replace(cfg.train, loss_microbatches=chunks))
    fn1m = fullgraph.make_fullgraph_epoch_fn(cfg_m, one)
    before = dict(launches)
    runs = [fn1m(copy(state0), one, torch.Generator(device="cuda").manual_seed(SEED + 9))
            for _ in range(2)]
    torch.cuda.synchronize()
    per_step_m = {k: (launches[k] - before.get(k, 0)) // 2 for k in launches}
    (a, lm1), (c, lm2) = runs
    same = [torch.equal(u, v) for u, v in zip(a.params + a.opt_state.mu + a.opt_state.nu,
                                              c.params + c.opt_state.mu + c.opt_state.nu)]
    check(all(same) and lm1 == lm2, f"a microbatched full-graph step is not bit-equal over "
          f"two runs (params and moments equal: {same}, losses {lm1!r} {lm2!r})")
    check(per_step_m.get("ell_spmm", 0) == 2 * layers,
          f"a microbatched step launched {per_step_m.get('ell_spmm', 0)} ell_spmm kernels, "
          f"expected {2 * layers} ({layers} hops forward, {layers} backward)")
    check(per_step_m.get("sorted_index_add", 0) == 4 * chunks,
          f"a microbatched step launched {per_step_m.get('sorted_index_add', 0)} "
          f"sorted_index_add kernels, expected {4 * chunks} (four per chunk)")
    check(abs(lm1 - la) <= 1e-5 * abs(la), f"the microbatched step's loss {lm1!r} vs the "
          f"one-batch step's {la!r} from the same draws")
    micro.update(step_bit_equal=True, launches_per_step=per_step_m,
                 step_loss=lm1, step_loss_one_batch=la)
    log(f"[fullgraph] one microbatched step ({chunks} chunks, bf16 blocks) run twice: "
        f"parameters and Adam moments bit-equal, loss {lm1:.7f} (one batch {la:.7f}); "
        f"kernel launches per step {per_step_m}")
    del runs, a, c

    # 5b. the full width of runs/ml25m_fg150_k8_d512_pop.log, one batch and
    # in 16 chunks: a step's time by CUDA events and its peak memory
    d5 = FG_MICRO["dim"]
    cfg5 = cfg.replace(model=dataclasses.replace(cfg.model, dim=d5))
    st5 = create_train_state(cfg5, nu, ni, generator=torch.Generator().manual_seed(SEED),
                             device="cuda")
    for label, m in (("one_batch", 0), ("micro", chunks)):
        fn5 = fullgraph.make_fullgraph_epoch_fn(
            cfg5.replace(train=dataclasses.replace(cfg5.train, loss_microbatches=m)), one)
        gen5 = torch.Generator(device="cuda").manual_seed(SEED + 12)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        before = launches["ell_spmm"]
        times, losses = [], []
        for _ in range(1 + FG_MICRO["timed"]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            st5, loss5 = fn5(st5, one, gen5)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(loss5)
        b4_steps = launches["ell_spmm"] - before
        steady = sorted(times[1:])
        micro[f"d512_{label}"] = dict(
            step_ms=steady[len(steady) // 2], step_ms_all=times,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / 1e9,
            resident_gb=resident / 1e9, losses=losses,
            b4_launches_per_step=b4_steps / len(times))
        check(all(np.isfinite(v) for v in losses), f"d={d5} {label} step: a loss is not finite")
        check(b4_steps == 2 * layers * len(times), f"d={d5} {label}: {b4_steps} ell_spmm "
              f"launches in {len(times)} steps, expected {2 * layers} a step")
        log(f"[fullgraph] d={d5}, {label} ({m or 1} chunk{'s' if m else ''}): "
            f"{micro[f'd512_{label}']['step_ms']:.3f} ms a step (median of "
            f"{FG_MICRO['timed']} by CUDA events, all {[round(t, 3) for t in times]}), peak "
            f"{micro[f'd512_{label}']['peak_gb']:.2f} GB "
            f"({micro[f'd512_{label}']['peak_over_resident_gb']:.2f} over the resident "
            f"{resident / 1e9:.2f}); losses {losses}")
    micro["d512_time_ratio"] = micro["d512_micro"]["step_ms"] / micro["d512_one_batch"]["step_ms"]
    del st5, fn5
    torch.cuda.empty_cache()

    # 5b. sorted_index_add (gather_rows' backward) at one step's index sets:
    # the users, and the positives with the popularity negatives, d = 256 f32
    perm = torch.randperm(fg.e_real, generator=gen, device="cuda")[:b]
    step_u = fg.user[perm]
    step_i = torch.cat([fg.pos_item[perm],
                        sample_negative_alias(gen, b, ni, *fg.alias_table,
                                              num=FG["negatives"]).reshape(-1)])
    scatter = {side: scatter_case(idx, rows, d, gen, f"sorted_index_add at a full-graph "
                                  f"step's {side}", bw)
               for side, idx, rows in (("users", step_u, nu), ("items", step_i, ni))}
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
    # B4 at the microbatched step's width (d = 512) over the same remainder
    torch.cuda.empty_cache()
    x5 = torch.randn(n, FG_MICRO["dim"], device="cuda", generator=gen)
    micro["b4_d512_max_abs_err"] = ell_case(
        off, weighted_coo(np.stack([src[~intra], dst[~intra]]), n, w_off), x5,
        f"at the full-graph remainder, d={FG_MICRO['dim']} (the microbatched step's width)")
    micro["b4_d512_hop_ms"] = time_ms(lambda: spmm_ell_cuda(off, x5), 10)
    del x5
    torch.cuda.empty_cache()
    log(f"[fullgraph-micro] {json.dumps(micro)}")
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
        fullgraph_max_abs_err=r_err,
        launches_per_microbatched_step=micro["launches_per_step"].get("ell_spmm", 0),
        fullgraph_d512_max_abs_err=micro["b4_d512_max_abs_err"],
        fullgraph_d512_hop_ms=micro["b4_d512_hop_ms"])
    del state, state0, bundle, emb
    return dict(cfg=cfg, fg=fg, val=val, test=test, train_e=train_e)


#: phase 5g: the clusters whose corrected loss is held against the
#: full-graph loss, and the steps of its profiled window
CORR = dict(loss_clusters=10, window=10)


def induction_bound(cc_x, c: int, rows: list, corr_c, gamma: float, bf16: bool):
    """The elementwise bound on |corrected local accumulator − full-graph
    accumulator| of cluster ``c`` at the tables its correction was built from
    (``rows[l]``: the full-graph layer l at the cluster's nodes, f32).

    With u = 2^-24, H(v) = ``_one_hop(v)`` for v ≥ 0 (Â_c ≥ 0), and γ =
    k·u/(1 − k·u) for k one more than the most nonzeros in a row of Â_c (each
    of the two sums H̃(ŷ), H̃(x̂) lies within γ·H(|x̂|) of its exact value):
    y_0 = x_0 exactly, and y_{l+1} = fl(H̃(ŷ_l) + fl(x_{l+1} − H̃(x̂_l))),
    the error of (a − b) + b, so |y_{l+1} − x_{l+1}| ≤ E_{l+1} =
    f·H(D_l) + 2γ·f·H(|x_l|) + 2u·(|corr_l| + |x_{l+1}|), where D_l bounds
    |ŷ_l − x̂_l|: E_l on the f32 segment path; on bf16 blocks E_l + 2^-7·(|x_l|
    + E_l) wherever E_l > 0 (values an f32 ulp apart can round to
    neighbouring bf16 values); f = 1 + γ, times 1 + 2^-7 on bf16 blocks (H
    rounds its operand to bf16). Both accumulators add the L + 1 layers in
    the same order: Σ_{l≥1} E_l + 2u·L·Σ_l |x_l|."""
    from movie_recommender_system_with_gnns_tpu_torch.training.compact import _one_hop

    u = 2.0 ** -24
    n_local = cc_x.u_pad + cc_x.i_pad
    adj, lists = None if cc_x.adj is None else cc_x.adj[c], cc_x.lists(c)
    f = (1 + gamma) * ((1 + 2.0 ** -7) if bf16 else 1.0)
    hop = lambda v: _one_hop(v, cc_x.src[c], cc_x.dst[c], cc_x.w[c], adj, n_local,
                             lists).float()
    err = torch.zeros_like(rows[0])
    total = torch.zeros_like(rows[0])
    for layer in range(len(rows) - 1):
        x_l = rows[layer].abs()
        dd = err + 2.0 ** -7 * (x_l + err) * (err > 0) if bf16 else err
        err = (f * hop(dd) + 2 * gamma * f * hop(x_l)
               + 2 * u * (corr_c[layer].abs() + rows[layer + 1].abs()))
        total += err
    return total + 2 * u * (len(rows) - 1) * sum(r.abs() for r in rows)


def induction_check(label: str, cc_x, corr, params, xs: list) -> dict:
    """Phase 5g (2): every cluster's corrected ``_propagate_local`` at the
    tables of ``xs`` (the full-graph layers) against the full-graph
    accumulator on the cluster's nodes, padding rows included, within
    :func:`induction_bound`; the uncorrected propagation's distance beside
    it. One host sync at the end."""
    from movie_recommender_system_with_gnns_tpu_torch.training.compact import (
        _propagate_local)

    nu = params.user_emb.shape[0]
    k, n_local = cc_x.num_clusters, cc_x.u_pad + cc_x.i_pad
    layers = len(xs) - 1
    acc_full = sum(xs[1:], xs[0])
    live = cc_x.w > 0
    key = (torch.arange(k, device=live.device)[:, None] * n_local + cc_x.dst.long())[live]
    kmax = int(torch.bincount(key).max()) + 1
    gamma = kmax * 2.0 ** -24 / (1 - kmax * 2.0 ** -24)
    bf16 = cc_x.adj is not None and cc_x.adj.dtype == torch.bfloat16
    worst = torch.zeros(4, device=live.device)   # err, err / bound, uncorrected, beyond
    for c in range(k):
        ids = torch.cat([cc_x.user_ids[c], cc_x.item_ids[c] + nu])
        rows = [x.index_select(0, ids) for x in xs]
        emb = torch.cat([params.user_emb.index_select(0, cc_x.user_ids[c]),
                         params.item_emb.index_select(0, cc_x.item_ids[c])])
        hop = (emb, cc_x.src[c], cc_x.dst[c], cc_x.w[c],
               None if cc_x.adj is None else cc_x.adj[c], layers, n_local)
        err = (_propagate_local(*hop, corr=corr[c], lists=cc_x.lists(c))
               - acc_full.index_select(0, ids)).abs()
        bound = induction_bound(cc_x, c, rows, corr[c], gamma, bf16)
        plain = (_propagate_local(*hop, lists=cc_x.lists(c))
                 - acc_full.index_select(0, ids)).abs().max()
        worst = torch.maximum(worst, torch.stack([
            err.max(), (err / bound.clamp_min(1e-30)).max(), plain,
            (err > bound).sum().float()]))
    err, ratio, plain, beyond = worst.tolist()
    out = dict(max_abs_err=err, max_err_over_bound=ratio, uncorrected_max_abs_err=plain,
               entries_beyond_bound=int(beyond), k_row=kmax, bf16_blocks=bf16,
               acc_max=acc_full.abs().max().item())
    check(beyond == 0, f"induction on the {label} path: {int(beyond)} entries of a "
          f"cluster's corrected accumulator beyond the bound (max err {err:.3e}, "
          f"err / bound {ratio:.3e})")
    check(plain > 100 * err, f"induction on the {label} path: the uncorrected "
          f"propagation is only {plain:.3e} from the full graph (corrected {err:.3e})")
    log(f"[correction] induction on the {label} path ({k} clusters, n_local {n_local}, "
        f"rows of at most {kmax - 1} nonzeros{', bf16 blocks' if bf16 else ''}): max abs "
        f"err {err:.3e} of accumulators up to {out['acc_max']:.3e}, at most {ratio:.3e} of "
        f"the derived bound; uncorrected {plain:.3e}")
    return out


def correction_phase(data, train_e, cfg, cc, cc_seg, state, copy, smi: str, bw: float,
                     b4_row: dict) -> dict:
    """Phase 5g: the compact trainer's frozen boundary correction on
    ``train-compact-full``'s configuration (the clusters of phase 5, dense
    bf16 blocks, d = 64, ``fused_bpr=True``) and a ``HybridGraph`` over the
    same train edges (100 hybrid parts), built as ``examples/train_bridge.py``
    builds it (``build_fullgraph_data``), from phase 5's trained tables. (1)
    the build:
    wall time cold and warm (bit-equal), 3 B4 launches, shapes and bytes, B4
    against its plain version at this remainder; (2) the induction at frozen
    tables on every cluster, on the dense bf16 path and on the segment path,
    within :func:`induction_bound`; (3) the corrected cluster loss against
    the full-graph loss of the same triplets (rtol 2e-4) and closer to it
    than the uncorrected loss; (4) a corrected epoch under Adam and under
    ``hybrid_adam`` with ``fused_bpr=True``: JAX's warning once, no B1 launch
    (counted and in the profiler's trace), bit-equal over two runs, timed
    beside the uncorrected epoch; (5) one bridge cycle under ``hybrid_adam``:
    two corrected epochs, a full-graph refresh epoch through
    ``lazy_state_to_optax`` / ``lazy_state_from_optax``, a rebuilt
    correction, one more corrected epoch."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from movie_recommender_system_with_gnns_tpu_torch.data.graph import gcn_norm
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
        forward_half, partition_assignments)
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import (
        TripletBatch, sample_negative)
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import spmm_ell, spmm_hybrid
    from movie_recommender_system_with_gnns_tpu_torch.training import compact
    from movie_recommender_system_with_gnns_tpu_torch.training.fullgraph import (
        build_fullgraph_data, make_fullgraph_epoch_fn)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        TrainState, compute_loss)

    t_phase = time.time()
    nu, ni = data.num_users, data.num_items
    n, layers, d = nu + ni, cfg.model.num_layers, cfg.model.dim
    k, width = cc.num_clusters, cc.user_local.shape[1]
    numbers = dict(card=smi)

    # the full-graph data over the same train edges, as the bridge builds it;
    # the edge split's train graph is asymmetric, so no symmetric VJP: the
    # refresh epoch differentiates through B4 over the remainder's transpose
    cfg_f = cfg.replace(train=dataclasses.replace(
        cfg.train, trainer="fullgraph", fullgraph_steps=FG["steps"], symmetric_vjp=False))
    t0 = time.time()
    fg = build_fullgraph_data(cfg_f, train_e, nu, n, device="cuda")
    torch.cuda.synchronize()
    numbers["fullgraph_data_s"] = time.time() - t0
    check(fg.hybrid.off_ell is not None and fg.hybrid.off_ell_t is not None,
          "the correction's hybrid graph has no ELL remainder or no transpose")

    # (1) the build, from phase 5's trained tables
    params = copy(state).params
    launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corr, neg_rest = compact.build_boundary_correction(params, fg.hybrid, cc, cfg, nu)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    built = dict(launches)
    t0 = time.perf_counter()
    corr2, rest2 = compact.build_boundary_correction(params, fg.hybrid, cc, cfg, nu)
    torch.cuda.synchronize()
    t_build2 = time.perf_counter() - t0
    n_local = cc.u_pad + cc.i_pad
    check(tuple(corr.shape) == (k, layers, n_local, d) and tuple(neg_rest.shape) == (ni, d)
          and corr.dtype == neg_rest.dtype == torch.float32,
          f"correction shapes {tuple(corr.shape)}, {tuple(neg_rest.shape)}")
    check(built.get("ell_spmm", 0) == layers and not built.get("bpr_tile"),
          f"the correction build launched {built}: expected {layers} ell_spmm (one a hop "
          f"over the remainder) and no bpr_tile")
    check(bool(torch.isfinite(corr).all()) and bool(torch.isfinite(neg_rest).all()),
          "the correction is not finite")
    check(torch.equal(corr, corr2) and torch.equal(neg_rest, rest2),
          "two builds of the correction from the same tables differ")
    del corr2, rest2
    numbers.update(build_s=t_build, build_warm_s=t_build2, build_launches=built,
                   corr_shape=list(corr.shape), corr_gb=corr.numel() * 4 / 1e9,
                   neg_rest_shape=list(neg_rest.shape), corr_max=corr.abs().max().item())
    log(f"[correction] build_boundary_correction: corr {tuple(corr.shape)} f32 "
        f"({numbers['corr_gb']:.3f} GB), neg_rest {tuple(neg_rest.shape)}, {t_build:.3f} s "
        f"({t_build2:.3f} s warm, bit-equal); launches {built}; full-graph data "
        f"{numbers['fullgraph_data_s']:.1f} s on the host")

    # B4 at this remainder against its plain version, timed
    off = fg.hybrid.off_ell
    pu, pi = partition_assignments(train_e, nu, n, cfg.train.num_clusters,
                                   seed=cfg.data.split_seed,
                                   balance_tol=cfg.train.partition_balance_tol,
                                   uv=forward_half(train_e, nu))
    node_part = np.concatenate([pu, pi])
    src, dst = train_e[0].astype(np.int64), train_e[1].astype(np.int64)
    intra = node_part[src] == node_part[dst]
    w_off = gcn_norm(train_e, n)[~intra]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    emb = torch.cat(list(params))
    b4_err = ell_case(off, weighted_coo(np.stack([src[~intra], dst[~intra]]), n, w_off),
                      torch.randn(n, d, device="cuda", generator=gen),
                      "at the correction's remainder (the edge split's train graph)")
    hop_ms = time_ms(lambda: spmm_ell_cuda(off, emb), 20)
    hop_plain = time_ms(lambda: spmm_ell(off, emb), 3, warmup=1)
    rows_o = np.argsort(dst[~intra], kind="stable")
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(dst[~intra], minlength=n))])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(rowptr.astype(np.int32)).to("cuda"),
        torch.from_numpy(src[~intra][rows_o].astype(np.int32)).to("cuda"),
        torch.from_numpy(w_off[rows_o]).to("cuda"), size=(n, n))
    hop_lib = time_ms(lambda: torch.sparse.mm(csr, emb), 20)
    hop_bound, hop_by, byts, _, slots, edges, _, _ = ell_bound(off, d, 4, bw)
    check(edges == int((~intra).sum()), f"the remainder ELL holds {edges} edges, the "
          f"partition leaves {int((~intra).sum())} off its blocks")
    del csr
    numbers.update(remainder_edges=edges, remainder_slots=slots, b4_hop_ms=hop_ms,
                   b4_plain_ms=hop_plain, b4_sparse_mm_ms=hop_lib, b4_bound_ms=hop_bound,
                   b4_bound_by=hop_by, b4_max_abs_err=b4_err,
                   intra_retention=float(intra.mean()))
    log(f"[kernel] ell_spmm at the correction's remainder ({n} nodes, {edges} edges in "
        f"{slots} slots, d={d}, f32): {hop_ms:.4f} ms a hop by CUDA events, plain "
        f"{hop_plain:.4f} ms, torch.sparse.mm (CSR) {hop_lib:.4f} ms, bound "
        f"{hop_bound:.4f} ms ({hop_by}: {byts / 1e6:.1f} MB); max abs err vs plain "
        f"{b4_err:.3e}")

    # (2) the induction at frozen tables: the full-graph layers as the build
    # made them (their sum is neg_rest, bit for bit), then every cluster
    xs = [emb]
    for _ in range(layers):
        xs.append(spmm_hybrid(fg.hybrid, xs[-1]))
    check(torch.equal(sum(xs[2:], xs[1])[nu:], neg_rest), "the full-graph layers "
          "recomputed here do not sum to build_boundary_correction's neg_rest bit for "
          "bit")
    numbers["induction_dense"] = induction_check("dense bf16", cc, corr, params, xs)
    corr_seg, _ = compact.build_boundary_correction(params, fg.hybrid, cc_seg, cfg, nu)
    numbers["induction_segment"] = induction_check("segment", cc_seg, corr_seg, params, xs)
    del corr_seg, xs

    # (3) the corrected cluster loss at frozen tables against the full-graph
    # loss of the same triplets (the propagation the correction comes from)
    losses = []
    with torch.no_grad():
        for c in range(CORR["loss_clusters"]):
            tb = TripletBatch(cc.user_ids[c].index_select(0, cc.user_local[c]),
                              cc.item_ids[c].index_select(0, cc.pos_local[c]), cc.mask[c])
            neg = sample_negative(gen, width, ni, device="cuda")
            args = (params, cc.cluster(c), neg, cfg, cc.u_pad, cc.i_pad,
                    None if cc.adj is None else cc.adj[c], cc.lists(c))
            losses.append([compute_loss(params, fg.hybrid, tb, neg, cfg, spmm_hybrid).item(),
                           compact.compact_cluster_loss(*args).item(),
                           compact.compact_cluster_loss(*args, corr=corr[c],
                                                        neg_rest=neg_rest).item()])
    full, plain, corrected = (np.array(v) for v in zip(*losses))
    rel = np.abs(corrected - full) / np.abs(full)
    check(bool((np.abs(corrected - full) <= 2e-4 * np.abs(full) + 1e-6).all()),
          f"corrected cluster losses {corrected.tolist()} vs full-graph {full.tolist()}: "
          f"beyond rtol 2e-4")
    check(np.abs(corrected - full).sum() < np.abs(plain - full).sum(),
          "the corrected losses are not closer to the full-graph losses than the "
          "uncorrected ones")
    numbers["loss"] = dict(clusters=CORR["loss_clusters"], full=full.tolist(),
                           uncorrected=plain.tolist(), corrected=corrected.tolist(),
                           corrected_max_rel=float(rel.max()),
                           uncorrected_max_rel=float((np.abs(plain - full) / np.abs(full)).max()))
    log(f"[correction] cluster losses at frozen tables ({CORR['loss_clusters']} "
        f"clusters): corrected within {rel.max():.3e} relative of the full-graph loss, "
        f"uncorrected up to {numbers['loss']['uncorrected_max_rel']:.3e}")

    # (4) corrected epochs with fused_bpr=True: the row route, never B1
    cc_corr = cc.with_correction(corr, neg_rest)
    perm = torch.randperm(k, generator=gen, device="cuda")
    negs = sample_negative(gen, k * width, ni, device="cuda").view(k, width)
    start = lambda opt: (copy(state) if opt == "adam" else TrainState(
        *(lambda s: (s.params, compact.lazy_state_from_optax(s.opt_state), s.step))(
            copy(state))))
    epochs = {}
    for opt in ("adam", "hybrid_adam"):
        fn = compact.make_compact_epoch_fn(
            cfg.replace(train=dataclasses.replace(cfg.train, optimizer=opt)))
        st0 = start(opt)
        launches.clear()
        runs = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, loss = fn(copy(st0), cc_corr, None, perm=perm, neg=negs)
                torch.cuda.synchronize()
                runs.append((st, loss, time.perf_counter() - t0))
        got = dict(launches)
        said = [str(w.message) for w in caught]
        check(said == [compact.FUSED_CORRECTION_WARNING], f"{opt}: a corrected fused_bpr "
              f"epoch fn warned {said}, expected JAX's words once")
        check(not got.get("bpr_tile") and got.get("sorted_index_add", 0) > 0,
              f"{opt}: the corrected epochs launched {got}: expected no bpr_tile")
        same = states_equal(runs[0][0], runs[1][0])
        check(all(same) and runs[0][1] == runs[1][1] and np.isfinite(runs[0][1]),
              f"{opt}: a corrected epoch is not bit-equal over two runs ({same}, losses "
              f"{runs[0][1]!r} {runs[1][1]!r})")
        launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss_u = fn(copy(st0), cc, None, perm=perm, neg=negs)
        torch.cuda.synchronize()
        t_u = time.perf_counter() - t0
        check(launches.get("bpr_tile", 0) == k, f"{opt}: the uncorrected epoch launched "
              f"{launches.get('bpr_tile', 0)} bpr_tile kernels, expected {k}")
        box = [copy(st0)]
        fn(box[0], cc_corr, None, perm=perm[:CORR["window"]], neg=negs[:CORR["window"]])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(box[0], cc_corr, None, perm=perm[:CORR["window"]], neg=negs[:CORR["window"]])
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        b1_traced = sum(e.count for e in dev if "bpr_pass" in e.key)
        traced = sum(e.count for e in dev)
        check(b1_traced == 0 and traced > 0, f"{opt}: the profiler traced {b1_traced} B1 "
              f"kernels among {traced} in {CORR['window']} corrected steps")
        epochs[opt] = dict(
            loss=runs[0][1], loss_uncorrected=loss_u, epoch_s=[r[2] for r in runs],
            step_ms=1e3 * runs[1][2] / k, step_ms_uncorrected=1e3 * t_u / k,
            launches=got, b1_kernels_traced=b1_traced,
            kernels_traced_per_step=traced / CORR["window"])
        log(f"[correction] {opt}, fused_bpr=True, corrected epoch: JAX's warning once, "
            f"0 bpr_tile launches (0 B1 kernels among {traced} traced in "
            f"{CORR['window']} steps), bit-equal over two runs, loss {runs[0][1]:.6f} "
            f"(uncorrected {loss_u:.6f}); {epochs[opt]['step_ms']:.3f} ms a step "
            f"(uncorrected, through B1: {epochs[opt]['step_ms_uncorrected']:.3f} ms)")
        del runs, box
    numbers["epochs"] = epochs

    # (5) one bridge cycle under hybrid_adam: two corrected epochs, a
    # full-graph refresh through the Adam relabelling, a rebuilt correction,
    # one more corrected epoch
    fn_c = compact.make_compact_epoch_fn(
        cfg.replace(train=dataclasses.replace(cfg.train, optimizer="hybrid_adam")))
    fn_f = make_fullgraph_epoch_fn(cfg_f, fg)
    st = start("hybrid_adam")
    count0 = st.opt_state.count
    cycle = []
    launches.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            st, loss = fn_c(st, cc_corr, gen)
            cycle.append(("compact", loss))
        lz = st.opt_state
        adam = compact.lazy_state_to_optax(lz)
        check(all(a is b for a, b in zip(adam.mu + adam.nu, lz.mu + lz.nu))
              and adam.count == lz.count == count0 + 2 * k,
              "lazy_state_to_optax did not carry the hybrid moments and count")
        fst, loss = fn_f(TrainState(st.params, adam, st.step), fg, gen)
        cycle.append(("fullgraph", loss))
        back = compact.lazy_state_from_optax(fst.opt_state)
        check(all(a is b for a, b in zip(back.mu + back.nu, lz.mu + lz.nu))
              and back.count == count0 + 2 * k + fg.num_steps,
              "lazy_state_from_optax did not carry the refreshed moments and count back")
        st = TrainState(fst.params, back, fst.step)
        corr_b, rest_b = compact.build_boundary_correction(st.params, fg.hybrid, cc, cfg, nu)
        check(not torch.equal(corr_b, corr), "the rebuilt correction equals the first one")
        st, loss = fn_c(st, cc.with_correction(corr_b, rest_b), gen)
        cycle.append(("compact", loss))
    torch.cuda.synchronize()
    got = dict(launches)
    check(all(np.isfinite(v) for _, v in cycle), f"a bridge-cycle loss is not finite: {cycle}")
    check(st.opt_state.count == count0 + 3 * k + fg.num_steps,
          f"the bridge cycle's count {st.opt_state.count}")
    check(got.get("ell_spmm", 0) == 2 * layers * fg.num_steps + layers
          and not got.get("bpr_tile"), f"the bridge cycle launched {got}: expected "
          f"{2 * layers} ell_spmm a refresh step and {layers} for the rebuild, no bpr_tile")
    numbers["bridge_cycle"] = dict(losses=cycle, launches=got, refresh_steps=fg.num_steps)
    log(f"[correction] bridge cycle (hybrid_adam): losses {cycle}; the moments carried "
        f"through lazy_state_to_optax / lazy_state_from_optax by reference; launches {got}")

    numbers["phase_s"] = time.time() - t_phase
    log(f"[correction] {json.dumps(numbers)}")
    b4_row.update(launches=b4_row["launches"] + built.get("ell_spmm", 0),
                  launches_correction_build=built.get("ell_spmm", 0), correction_hop_ms=hop_ms,
                  correction_plain_ms=hop_plain, correction_bound_ms=hop_bound,
                  correction_bound_by=hop_by, correction_library_ms=hop_lib,
                  correction_max_abs_err=b4_err)
    del fg, corr, neg_rest, cc_corr, corr_b, rest_b, st, fst, params, emb
    torch.cuda.empty_cache()
    return numbers


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


#: phase 5h: the full-node trainer as bench.py's bench_tpu_epoch(trainer="full")
#: builds it: phase 5's native clusters bucketed from 4,096 edges, L = 3,
#: d = 64, Adam; the clusters of the cosine check, the profiles and the
#: recovery, and the cosine check's warm-up steps
FULLNODE = dict(bucket_floor=4096, layers=3, epochs=2, sub=10, warmup=4)


def fullnode_phase(data, parts, val, test, copy, smi: str, bw: float) -> dict:
    """Phase 5h: ``train-fullnode-full``, the full-node trainer's fused epoch
    (``make_epoch_fn``: the step captured once as a CUDA graph, replayed per
    cluster) on ``build_cluster_batches(parts, ..., bucket_floor=4096)`` of
    phase 5's native clusters, stacked on the card (``StackedClusters``),
    L = 3, d = 64, Adam. (a) ``train_model`` for 2 epochs through the
    fused epoch: falling losses, ``sorted_index_add`` counted at the warm-up
    step and the capture only (the second epoch replays the first's graph);
    (b) the captured epoch against the eager body's (``_eager_epoch_fn``)
    from the same state and generator: tables, both moments, loss, count and
    step ``torch.equal``, the generators left in one state, the val evals
    after both routes equal; under constant lr on every cluster (both epochs
    timed) and under cosine lr through its warm-up on the first
    ``FULLNODE["sub"]`` clusters; (c) the eager body's steps with host syncs
    made errors, then one eager epoch over the sub-stack with every scatter
    launch seen and its widest call at each shape kept (:class:`HeldCalls`),
    each kept call held against its plain version (:func:`hold_kept`); (d)
    the captured epoch replayed on every cluster, timed,
    and each route profiled over the sub-stack's steps: idle share, kernels
    a step; peak memory; (e) a 3-epoch run over the sub-stack's clusters
    recovered from drops after epochs 0 and 1 ``torch.equal`` to the
    uninterrupted run; one ``[fullnode]`` JSON line. The sub-stack keeps
    the phase near a minute: a step at this bucket takes about 79 ms.
    ``copy`` clones a state's tables and moments; ``bw`` is the card's
    memory rate for the holds' bounds."""
    from movie_recommender_system_with_gnns_tpu_torch.config import (
        Config, ModelConfig, TrainConfig)
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.training import train
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
        build_cluster_batches)

    t_phase = time.time()
    nu, ni = data.num_users, data.num_items
    dev = torch.device("cuda")
    cfg = Config(model=ModelConfig(num_layers=FULLNODE["layers"], dim=FULL["dim"]),
                 train=TrainConfig(epochs=FULLNODE["epochs"], num_clusters=len(parts),
                                   trainer="full", optimizer="adam", fused_bpr=False))
    numbers = dict(card=smi)
    t0 = time.time()
    batches = build_cluster_batches(parts, nu, nu + ni,
                                    bucket_floor=FULLNODE["bucket_floor"], device="cuda")
    torch.cuda.synchronize()
    numbers["cluster_batches_s"] = time.time() - t0
    t0 = time.time()
    stacked = train.StackedClusters.from_batches(batches)
    torch.cuda.synchronize()
    numbers["stack_s"] = time.time() - t0
    k = stacked.num_clusters
    stack_mb = sum(t.numel() * t.element_size() for t in (
        getattr(stacked, f.name) for f in dataclasses.fields(stacked))
        if isinstance(t, torch.Tensor)) / 1e6
    numbers["shapes"] = dict(K=k, E_pad=int(stacked.src.shape[1]),
                             B=int(stacked.user.shape[1]), N=stacked.num_nodes,
                             edges=int(stacked.edge_counts.sum().item()),
                             valid_triplets=int(stacked.mask.sum().item()), stack_mb=stack_mb)
    log(f"[fullnode] {k} cluster batches of {numbers['shapes']['E_pad']} padded edges and "
        f"{numbers['shapes']['B']} padded triplets over {stacked.num_nodes} nodes: built in "
        f"{numbers['cluster_batches_s']:.2f} s, stacked ({stack_mb:.1f} MB) in "
        f"{numbers['stack_s']:.3f} s")
    check(k == len(batches) == cfg.train.num_clusters, "a cluster batch came out empty")

    s0 = train.create_train_state(cfg, nu, ni, generator=torch.Generator().manual_seed(SEED),
                                  device="cuda")

    # (a) train_model, 2 epochs through the fused epoch
    launches.clear()
    t0 = time.time()
    state, hist = train.train_model(cfg, copy(s0), batches, val, test)
    torch.cuda.synchronize()
    numbers["train_model_s"] = time.time() - t0
    tm_launches = dict(launches)
    check(all(np.isfinite(v) for key in hist for v in hist[key]),
          f"full-node train_model: a loss or metric is not finite: {hist}")
    check(hist["train_loss"][1] < hist["train_loss"][0],
          f"full-node train_model: train loss did not fall: {hist['train_loss']}")
    epochs = cfg.train.epochs
    check(state.step == state.opt_state.count == epochs * k,
          f"full-node train_model: step {state.step}, count {state.opt_state.count}")
    numbers.update(train_loss=hist["train_loss"], val_recall=hist["val_recall"],
                   epoch_with_eval_s=hist["epoch_time_s"], train_model_launches=tm_launches)
    log(f"[fullnode] train_model {epochs} epochs + test eval: {numbers['train_model_s']:.2f} "
        f"s; train loss {hist['train_loss']}, val recall {hist['val_recall']}; epoch times "
        f"with the val eval {[round(t, 3) for t in hist['epoch_time_s']]} s; launches "
        f"{tm_launches}")

    # (b) the captured epoch against the eager body's from the same state and
    # generator: constant lr on every cluster (each route's epoch timed, the
    # captured one with its capture), cosine lr through its warm-up on the
    # first SUB clusters
    sub = train.StackedClusters.from_batches(batches[:FULLNODE["sub"]])
    cfg_cos = cfg.replace(train=dataclasses.replace(
        cfg.train, lr_schedule="cosine", lr_warmup_steps=FULLNODE["warmup"],
        lr_total_steps=3 * sub.num_clusters))
    fns = {}
    for label, cfg_l, start, stk in (("constant", cfg, state, stacked),
                                     ("cosine", cfg_cos, s0, sub)):
        fns[label] = dict(captured=train.make_epoch_fn(cfg_l),
                          eager=train._eager_epoch_fn(cfg_l))
        out = {}
        for route, fn in fns[label].items():
            st, gen = copy(start), train.epoch_generator(cfg_l, epochs, dev)
            launches.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            st, loss = fn(st, stk, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            n_sc = launches["sorted_index_add"]
            val_out = tuple(float(v) for v in train.make_eval_step(cfg_l)(
                st.params, *val, gen))
            out[route] = dict(state=st, loss=loss, gen=gen.get_state(), eval=val_out,
                              wall=wall, peak=peak, resident=resident, sorted_index_add=n_sc)
        a, b = out["captured"], out["eager"]
        k_l = stk.num_clusters
        same = states_equal(a["state"], b["state"])
        check(all(same) and a["loss"] == b["loss"] and np.isfinite(a["loss"]),
              f"{label} lr: the captured full-node epoch differs from the eager body's "
              f"(tables, moments, count, step equal: {same}; loss {a['loss']!r} vs "
              f"{b['loss']!r})")
        check(torch.equal(a["gen"], b["gen"]) and a["eval"] == b["eval"],
              f"{label} lr: the generators after the two routes differ, or the val evals "
              f"after them ({a['eval']} vs {b['eval']})")
        per_step = b["sorted_index_add"] / k_l
        check(b["sorted_index_add"] > 0 and b["sorted_index_add"] % k_l == 0
              and a["sorted_index_add"] == 2 * per_step,
              f"{label} lr: sorted_index_add counted {a['sorted_index_add']} times in the "
              f"captured epoch (warm-up and capture: twice a step's {per_step}), "
              f"{b['sorted_index_add']} in the eager one")
        numbers[f"{label}_equal"] = dict(clusters=k_l, loss=a["loss"], val=a["eval"],
                                         capture_epoch_s=a["wall"], eager_epoch_s=b["wall"])
        log(f"[fullnode] {label} lr, {k_l} clusters: the captured epoch torch.equal to the "
            f"eager body's in tables, moments, count {a['state'].opt_state.count} and step "
            f"{a['state'].step}, loss {a['loss']!r}; generators equal after both, val eval "
            f"{a['eval']} after both; sorted_index_add {per_step:.0f} a step, counted "
            f"{a['sorted_index_add']} in the captured epoch (warm-up + capture); "
            f"{a['wall']:.3f} s with the capture, eager {b['wall']:.3f} s")
        if label == "constant":
            full_runs = out
    numbers["sorted_index_add_per_step"] = per_step
    check(tm_launches.get("sorted_index_add", 0)
          == 2 * per_step + (epochs + 1) * FULLNODE["layers"],
          f"full-node train_model counted {tm_launches.get('sorted_index_add', 0)} "
          f"sorted_index_add launches: not one warm-up step and one capture ({per_step:.0f} "
          f"each) and {FULLNODE['layers']} per eval, so an epoch was not a replay")

    # (c) the eager body's steps with host syncs made errors
    steps, st = fns["constant"]["eager"].steps, copy(state)
    perm, neg = train._epoch_draws(cfg, sub, ni, train.epoch_generator(cfg, epochs + 1, dev))
    steps.prepare(st, sub, perm, neg)
    site = sync_site(lambda: [steps.step(st, sub) for _ in range(sub.num_clusters)])
    check(site is None, f"the full-node epoch's eager body synchronised with the host at "
          f"{site}")
    numbers["eager_body_host_syncs"] = 0
    log(f"[fullnode] the eager body's {sub.num_clusters} steps under "
        f"set_sync_debug_mode('error'): no host sync")
    del st, steps
    launches.clear()
    with HeldCalls() as held:
        fns["constant"]["eager"](copy(state), sub, None, perm=perm, neg=neg)
    torch.cuda.synchronize()
    counts, seen = dict(launches), dict(held.calls)
    check(counts == seen and counts.get("sorted_index_add") == per_step * sub.num_clusters,
          f"the held eager epoch launched {counts}, the wrappers saw {seen}: not "
          f"{per_step:.0f} sorted_index_add a step, each one seen")
    holds = hold_kept(held, "fullnode", bw)["sorted_index_add"]
    check(len(holds) > 0, "the held eager epoch kept no sorted_index_add call")
    numbers["holds"] = holds
    log(f"[fullnode] the eager body's {sub.num_clusters} steps held: {len(holds)} "
        f"sorted_index_add shapes ({[(h['rows'], h['entries']) for h in holds]} rows and "
        f"entries), largest error against index_add_ "
        f"{max(h['max_abs_err'] or 0.0 for h in holds):.3e}")
    del held, perm, neg

    # (d) the captured epoch again on every cluster, its graph replayed (no
    # capture in it), timed; each route profiled over the SUB clusters
    st = full_runs["captured"]["state"]
    launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st, loss = fns["constant"]["captured"](st, stacked, train.epoch_generator(
        cfg, epochs + 1, dev))
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    check(np.isfinite(loss) and not launches, f"the replayed epoch's loss {loss} is not "
          f"finite, or it counted launches {dict(launches)}: captured again, not replayed")
    timed = dict(
        captured=dict(epoch_s=t_replay, step_ms=1e3 * t_replay / k,
                      capture_epoch_s=full_runs["captured"]["wall"],
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                      peak_over_resident_gb=(torch.cuda.max_memory_allocated() - resident) / 1e9,
                      capture_peak_over_resident_gb=(full_runs["captured"]["peak"]
                                                     - full_runs["captured"]["resident"]) / 1e9),
        eager=dict(epoch_s=full_runs["eager"]["wall"],
                   step_ms=1e3 * full_runs["eager"]["wall"] / k,
                   peak_gb=full_runs["eager"]["peak"] / 1e9,
                   peak_over_resident_gb=(full_runs["eager"]["peak"]
                                          - full_runs["eager"]["resident"]) / 1e9))
    del full_runs, st
    for route in ("captured", "eager"):
        st = copy(state)
        fn = train.make_epoch_fn(cfg) if route == "captured" else train._eager_epoch_fn(cfg)
        gen_p = torch.Generator(device="cuda").manual_seed(SEED + 5)
        prof = profile_window(f"{route} full-node epoch ({sub.num_clusters} steps)", 1, 8,
                              lambda: fn(st, sub, gen_p))
        check(prof["kernels"] >= sub.num_clusters, f"{route}: the profiler saw "
              f"{prof['kernels']} kernels in a {sub.num_clusters}-step epoch")
        t = timed[route]
        t.update(busy_ms_per_step=prof["busy_ms"] / sub.num_clusters,
                 profiled_wall_ms_per_step=prof["wall_ms"] / sub.num_clusters,
                 idle_share=prof["idle_share"],
                 launches_per_step=prof["kernels"] / sub.num_clusters)
        log(f"[fullnode] {route} epoch ({k} clusters): {t['epoch_s']:.4f} s, "
            f"{t['step_ms']:.4f} ms a step; over {sub.num_clusters} steps under the "
            f"profiler: idle share {t['idle_share']:.4f}, {t['launches_per_step']:.1f} "
            f"kernels a step; peak device memory {t['peak_gb']:.3f} GB "
            f"({t['peak_over_resident_gb']:.3f} GB over the resident)")
        del st
    numbers["epochs"] = timed

    # (e) recovered against uninterrupted, 3 epochs over the SUB clusters,
    # full-state checkpoints every 2
    cfg_r = cfg.replace(train=dataclasses.replace(cfg.train, epochs=3,
                                                  state_checkpoint_every=2))
    res = recovered_vs_uninterrupted("fullnode", cfg_r, lambda: copy(s0),
                                     batches[:FULLNODE["sub"]], val, test)
    numbers.update(recovery=dict(clusters=FULLNODE["sub"],
                                 uninterrupted_s=res["uninterrupted"]["wall_s"],
                                 recovered_s=res["recovered"]["wall_s"],
                                 epochs_run=res["recovered"]["calls"]))
    del res, state, s0, stacked, sub, batches
    numbers["phase_s"] = time.time() - t_phase
    log(f"[fullnode] {json.dumps(numbers)}")
    return numbers


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


def _mesh_hybrid_step(mesh, z, device) -> tuple:
    """One sharded hybrid step (``HYB``'s graph at this mesh's ``pm``, the
    symmetric VJP) from the tables, batch and negatives in ``z``, over its
    interaction-split graph and partition: (loss, the whole clipped
    gradient, users then items). The blocks are f32: with bf16 blocks each
    data rank rounds its own cotangents to bf16 before the sum over
    ``data``, so meshes of another ``dp`` differ by that rounding (about
    4e-4 of the largest entry on the CPU's gloo rehearsal)."""
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
    g = hybrid_graph(z["hyb_e"], u.shape[0], i.shape[0], mesh.mp, z["node_part"],
                     int(z["parts"]), block_dtype="float32")[0]
    shard = sh.shard_hybrid(g, plan, m, device)
    local = sh.shard_params(sh.pad_params(params_from_numpy(u, i, device), plan), plan, m)
    grads = []
    step = sh.make_sharded_train_step(cfg, mesh, plan, opt=_grad_probe(grads), hybrid=True)
    batch = TripletBatch(*(torch.from_numpy(z[k]).to(device) for k in ("user", "pos", "mask")))
    _, loss = step(TrainState(local, None, 0), shard, batch, torch.from_numpy(z["neg"]).to(device))
    g = sh.unpad_params(sh.gather_params(LightGCNParams(*grads), mesh), plan)
    return float(loss), torch.cat(list(g)).cpu().numpy()


def _mesh_rank(rank: int, world: int, dp: int, mp: int, port: int, path: str,
               device_type: str = "cuda") -> None:
    """One rank of a multi-card mesh (spawned when the machine has several
    cards; ``device_type="cpu"`` runs it over gloo): :func:`_mesh_step`,
    and :func:`_mesh_hybrid_step` when the inputs hold a hybrid graph;
    rank 0 writes the losses and the gradients."""
    from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as pmesh

    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    pmesh.distributed_init(device, init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank, timeout_s=300)
    try:
        with np.load(path) as z:
            mesh = pmesh.make_mesh(dp, mp, device=device)
            loss, grad = _mesh_step(mesh, z, device)
            hybrid = _mesh_hybrid_step(mesh, z, device) if "hyb_e" in z else ()
        if rank == 0:
            np.savez(path.replace(".npz", f"_{dp}x{mp}.npz"), loss=loss, grad=grad,
                     **dict(zip(("hyb_loss", "hyb_grad"), hybrid)))
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


def save_mesh_inputs(p0, train_e, batch, neg, hybrid: dict = None) -> str:
    """The tables, graph, batch and negatives the spawned ranks read; with
    ``hybrid`` also the hybrid step's graph (``hyb_e``), ``node_part`` and
    ``parts``."""
    path = str(WORK / "mesh_inputs.npz")
    np.savez(path, u=p0.user_emb.cpu().numpy(), i=p0.item_emb.cpu().numpy(),
             train_e=train_e, user=batch.user.cpu().numpy(),
             pos=batch.pos_item.cpu().numpy(), mask=batch.mask.cpu().numpy(),
             neg=neg.cpu().numpy(), **(hybrid or {}))
    return path


def mesh_cards_only(t_start: float, smi: str) -> int:
    """``--mesh-only``: what exists only across cards and what it is held
    against, and nothing else. The full graph and the mesh phase's step
    inputs, with the interaction split's hybrid graph (phase 5f's
    partition), then :func:`mesh_cards` over every mesh the cards allow
    (2×1, 1×2; with four, also 2×2, 4×1, 1×4) against the 1×1 mesh, the
    segment step and the hybrid step."""
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
        hyb_e = split_edges(data, str(WORK / "indexes_i"), seed=SEED,
                            split_level="interaction")[0]
        _, node_part, parts, _, _ = hybrid_graph(hyb_e, data.num_users, data.num_items, 1)
        path = save_mesh_inputs(p0, train_e, batch, neg,
                                dict(hyb_e=hyb_e, node_part=node_part, parts=parts))
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
    clipped gradient within 1e-5 of its largest entry; the same for the
    hybrid step when the inputs hold its graph. Returns the shapes run."""
    import torch.multiprocessing as mp

    with np.load(path) as z:
        ref_loss, ref = _mesh_step(mesh, z, mesh.device)
        hyb_ref = _mesh_hybrid_step(mesh, z, mesh.device) if "hyb_e" in z else None
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
        if hyb_ref is not None:
            with np.load(path.replace(".npz", f"_{dp_}x{mp_}.npz")) as z:
                h_loss = float(z["hyb_loss"])
                h_err = float(np.abs(z["hyb_grad"] - hyb_ref[1]).max())
            h_top = float(np.abs(hyb_ref[1]).max())
            check(abs(h_loss - hyb_ref[0]) <= 2e-5 * abs(hyb_ref[0]) and h_err <= 1e-5 * h_top,
                  f"mesh {dp_}x{mp_} hybrid step: loss {h_loss!r} vs 1x1 {hyb_ref[0]!r}, "
                  f"clipped gradient {h_err:.3e} from 1x1's (largest entry {h_top:.3e})")
            log(f"[mesh] {dp_}x{mp_} hybrid step: loss {h_loss:.8f} (1x1 {hyb_ref[0]:.8f}), "
                f"clipped gradient within {h_err:.3e} of 1x1's (largest entry {h_top:.3e})")
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


#: phase 5f: the JAX package's own sharded configuration (``bench.py``'s
#: ``SCALES["full"]`` and ``bench_sharded_epoch``: 64 parts, 8 refine
#: rounds and no kept-edge balance pass, ghost cap 4,608, blocks up to
#: 4,608 wide in bf16), 16 steps an epoch; the batch of phase 5e's sharded
#: step for the comparison with it; the pm of the rectangular B4 case
HYB = dict(parts=64, refine_rounds=8, balance_tol=0.0, ghost_cap=4608,
           max_block_nodes=4608, steps=16, epochs=3, timed_steps=3,
           segment_batch=2 ** 20, shard_pm=4)


def hybrid_graph(train_e: np.ndarray, num_users: int, num_items: int, pm: int,
                 node_part=None, parts: int = None, block_dtype: str = "bfloat16"):
    """``bench.py``'s loop (``parallel/sharding.py::build_sharded_hybrid``):
    the native partition into ``HYB["parts"]`` parts, then
    ``shard_hybrid_graph`` at ``pm``; a block wider than
    ``HYB["max_block_nodes"]`` doubles the parts. Given ``node_part`` and
    ``parts``, only the build. Returns (graph, node_part, parts, partition
    s, build s)."""
    from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as sh

    return sh.build_sharded_hybrid(
        train_e, sh.ShardPlan.create(num_users, num_items, pm), parts or HYB["parts"],
        ghost_cap=HYB["ghost_cap"], max_block_nodes=HYB["max_block_nodes"],
        balance_tol=HYB["balance_tol"], refine_rounds=HYB["refine_rounds"], seed=SEED,
        block_dtype=block_dtype, node_part=node_part)


def rank_remainder(g, m: int):
    """Model rank ``m``'s remainder of a ``ShardedHybrid`` as host edges
    ``(2, k)`` (padded global source id, local row) and their weights."""
    k = int(g.off_counts[m])
    return np.stack([g.off.src[m, :k], g.off.dst_local[m, :k]]), g.off.w[m, :k]


def hybrid_shard_b4_case(train_e, nu: int, ni: int, node_part, parts: int, bw: float,
                         d: int) -> dict:
    """B4 at a true shard's shape: rank 0 of a ``HYB["shard_pm"]``-rank
    ``shard_hybrid_graph`` of the train graph, its ``l_rows`` local rows
    read from the ``n_pad``-row table, and its transpose, each held by
    :func:`ell_case` against the plain ``spmm_ell`` and ``spmm_segment``
    (f32 and a bf16 table, bit-equal over two calls), then timed by CUDA
    events beside the plain version and ``torch.sparse.mm`` on the same
    rectangular CSR, with its bound."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import DeviceELL, spmm_ell
    from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as sh

    plan = sh.ShardPlan.create(nu, ni, HYB["shard_pm"])
    g, _, _, _, t_build = hybrid_graph(train_e, nu, ni, HYB["shard_pm"], node_part, parts)
    l_rows = plan.u_loc + plan.i_loc
    e_off, w = rank_remainder(g, 0)
    k = e_off.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    out = dict(pm=HYB["shard_pm"], rows=l_rows, sources=plan.n_pad, edges=k,
               shard_hybrid_graph_s=t_build)
    for name, ell_g, e, rows, n_src, split in (
            ("shard", sh.remainder_ell(g, plan, 0), e_off, l_rows, plan.n_pad, plan.u_pad),
            ("transpose", sh.remainder_ell(g, plan, 0, transpose=True), e_off[::-1],
             plan.n_pad, l_rows, plan.u_loc)):
        ell = DeviceELL.from_host(ell_g, "cuda", src_split=split)
        check((ell.num_nodes, ell.num_src) == (rows, n_src),
              f"the {name}'s ELL is {ell.num_nodes} rows from {ell.num_src}")
        x = torch.randn(n_src, d, device="cuda", generator=gen)
        empty = np.setdiff1d(np.arange(rows), e[1])
        err = ell_case(ell, weighted_coo(e, n_src, w, rows=rows), x,
                       f"pm={HYB['shard_pm']} rank 0 {name}: {rows} rows from {n_src} "
                       f"sources, {k} edges, {empty.size} rows empty",
                       zero_rows=tuple(empty))
        ms = time_ms(lambda: spmm_ell_cuda(ell, x), 20)
        # the same hop over a work list without the source side order
        one = DeviceELL.from_host(ell_g, "cuda")
        check(not one.schedule.item_side.any() and set(ell.schedule.item_side.tolist()) == {0, 1}
              and torch.equal(spmm_ell_cuda(one, x), spmm_ell_cuda(ell, x)),
              f"the {name}'s hop differs without the side order, or a list has the wrong sides")
        sides = dict(by_side=[], one_side=[])
        for _ in range(3):
            sides["by_side"].append(time_ms(lambda: spmm_ell_cuda(ell, x), 20))
            sides["one_side"].append(time_ms(lambda: spmm_ell_cuda(one, x), 20))
        del one
        plain_ms = time_ms(lambda: spmm_ell(ell, x), 3, warmup=1)
        order = np.argsort(e[1], kind="stable")
        rowptr = np.concatenate([[0], np.cumsum(np.bincount(e[1], minlength=rows))])
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(rowptr.astype(np.int32)).to("cuda"),
            torch.from_numpy(e[0][order].astype(np.int32)).to("cuda"),
            torch.from_numpy(w[order]).to("cuda"), size=(rows, n_src))
        ref = spmm_ell_cuda(ell, x)
        check(bool(((torch.sparse.mm(csr, x) - ref).abs() <= 1e-6 + 1e-3 * ref.abs()).all()),
              f"torch.sparse.mm on the {name}'s CSR disagrees with ell_spmm")
        lib_ms = time_ms(lambda: torch.sparse.mm(csr, x), 20)
        bound, by, byts, _, slots, edges, _, _ = ell_bound(ell, d, 4, bw)
        check(edges == k, f"the {name}'s ELL holds {edges} edges, the shard {k}")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, **sides,
                         bound_by=by, bound_mb=byts / 1e6, slots=slots, max_abs_err=err,
                         buckets=[(b.rows, b.width) for b in ell_g.blocks],
                         items=len(ell.schedule.items))
        log(f"[kernel] ell_spmm at the pm={HYB['shard_pm']} shard's {name} ({rows} rows from "
            f"{n_src}, {k} edges in {slots} slots, d={d}, f32): {ms:.4f} ms by CUDA events, "
            f"plain {plain_ms:.4f} ms, torch.sparse.mm (CSR) {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {byts / 1e6:.1f} MB), {bound / ms:.3f} of it; "
            f"by source side {sides['by_side']}, one side {sides['one_side']} ms")
        del ell, x, csr, ref
    return out


def sharded_hybrid_phase(data, train_e: np.ndarray, smi: str, bw: float, b4_row: dict) -> dict:
    """Phase 5f: the sharded hybrid path (JAX ``make_sharded_epoch_fn``,
    ``"hybrid-mxu[64x4608]+chunked-ell, symmetric-vjp"``) at the JAX
    package's bench configuration (:data:`HYB`) on a one-rank NCCL group
    (mesh 1×1), over the interaction split's train graph (symmetric, as the
    symmetric VJP needs), L = 3, d = 64, f32 compute, uniform negatives,
    Adam at ``cfg.train.lr``. (f) the host time of the partition and of
    ``shard_hybrid_graph``, apart; (a) one step with f32 blocks against the
    single-device ``spmm_hybrid_sym`` step (``make_train_step``) from the
    same tables, batch and negatives: loss within rtol 2e-5, Adam's first
    moments ``(1 - b1)·clipped gradient`` within 1e-5 of the reference's
    largest entry; (b) the step without the symmetric VJP (autograd through
    the collectives, B4 over the transposed ELL) against it, moments within
    1e-5, and B4 over that transpose by :func:`ell_case`; (c) the step's
    kernels at its own inputs against their plain versions (B4 over the
    rank's remainder by :func:`ell_case`, ``sorted_index_add`` at the
    batch's sorted users and items by :func:`scatter_case`); with bf16
    blocks, the step bit-equal over two runs, its launches and
    collectives, timed at the epoch's batch and at phase 5e's 2^20, profiled;
    (d) three epochs through ``make_sharded_epoch_fn``,
    the second with host syncs made errors, the third timed alone (s per
    epoch, launches and collectives per step, peak memory), finite and
    falling losses; (e) ``make_sharded_propagate(hybrid=True)`` with f32
    blocks on the trained tables against ``compute_serving_tables(mode=
    "propagated")`` (the ELL route) within 1e-5 of the largest entry; B4 at
    a pm = 4 shard's shape and its transpose. One ``[sharded-hybrid]`` JSON
    line; B4's row gains the path's launches and the shard's numbers."""
    import torch.distributed as dist

    from movie_recommender_system_with_gnns_tpu_torch.config import (
        Config, ModelConfig, TrainConfig)
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import forward_half
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import (
        LightGCNParams, init_params)
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import (
        TripletBatch, sample_negative)
    from movie_recommender_system_with_gnns_tpu_torch.ops.spmm import (
        DeviceELL, build_hybrid_graph, spmm_hybrid_sym)
    from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as pmesh
    from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as sh
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
        compute_serving_tables)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        TrainState, make_adam, make_optimizer, make_train_step)
    from movie_recommender_system_with_gnns_tpu_torch.utils.roofline import ell_rows_written

    t_phase = time.time()
    nu, ni = data.num_users, data.num_items
    n, L, d = nu + ni, TRAIN["layers"], FULL["dim"]
    numbers = dict(card=smi)
    torch.cuda.empty_cache()
    pmesh.distributed_init("cuda")
    mesh = pmesh.make_mesh(1, 1, device="cuda")
    plan = sh.ShardPlan.create(nu, ni, 1)

    # (f) the host build: partition, then the sharded graph
    g, node_part, parts, t_part, t_build = hybrid_graph(train_e, nu, ni, 1)
    _, p_w = g.blk_ids.shape[1:]
    cfg = Config(model=ModelConfig(num_layers=L, dim=d),
                 train=TrainConfig(symmetric_vjp=True, fullgraph_steps=HYB["steps"]))
    uv = forward_half(train_e, nu)
    user = torch.from_numpy(uv[0].astype(np.int32)).to("cuda")
    pos = torch.from_numpy(uv[1].astype(np.int32)).to("cuda")
    sp = sh.sharded_epoch_plan(cfg, int(user.shape[0]), 1)
    b = sp["batch"]
    numbers["setup"] = dict(parts=parts, block_width=p_w, partition_s=t_part,
                            shard_hybrid_graph_s=t_build,
                            blocks_gb_bf16=parts * p_w ** 2 * 2 / 1e9,
                            train_edges=int(train_e.shape[1]), **g.stats, **sp,
                            masked=sp["num_steps"] * b - sp["e_real"])
    log(f"[sharded-hybrid] set-up on the host: {json.dumps(numbers['setup'])}")
    check(g.stats["absorbed_edges"] > 0, "no edge moved onto the ghost columns")

    p0 = init_params(nu, ni, d, generator=torch.Generator().manual_seed(SEED + 10),
                     device="cuda")
    copy = lambda p: LightGCNParams(p.user_emb.clone(), p.item_emb.clone())
    local0 = lambda: sh.shard_params(sh.pad_params(copy(p0), plan), plan, 0)
    full = lambda pair: torch.cat(list(sh.unpad_params(sh.gather_params(pair, mesh), plan)))
    adam = make_adam(cfg, lr_of=lambda t: cfg.train.lr)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    first = torch.randperm(sp["e_real"], generator=gen, device="cuda")[:b]
    tb = TripletBatch(user[first], pos[first], torch.ones(b, dtype=torch.bool, device="cuda"))
    neg = sample_negative(gen, b, ni)

    def one_step(shard, sym: bool, batch=tb, negs=neg):
        local = local0()
        step = sh.make_sharded_train_step(cfg, mesh, plan, adam, hybrid=True, symmetric=sym)
        return step(TrainState(local, adam.init(local), 0), shard, batch, negs)

    # (a) f32 blocks against the single-device full-graph propagation's step
    g32 = dataclasses.replace(g, block_dtype="float32")
    t0 = time.time()
    shard32 = sh.shard_hybrid(g32, plan, 0, "cuda")
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    st_a, loss_a = one_step(shard32, True)
    mu_a = full(st_a.opt_state.mu)
    del st_a
    h32 = build_hybrid_graph(train_e, n, node_part, parts, block_dtype="float32",
                             max_block_nodes=HYB["max_block_nodes"], device="cuda")
    opt = make_optimizer(cfg)
    p = copy(p0)
    st_r, loss_r = make_train_step(cfg, spmm=spmm_hybrid_sym)(
        TrainState(p, opt.init(p), 0), h32, tb, None, neg=neg)
    mu_r = torch.cat(list(st_r.opt_state.mu))
    del st_r, h32
    top = mu_r.abs().max().item()
    la, lr_ = loss_a.item(), loss_r.item()
    err_a = (mu_a - mu_r).abs().max().item()
    check(abs(la - lr_) <= 2e-5 * abs(lr_) and err_a <= 1e-5 * top,
          f"(a) hybrid step (f32 blocks) vs the single-device spmm_hybrid_sym step: loss "
          f"{la!r} vs {lr_!r}, first moments {err_a:.3e} apart (largest entry {top:.3e})")
    # (b) autograd through the collectives and B4's transposed rectangular ELL
    shard32t = dataclasses.replace(shard32, off_ell_t=DeviceELL.from_host(
        sh.remainder_ell(g32, plan, 0, transpose=True), "cuda", src_split=plan.u_loc))
    st_b, loss_b = one_step(shard32t, False)
    # B4 over the remainder's transpose, the backward of (b)'s three hops,
    # at its own shape against the plain versions
    l_rows = plan.u_loc + plan.i_loc
    e_off, w_off = rank_remainder(g, 0)
    gen_k = torch.Generator(device="cuda").manual_seed(SEED + 14)
    empty_t = np.setdiff1d(np.arange(plan.n_pad), e_off[0])
    t_err = ell_case(shard32t.off_ell_t, weighted_coo(e_off[::-1], l_rows, w_off,
                                                      rows=plan.n_pad),
                     torch.randn(l_rows, d, device="cuda", generator=gen_k),
                     f"(b) the 1x1 remainder's transpose ({plan.n_pad} rows from {l_rows} "
                     f"sources, {e_off.shape[1]} edges, {empty_t.size} rows empty)",
                     zero_rows=tuple(empty_t))
    err_b = (full(st_b.opt_state.mu) - mu_a).abs().max().item()
    top_a = mu_a.abs().max().item()
    check(err_b <= 1e-5 * top_a and abs(loss_b.item() - la) <= 2e-5 * abs(la),
          f"(b) the step without the symmetric VJP: first moments {err_b:.3e} from the "
          f"symmetric step's (largest {top_a:.3e}), loss {loss_b.item()!r} vs {la!r}")
    del st_b, shard32, shard32t, mu_a, mu_r
    torch.cuda.empty_cache()
    numbers["check"] = dict(loss=la, single_device_loss=lr_, mu_err=err_a, mu_largest=top,
                            autograd_mu_err=err_b, f32_upload_s=t_upload)
    log(f"[sharded-hybrid] (a) f32 blocks vs the single-device spmm_hybrid_sym step: loss "
        f"{la:.8f} vs {lr_:.8f}, first moments within {err_a:.3e} (largest {top:.3e}); (b) "
        f"without the symmetric VJP within {err_b:.3e} of it")

    # (c) bf16 blocks: bit-equal over two runs; launches, collectives, times
    shard = sh.shard_hybrid(g, plan, 0, "cuda")
    torch.cuda.synchronize()
    # the epoch's shapes for its floor (phase 7r)
    floor_inputs = dict(n_pad=plan.n_pad, steps=sp["num_steps"], batch=b,
                        e_off_directed=int(e_off.shape[1]),
                        ell_chunks=ell_rows_written(shard.off_ell.schedule),
                        blk_k=int(np.prod(g.blk_ids.shape[:2])), blk_p=int(p_w))
    # the step's two kernels at its own inputs against their plain versions:
    # B4 over the rank's remainder (the layer's (n_pad, d) table in, l_rows
    # rows out), sorted_index_add at the batch's sorted users and items (the
    # triplet gathers' backward, as _local_loss sorts them)
    x_off = torch.randn(plan.n_pad, d, device="cuda", generator=gen_k)
    empty = np.setdiff1d(np.arange(l_rows), e_off[1])
    off_err = ell_case(shard.off_ell, weighted_coo(e_off, plan.n_pad, w_off, rows=l_rows),
                       x_off, f"(c) the 1x1 remainder ({l_rows} rows from {plan.n_pad} "
                       f"sources, {e_off.shape[1]} edges, {empty.size} rows empty)",
                       zero_rows=tuple(empty))
    off_ms = time_ms(lambda: spmm_ell_cuda(shard.off_ell, x_off), 20)
    del x_off
    items = torch.cat([tb.pos_item.reshape(-1), neg.reshape(-1)])
    on_path = dict(
        remainder=dict(rows=l_rows, sources=plan.n_pad, edges=int(e_off.shape[1]), ms=off_ms,
                       max_abs_err=off_err, transpose_max_abs_err=t_err),
        **{f"scatter_{side}": scatter_case(idx, rows, d, gen_k, f"(c) sorted_index_add at "
                                           f"the epoch batch's {side}", bw)
           for side, idx, rows in (("users", tb.user, plan.u_pad), ("items", items, plan.i_pad))})
    del items
    launches.clear()
    calls0 = dict(pmesh.COLLECTIVES)
    t0 = time.perf_counter()
    st_c, loss_c = one_step(shard, True)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    step_launches = dict(launches)
    step_calls = {k: v - calls0.get(k, 0) for k, v in pmesh.COLLECTIVES.items()
                  if v - calls0.get(k, 0)}
    st_c2, loss_c2 = one_step(shard, True)
    same = [torch.equal(x, y) for x, y in zip(
        st_c.params + st_c.opt_state.mu + st_c.opt_state.nu + (loss_c,),
        st_c2.params + st_c2.opt_state.mu + st_c2.opt_state.nu + (loss_c2,))]
    check(all(same), f"(c) the bf16 hybrid step is not bit-equal over two runs: {same}")
    check(step_launches.get("ell_spmm", 0) == 2 * L,
          f"(c) the hybrid step launched ell_spmm {step_launches} times, expected {2 * L}")
    want_calls = dict(all_gather=4 * L + 4, reduce_scatter=4, reduce_scatter_rows=4 * L,
                      all_reduce=4)
    check(step_calls == want_calls, f"(c) the hybrid step's collectives {step_calls}, "
          f"expected {want_calls}")
    del st_c, st_c2
    step = sh.make_sharded_train_step(cfg, mesh, plan, adam, hybrid=True, symmetric=True)
    local = local0()
    st = TrainState(local, adam.init(local), 0)
    b20 = min(HYB["segment_batch"], sp["e_real"])
    idx = torch.randint(0, sp["e_real"], (b20,), generator=gen, device="cuda")
    tb20 = TripletBatch(user[idx], pos[idx], torch.ones(b20, dtype=torch.bool, device="cuda"))
    neg20 = sample_negative(gen, b20, ni)
    step_ms = {}
    for what, batch_, neg_ in (("epoch_batch", tb, neg), ("batch_2_20", tb20, neg20)):
        st, _ = step(st, shard, batch_, neg_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HYB["timed_steps"]):
            st, _ = step(st, shard, batch_, neg_)
        torch.cuda.synchronize()
        step_ms[what] = 1e3 * (time.perf_counter() - t0) / HYB["timed_steps"]
    prof = profile_window("sharded hybrid step (1x1)", 4, 10, lambda: step(st, shard, tb, neg))
    del st, tb20, neg20
    log(f"[sharded-hybrid] (c) bf16 blocks: two steps bit-equal; a step "
        f"{step_ms['epoch_batch']:.2f} ms at the epoch's batch {b}, {step_ms['batch_2_20']:.2f} ms at {b20} (mean of "
        f"{HYB['timed_steps']}); launches {step_launches}; collectives {step_calls}")

    # (d) three epochs, the second with host syncs made errors, the third timed
    build = sh.make_sharded_epoch_fn(cfg, mesh, plan, adam, hybrid=True, symmetric=True)
    local = local0()
    state = TrainState(local, adam.init(local), 0)
    epoch = build(state)
    gen_e = torch.Generator(device="cuda").manual_seed(SEED + 12)
    launches.clear()
    losses = []
    state, loss, plan_e = epoch(state, shard, user, pos, gen_e)
    losses.append(loss.item())
    ran = []
    site = sync_site(lambda: ran.append(epoch(state, shard, user, pos, gen_e)))
    check(site is None, f"(d) the sharded epoch synchronised with the host at {site}")
    state, loss, _ = ran[0]
    losses.append(loss.item())
    before = dict(launches)
    calls0 = dict(pmesh.COLLECTIVES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss, _ = epoch(state, shard, user, pos, gen_e)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses.append(loss.item())
    steps = plan_e["num_steps"]
    per_step = {k: (v - before.get(k, 0)) / steps for k, v in launches.items()}
    calls_step = {k: (v - calls0.get(k, 0)) / steps for k, v in pmesh.COLLECTIVES.items()
                  if v - calls0.get(k, 0)}
    path_launches = dict(launches)
    check(plan_e == sp and per_step.get("ell_spmm") == 2 * L,
          f"(d) plan {plan_e} (expected {sp}), ell_spmm launches a step {per_step}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(d) epoch losses not finite and falling: {losses}")
    log(f"[sharded-hybrid] (d) epochs: losses {losses}; the second with host syncs made "
        f"errors: none; the third {epoch_s:.3f} s ({1e3 * epoch_s / steps:.2f} ms a step), "
        f"launches a step {per_step}, collectives a step {calls_step}, peak "
        f"{peak / 1e9:.2f} GB")

    # (e) propagated tables with f32 blocks against the single-device ELL route
    trained = sh.unpad_params(sh.gather_params(state.params, mesh), plan)
    del shard, state
    torch.cuda.empty_cache()
    shard32 = sh.shard_hybrid(g32, plan, 0, "cuda")
    local_t = sh.shard_params(sh.pad_params(copy(trained), plan), plan, 0)
    t_mesh = sh.unpad_params(sh.gather_params(sh.make_sharded_propagate(
        cfg, mesh, plan, hybrid=True)(local_t, shard32), mesh), plan)
    t_one = compute_serving_tables(trained, train_e, cfg, mode="propagated")
    tab_err = max(rel_max(x, y) for x, y in zip(t_mesh, t_one))
    check(tab_err <= 1e-5, f"(e) hybrid mesh propagated tables vs the ELL route: "
          f"{tab_err:.3e} of the largest entry")
    del shard32, t_mesh, t_one, trained, local_t
    torch.cuda.empty_cache()
    log(f"[sharded-hybrid] (e) make_sharded_propagate(hybrid=True), f32 blocks, vs "
        f"compute_serving_tables(mode='propagated'): {tab_err:.3e} of the largest entry")
    dist.destroy_process_group()

    # B4 at a true shard's shape (four model ranks' rank 0) and its transpose
    rect = hybrid_shard_b4_case(train_e, nu, ni, node_part, parts, bw, d)
    numbers.update(
        step=dict(ms=step_ms["epoch_batch"], ms_at_2_20=step_ms["batch_2_20"],
                  batch=b, batch_2_20=b20, first_ms=first_ms, launches=step_launches,
                  collectives=step_calls, busy_ms=prof["busy_ms"],
                  idle_share=prof["idle_share"], kernels=prof["kernels"]),
        epoch=dict(s=epoch_s, ms_per_step=1e3 * epoch_s / steps, losses=losses,
                   launches_per_step=per_step, collectives_per_step=calls_step,
                   peak_gb=peak / 1e9, launches=path_launches),
        on_path=on_path, tables_rel_err=tab_err, rect_shard=rect,
        floor_inputs=floor_inputs, phase_s=time.time() - t_phase)
    b4_row.update(
        launches=b4_row["launches"] + path_launches.get("ell_spmm", 0),
        launches_sharded_hybrid=path_launches.get("ell_spmm", 0),
        launches_per_sharded_hybrid_step=per_step.get("ell_spmm", 0),
        rect_shard=dict(rows=rect["rows"], sources=rect["sources"], edges=rect["edges"],
                        **{k: rect["shard"][k] for k in (
                            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                            "max_abs_err")},
                        transpose_ms=rect["transpose"]["ms"],
                        transpose_library_ms=rect["transpose"]["library_ms"],
                        transpose_bound_ms=rect["transpose"]["bound_ms"],
                        transpose_max_abs_err=rect["transpose"]["max_abs_err"]))
    log(f"[sharded-hybrid] {json.dumps(numbers)}")
    return numbers


def roofline_phase(shapes: dict, num_users: int, num_items: int, timings: dict,
                   sharded: dict, smi: str) -> dict:
    """Phase 7r: the epochs' row-op roofline (the port's ``utils/roofline.py``).
    The primitive rates measured on the card at the main path's shapes
    (``num_items`` rows, d = 64, the padded triplet width), each replayed
    from a captured CUDA graph; the compact floor under Adam and under
    ``hybrid_adam`` at ``shapes`` (train-compact-full's clusters) and the
    sharded hybrid floor at phase 5f's ``floor_inputs``; ``rowop_util`` =
    floor / the timed third epoch of phases 5a and 5f. The sweep rate is one
    fused Adam pass's; the port's own optimizer's rate is measured beside
    it and prices nothing. Checks: every rate
    finite and positive, the sweep at most 1.05 × the HBM peak, every
    ``rowop_util`` in (0, 1] (a floor above the measured epoch counts work
    the epoch does not do). The gather rate is not held against the HBM
    peak: its table sits in L2. One ``[roofline]`` JSON line."""
    from movie_recommender_system_with_gnns_tpu_torch.utils import roofline

    t0 = time.time()
    d, layers = FULL["dim"], TRAIN["layers"]
    rates = roofline.measure_rowop_rates(num_rows=num_items, d=d, batch=shapes["b_pad"])
    t_rates = time.time() - t0
    opt_gbps = roofline.optimizer_sweep_gbps(num_rows=num_items, d=d)
    _, pf, pb = roofline.device_peaks()
    check(all(np.isfinite(v) and v > 0 for v in rates), f"a row-op rate is not finite "
          f"and positive: {rates}")
    row = d * 4
    rate_bps = dict(gather=row / (rates.gather_ns_row * 1e-9),
                    segment=row / (rates.segment_ns_row * 1e-9),
                    sort=4 / (rates.sort_ns_row * 1e-9), sweep=rates.sweep_gbps * 1e9)
    check(rate_bps["sweep"] <= 1.05 * pb, f"the Adam sweep reads {rate_bps['sweep']:.4e} "
          f"B/s, above 1.05 x the HBM peak {pb:.4e}")
    check(np.isfinite(opt_gbps) and 0 < opt_gbps * 1e9 <= 1.05 * pb,
          f"the port's optimizer sweeps at {opt_gbps:.4e} GB/s")
    floors, util = {}, {}
    for opt in ("adam", "hybrid_adam"):
        floors[opt] = roofline.compact_epoch_floor(
            num_users=num_users, num_items=num_items, d=d, num_layers=layers,
            num_clusters=shapes["num_clusters"], u_pad=shapes["u_pad"],
            i_pad=shapes["i_pad"], b_pad=shapes["b_pad"], rates=rates, peak_flops=pf,
            peak_hbm_bps=pb, optimizer=opt)
        util[opt] = floors[opt]["floor_s"] / timings[opt]["epoch_s"]
    fi = sharded["floor_inputs"]
    floors["sharded"] = roofline.sharded_epoch_floor(
        **fi, d=d, num_layers=layers, rates=rates, peak_flops=pf, peak_hbm_gbps=pb / 1e9)
    util["sharded"] = floors["sharded"]["sharded_floor_s"] / sharded["epoch"]["s"]
    # JAX's count of the remainder (a row gather per edge) at these rates
    jax_ell_s = 2 * layers * fi["steps"] * (
        fi["e_off_directed"] * rates.gather_ns_row
        + fi["ell_chunks"] * rates.segment_ns_row) * 1e-9
    numbers = dict(card=smi, rates=rates._asdict(), rate_bytes_per_s=rate_bps,
                   rates_s=t_rates, optimizer_sweep_gbps=opt_gbps,
                   sweep_priced_with="one fused Adam pass (torch._fused_adam_)",
                   shapes=dict(shapes, d=d, layers=layers), floors=floors,
                   epochs_s=dict(adam=timings["adam"]["epoch_s"],
                                 hybrid_adam=timings["hybrid_adam"]["epoch_s"],
                                 sharded=sharded["epoch"]["s"]),
                   rowop_util=util, sharded_inputs=fi, jax_remainder_count_s=jax_ell_s)
    log(f"[roofline] {json.dumps(numbers)}")
    check(all(0 < u <= 1 for u in util.values()), f"a rowop_util outside (0, 1]: {util}")
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


#: phase 6b: negative ratings written beside the positives, tags, the users
#: whose analysis is held against the host's
SURFACE = dict(negatives=1_250_000, tags=20_000, users=(0, 777, 150_000))
#: the packages the surface reads where they are installed
SURFACE_PACKAGES = ("pandas", "matplotlib", "sklearn", "networkx", "umap")
#: ML-25M's genre vocabulary (movies.csv)
GENRES = ("Action", "Adventure", "Animation", "Children", "Comedy", "Crime",
          "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "IMAX", "Musical",
          "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western")


def _decimal_field(a: np.ndarray):
    """Non-negative ints as decimal text: (n, w) uint8 digits, right-aligned,
    and the (n, w) mask of the significant ones."""
    a = np.asarray(a, np.int64)
    w = len(str(int(a.max()))) if a.size else 1
    digits = np.empty((a.shape[0], w), np.uint8)
    x = a.copy()
    for j in range(w - 1, -1, -1):
        digits[:, j] = 48 + x % 10
        x //= 10
    sig = np.ones(a.shape[0], np.int64)
    for k in range(1, w):
        sig += a >= 10 ** k
    return digits, np.arange(w)[None, :] >= (w - sig)[:, None]


def write_ratings_csv(path: Path, users, movies, ratings, stamps) -> int:
    """``userId,movieId,rating,timestamp`` rows, vectorised: each field's
    digits by integer division into one byte buffer (ratings are halves in
    [0, 5]). Returns the bytes written."""
    n = len(users)
    half = np.frombuffer(b"".join(f"{h / 2:.1f}".encode() for h in range(11)),
                         np.uint8).reshape(11, 3)
    comma, newline = np.full((n, 1), 44, np.uint8), np.full((n, 1), 10, np.uint8)
    every = np.ones((n, 1), bool)
    pieces = [_decimal_field(users), (comma, every), _decimal_field(movies), (comma, every),
              (half[np.rint(np.asarray(ratings) * 2).astype(np.int64)],
               np.ones((n, 3), bool)), (comma, every), _decimal_field(stamps),
              (newline, every)]
    body = np.concatenate([p[0] for p in pieces], axis=1)[
        np.concatenate([p[1] for p in pieces], axis=1)]
    with open(path, "wb") as f:
        f.write(b"userId,movieId,rating,timestamp\n")
        f.write(body.tobytes())
    return path.stat().st_size


def write_surface_csvs(data, out: Path, seed: int) -> dict:
    """Phase 4's graph as ML-25M's CSVs: every pair rated 4.0, 4.5 or 5.0,
    about 1.2 M seeded other pairs rated 0.5 to 3.5, sorted by user and then
    movie (so the two kinds interleave); ``movies.csv`` with ``|`` genres and
    titles of which every fifth holds commas (quoted); a small ``tags.csv``."""
    import csv

    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import sorted_unique

    rng = np.random.default_rng(seed)
    nu, ni = data.num_users, data.num_items
    e = data.edge_index
    fwd = e[0] < nu
    pos = sorted_unique(e[0][fwd].astype(np.int64) * ni + (e[1][fwd] - nu))
    cand = sorted_unique(rng.integers(0, nu, SURFACE["negatives"]).astype(np.int64) * ni
                         + rng.integers(0, ni, SURFACE["negatives"]))
    hit = pos[np.minimum(np.searchsorted(pos, cand), pos.size - 1)] == cand
    neg = cand[~hit]
    keys = np.concatenate([pos, neg])
    stars = np.concatenate([rng.integers(8, 11, pos.size), rng.integers(1, 8, neg.size)]) / 2
    order = np.argsort(keys, kind="stable")
    keys, stars = keys[order], stars[order]
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    nbytes = write_ratings_csv(out / "ratings.csv", data.raw_user_id(keys // ni),
                               data.raw_movie_id(keys % ni), stars,
                               rng.integers(789_652_009, 1_574_327_703, keys.size))
    t_ratings = time.time() - t0
    years = rng.integers(1915, 2020, ni).tolist()
    # 1 to 3 distinct genres a movie: the first of a random order of them
    genre_order = np.argsort(rng.random((ni, len(GENRES))), axis=1).tolist()
    counts = rng.integers(1, 4, ni).tolist()
    with open(out / "movies.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["movieId", "title", "genres"])
        w.writerows(
            [m, f"Synthetic Movie {m}{', The' if j % 5 == 0 else ''} ({years[j]})",
             "|".join(GENRES[g] for g in sorted(genre_order[j][:counts[j]]))]
            for j, m in enumerate(data.movie_ids.tolist()))
    words = ("atmospheric", "twist ending", "based on a book, loosely", "funny",
             "visually appealing", "dark comedy", "sci-fi")
    t_keys = keys[rng.integers(0, keys.size, SURFACE["tags"])]
    with open(out / "tags.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["userId", "movieId", "tag", "timestamp"])
        w.writerows([u, m, words[k % len(words)], 1_500_000_000 + k] for k, (u, m) in enumerate(
            zip(data.raw_user_id(t_keys // ni).tolist(), data.raw_movie_id(t_keys % ni).tolist())))
    return dict(rows=int(keys.size), positives=int(pos.size), negatives=int(neg.size),
                ratings_bytes=int(nbytes), ratings_write_s=t_ratings,
                bytes=int(sum((out / f).stat().st_size
                              for f in ("ratings.csv", "movies.csv", "tags.csv"))))


def run_in_process(fn, argv, cwd: Path = None):
    """``fn(argv)`` in this process (the launch counters see it), its standard
    output printed and returned: (value, text, seconds). An exception is
    printed with its traceback and given back as the value."""
    import contextlib
    import io
    import os

    buf, here, t0 = io.StringIO(), os.getcwd(), time.time()
    try:
        if cwd is not None:
            os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            try:
                value = fn(argv)
            except Exception as e:  # noqa: BLE001 - the caller checks it
                traceback.print_exc()
                value = e
    finally:
        os.chdir(here)
        print(buf.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    return value, buf.getvalue(), time.time() - t0


def run_cli(cli, argv, cwd: Path = None):
    """``cli.main(argv)`` in this process: (rc, text, seconds)."""
    rc, text, secs = run_in_process(cli.main, argv, cwd)
    return (1 if isinstance(rc, Exception) else rc), text, secs


class WidestBprCall:
    """While entered, ``cuda_bpr.bpr_tile`` is wrapped to keep a copy of the
    inputs of its widest call (the most triplets; the first of equals),
    taken before the call; the launches stay the wrapped function's own.
    ``args`` and ``kw`` then hold them, ``calls`` counts the calls."""

    def __init__(self, cuda_bpr):
        self.mod, self.real = cuda_bpr, cuda_bpr.bpr_tile
        self.args, self.kw, self.calls = None, None, 0

    def _call(self, *args, **kw):
        self.calls += 1
        if self.args is None or args[2].shape[0] > self.args[2].shape[0]:
            copy = lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t
            inc = kw.get("incidence")
            self.args = tuple(copy(a) for a in args)
            self.kw = dict(kw, incidence=None if inc is None
                           else type(inc)(*(copy(t) for t in inc)))
        return self.real(*args, **kw)

    def __enter__(self):
        self.mod.bpr_tile = self._call
        return self

    def __exit__(self, *exc):
        self.mod.bpr_tile = self.real
        return False


#: phase 6c: the example drivers with their flags (runs/ logs cut to size),
#: the kernels each must launch, and the phase's budget in seconds
EXAMPLES = dict(
    ml25m=("torch_train_ml25m_scale.py", [
        # runs/ml25m_fg150_k8_d512_pop.log, cut to one epoch
        "--trainer", "fullgraph", "--dim", "512", "--loss-microbatches", "16",
        "--num-negatives", "8", "--negatives", "popularity", "--loss", "standard",
        "--readout", "standard", "--eval-propagated", "--split", "interaction",
        "--lr", "3e-3", "--lr-schedule", "cosine", "--epochs", "1", "--eval-every", "1"],
        ("ell_spmm", "sorted_index_add")),
    bridge=("torch_train_bridge.py", [
        # runs/bridge_d128_r13_hybrid_short.log, cut to one compact epoch and
        # one refresh
        "--correction", "boundary", "--compact-optimizer", "hybrid_adam",
        "--compact-lr-scale", "1.0", "--lr-schedule", "cosine", "--lr-warmup-epochs", "1",
        "--dim", "128", "--split", "interaction", "--loss", "standard",
        "--num-negatives", "8", "--eval-users", "5000", "--final-eval-users", "0",
        "--epochs", "2", "--refresh-every", "2", "--eval-every", "2"],
        ("ell_spmm", "sorted_index_add")),
    sharded=("torch_train_sharded.py", ["--mesh", "1x1", "--epochs", "1"],
             ("sorted_index_add",)),
    profile=("torch_profile_epoch.py", ["--epochs", "1"], ("bpr_tile", "sorted_index_add")))
EXAMPLES_BUDGET_S = 300
#: a scatter hold's host check covers the leading rows whose entries hold at
#: most this many elements (the whole call when it is smaller)
HOST_CHECK_ELEMS = 2 ** 27


class ReuseGraph:
    """While entered, ``make_synthetic_movielens`` (as ``data/movielens.py``
    and ``training/pipeline.py`` bind it) returns ``data`` to a call with the
    arguments that built it (``kw``) and builds any other graph: the
    generator is deterministic, so those arguments give that graph.
    ``reused`` counts the calls it answered."""

    def __init__(self, data, **kw):
        import inspect

        from movie_recommender_system_with_gnns_tpu_torch.data import movielens
        from movie_recommender_system_with_gnns_tpu_torch.training import pipeline

        self.mods, self.real = (movielens, pipeline), movielens.make_synthetic_movielens
        self.sig, self.data, self.reused = inspect.signature(self.real), data, 0
        self.key = self._key(**kw)

    def _key(self, *args, **kw):
        bound = self.sig.bind(*args, **kw)
        bound.apply_defaults()
        return tuple(bound.arguments.items())

    def _call(self, *args, **kw):
        if self._key(*args, **kw) == self.key:
            self.reused += 1
            return self.data
        return self.real(*args, **kw)

    def __enter__(self):
        for m in self.mods:
            m.make_synthetic_movielens = self._call
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.make_synthetic_movielens = self.real
        return False


class HeldCalls:
    """While entered, the wrappers of B4 (``cuda_spmm.ell_spmm_into``, one
    launch a hop), of the row scatter (``cuda_scatter.sorted_index_add``,
    as that module, ``training/compact.py`` and ``ops/cuda_triplet.py`` bind
    it) and of the fused triplet loss (``cuda_triplet.triplet_fwd`` and
    ``triplet_bwd``) keep a copy of the inputs of one launched call of each
    shape: B4's first at each (rows, sources, slots, d, dtype), the
    scatter's widest (most entries) at each (rows, d, dtype), the triplet
    forward's widest (most triplets) at each (d, K). A call made while a
    CUDA graph is captured is counted and not kept (nothing ran). ``calls``
    counts the launched calls the wrappers saw; the launches stay the
    wrapped functions' own."""

    def __init__(self):
        from movie_recommender_system_with_gnns_tpu_torch.ops import (
            _build, cuda_scatter, cuda_spmm, cuda_triplet)
        from movie_recommender_system_with_gnns_tpu_torch.training import compact

        self.launches = _build.LAUNCHES
        self.sites = [(cuda_spmm, "ell_spmm_into", "ell_spmm", self._ell),
                      (cuda_scatter, "sorted_index_add", "sorted_index_add", self._scatter),
                      (compact, "sorted_index_add", "sorted_index_add", self._scatter),
                      (cuda_triplet, "sorted_index_add", "sorted_index_add", self._scatter),
                      (cuda_triplet, "triplet_fwd", "triplet_loss", self._triplet),
                      (cuda_triplet, "triplet_bwd", "triplet_loss", lambda *a, **kw: None)]
        self.real = {(m, f): getattr(m, f) for m, f, _, _ in self.sites}
        self.ell, self.scatter, self.triplet, self.calls = {}, {}, {}, {}

    def _wrap(self, mod, fn, kernel, keep):
        real = self.real[(mod, fn)]

        def call(*args, **kw):
            before = self.launches.get(kernel, 0)
            out = real(*args, **kw)
            if self.launches.get(kernel, 0) > before:
                self.calls[kernel] = self.calls.get(kernel, 0) + 1
                if not torch.cuda.is_current_stream_capturing():
                    keep(*args, **kw)
            return out
        return call

    def _ell(self, ell, emb, out, schedule=None):
        slots = sum(b.nbr.numel() for b in ell.blocks)
        key = (ell.num_nodes, ell.num_src, slots, emb.shape[1], str(emb.dtype)[6:])
        if schedule is None and key not in self.ell:
            self.ell[key] = (ell, emb.detach().clone())

    def _scatter(self, x, order, starts, rows):
        key = (rows, x.shape[1], str(x.dtype)[6:])
        if key not in self.scatter or order.numel() > self.scatter[key][1].numel():
            self.scatter[key] = (x.detach().clone(), order.clone(), starts.clone())

    def _triplet(self, tabs, user, pos, neg, mask, bpr_coeff):
        key = (tabs[0].shape[1], 1 if neg.dim() == 1 else neg.shape[1])
        if key not in self.triplet or user.numel() > self.triplet[key][1].numel():
            self.triplet[key] = ([t.detach().clone() for t in tabs], user.clone(), pos.clone(),
                                 neg.clone(), mask.clone(), bpr_coeff)

    def __enter__(self):
        for mod, fn, kernel, keep in self.sites:
            setattr(mod, fn, self._wrap(mod, fn, kernel, keep))
        return self

    def __exit__(self, *exc):
        for (mod, fn), real in self.real.items():
            setattr(mod, fn, real)
        return False


def hold_scatter(x, order, starts, rows: int, what: str, bw: float) -> dict:
    """``sorted_index_add`` on one kept call's inputs: bit-equal over two
    calls; bit-equal to the plain version's sequential sum on the host over
    the leading rows whose entries hold at most :data:`HOST_CHECK_ELEMS`
    elements (each row's entries re-listed in their order, so the sums are
    the same); an f32 call within 1e-5 of the largest entry of the plain
    version's ``index_add_`` on the card over every row. Timed beside that
    ``index_add_``, with its bound (bytes)."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_scatter

    d = x.shape[1]
    sc = lambda: cuda_scatter.sorted_index_add(x, order, starts, rows)
    plain = lambda: cuda_scatter.sorted_index_add_plain(x, order, starts, rows)
    tally = cuda_scatter.scatter_long_stats()
    out = sc()
    long_rows, long_entries = (a - b for a, b in zip(cuda_scatter.scatter_long_stats(), tally))
    check(torch.equal(out, sc()), f"{what}: two calls differ")
    st = starts.cpu().numpy().astype(np.int64)
    head = int(np.searchsorted(st, st[0] + HOST_CHECK_ELEMS // d, side="right")) - 1
    head = max(min(head, rows), min(1, rows))
    sub = order[st[0]:st[head]].long()
    out_h = cuda_scatter.sorted_index_add_plain(
        x.index_select(0, sub).cpu(), torch.arange(sub.numel(), dtype=torch.int32),
        torch.from_numpy((st[:head + 1] - st[0]).astype(np.int32)), head)
    check(torch.equal(out[:head].cpu(), out_h), f"{what}: rows 0..{head} differ from the "
          f"plain version's sequential sum on the host")
    err = top = None
    if x.dtype == torch.float32:
        ref = plain()
        err, top = (out - ref).abs().max().item(), ref.abs().max().item()
        check(err <= 1e-5 * top, f"{what}: {err:.3e} from index_add_ on the card, largest "
              f"entry {top:.3e}")
        del ref
    entries = int(st[rows] - st[0])
    k_ms, p_ms = time_ms(sc, 5), time_ms(plain, 5)
    itemsize = x.element_size()
    byts = entries * d * itemsize + 4 * entries + 4 * (rows + 1) + rows * d * itemsize
    res = dict(rows=rows, d=d, dtype=str(x.dtype)[6:], entries=entries,
               host_rows=head, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
               bound_ms=byts / bw * 1e3, long_rows=long_rows,
               long_share=long_entries / max(entries, 1))
    log(f"[examples] sorted_index_add {what}: {json.dumps(res)}")
    return res


def hold_kept(held: HeldCalls, name: str, bw: float) -> dict:
    """Each call ``held`` kept from driver ``name``'s run against its plain
    version: B4 by :func:`ell_case` (f32 and bf16 of the kept table, timed,
    with :func:`ell_bound`'s bound), the scatter by :func:`hold_scatter`, the
    fused triplet loss by :func:`triplet_case` (its pair timed). Returns
    {kernel: [one dict per shape]}."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_triplet
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import spmm_ell_cuda

    out = {"ell_spmm": [], "sorted_index_add": [], "triplet_loss": []}
    for (n, n_src, slots, d, dt), (ell, x) in held.ell.items():
        what = f"at {name}'s {n}-row graph from {n_src} sources ({slots} slots), d={d}"
        xf = x.float()
        err = ell_case(ell, None, xf, what)
        bound, by, _, _, _, edges, _, _ = ell_bound(ell, d, 4, bw)
        out["ell_spmm"].append(dict(rows=n, sources=n_src, edges=edges, d=d, kept_dtype=dt,
                                    max_abs_err=err, ms=time_ms(lambda: spmm_ell_cuda(ell, xf), 5),
                                    bound_ms=bound, bound_by=by))
        del xf
    for (rows, d, dt), (x, order, starts) in held.scatter.items():
        out["sorted_index_add"].append(hold_scatter(
            x, order, starts, rows, f"at {name}'s widest call over {rows} rows, d={d}, {dt}",
            bw))
    for (d, k), (tabs, user, pos, neg, mask, coeff) in held.triplet.items():
        b = user.shape[0]
        errs = triplet_case((tabs, user, pos, neg, mask),
                            f"triplet_loss at {name}'s widest call (B {b}, K {k}, d {d})", coeff)
        args = (tabs, user, pos, neg, mask)
        _, sig, stats = cuda_triplet.triplet_fwd(*args, coeff)
        up = torch.ones((), device=user.device)
        pair = lambda: cuda_triplet.triplet_bwd(*args, sig, stats, up, coeff)
        out["triplet_loss"].append(dict(B=b, K=k, d=d, max_abs_err=max(errs.values()),
                                        fwd_ms=time_ms(lambda: cuda_triplet.triplet_fwd(
                                            *args, coeff), 5),
                                        bwd_ms=time_ms(pair, 5)))
        log(f"[examples] triplet_loss at {name}'s widest call: "
            f"{json.dumps(out['triplet_loss'][-1])}")
    held.ell.clear()
    held.scatter.clear()
    held.triplet.clear()
    torch.cuda.empty_cache()
    return out


def examples_phase(data, graph: dict, rows: list, smi: str, bw: float) -> dict:
    """Phase 6c: the four example drivers (``examples/torch_*.py``), each's
    ``main`` called in this process on the card with :data:`EXAMPLES`' flags
    and its own ``--out`` (or ``--logdir``) under :data:`WORK`; phase 4's
    graph ``data`` answers their builds of the same graph (``graph``, its
    arguments; :class:`ReuseGraph`). For each driver: the launch counts set
    to 0 just before and read just after, each kernel the driver's path
    runs launched, and every launch seen by the wrappers that keep its
    inputs (:class:`HeldCalls`, :class:`WidestBprCall`); each kept call then
    held against its plain version (:func:`hold_kept`, :func:`check_bpr`).
    The headline lines and results: the ML-25M driver's TEST line gives a
    finite Recall@10; the bridge's log shows one compact and one full-graph
    epoch and two correction builds; both trainers' losses finite and their
    tables moved from the ones they started from; the sharded driver's
    checkpoint written; the profile's top ops and a ``rowop_util`` in (0, 1].
    Their output is echoed under ``[examples:<name>]``; one ``[examples]``
    JSON line with each driver's seconds, exit code (0: ``main`` returned;
    a driver that raised failed the phase), launches and holds; each held
    kernel's row gains the holds and their largest error; the phase within
    :data:`EXAMPLES_BUDGET_S`."""
    import importlib.util
    import re

    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, cuda_bpr

    torch.cuda.empty_cache()
    t_phase = time.time()
    numbers, outs, results = dict(card=smi), {}, {}
    reuse = ReuseGraph(data, **graph)
    for name, (script, argv, expect) in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                      ROOT / "examples" / script)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        start = {}
        if hasattr(mod, "create_train_state"):
            make_state = mod.create_train_state

            def recorded(*a, **kw):
                st = make_state(*a, **kw)
                start["params"] = [t.clone() for t in st.params]
                return st
            mod.create_train_state = recorded
        where = ["--logdir" if name == "profile" else "--out", str(WORK / f"ex_{name}")]
        _build.LAUNCHES.clear()
        with reuse, HeldCalls() as held, WidestBprCall(cuda_bpr) as widest:
            res, out, secs = run_in_process(mod.main, argv + where)
        counts = dict(_build.LAUNCHES)
        for line in out.splitlines():
            log(f"[examples:{name}] {line}")
        check(not isinstance(res, Exception), f"examples/{script} raised {res!r}")
        seen = dict(held.calls, bpr_tile=widest.calls)
        check(all(counts.get(k, 0) > 0 for k in expect),
              f"examples/{script} launched {counts}, not each of {expect}")
        check(all(seen.get(k, 0) == counts.get(k, 0) for k in counts),
              f"examples/{script}: the wrappers saw {seen} of the launches {counts}: a "
              f"kernel launched that phase 6c does not hold")
        holds = hold_kept(held, name, bw)
        if widest.args is not None:
            kargs, kw = widest.args, dict(widest.kw)
            lists = kw.pop("incidence")
            u_pad, i_pad = kargs[0].shape[0], kargs[1].shape[0]
            nb, kd = kargs[2].shape
            err = check_bpr(kargs, f"bpr_tile at {name}'s widest cluster (u_pad {u_pad}, "
                            f"i_pad {i_pad}, B {nb}, d {kd})", lists,
                            also=[cuda_bpr.bpr_incidence(*kargs[3:], u_pad, i_pad)], **kw)
            holds["bpr_tile"] = [dict(u_pad=u_pad, i_pad=i_pad, B=nb, d=kd,
                                      valid=int(kargs[7].sum()), max_abs_err=err)]
            del kargs, lists
        if start:
            moved = [float((a != b).any(dim=1).float().mean())
                     for a, b in zip(res["state"].params, start["params"])]
            finite = all(bool(torch.isfinite(t).all()) for t in res["state"].params)
            check(finite and all(r > 0 for r in moved),
                  f"examples/{script}: tables finite {finite}, rows moved {moved}")
            start.clear()
        numbers[name] = dict(s=secs, rc=0, launches=counts, holds=holds)
        outs[name], results[name] = out, res
        del held, widest, mod
        torch.cuda.empty_cache()
    losses = dict(ml25m=results["ml25m"]["history"]["train_loss"],
                  bridge=results["bridge"]["losses"])
    check(all(len(v) > 0 and bool(np.isfinite(v).all()) for v in losses.values()),
          f"the trainers' losses are not all finite: {losses}")
    test = re.search(r"^TEST full-ranking Recall@10 (\S+) NDCG@10 (\S+)", outs["ml25m"], re.M)
    check(test is not None and np.isfinite(float(test[1])) and np.isfinite(float(test[2])),
          f"the ML-25M driver printed no finite TEST line: {test and test[0]}")
    kinds = re.findall(r"^Epoch \d+ \[(comp|FULL)\]", outs["bridge"], re.M)
    builds = re.findall(r"^boundary correction (?:built|rebuilt) in", outs["bridge"], re.M)
    check(kinds == ["comp", "FULL"] == results["bridge"]["kinds"] and len(builds) == 2,
          f"the bridge ran epochs {kinds} with {len(builds)} correction builds, expected "
          f"['comp', 'FULL'] and 2")
    check(Path(results["sharded"]).exists(), "the sharded driver wrote no checkpoint")
    util = results["profile"]["rowop_util"]
    check("top ops by self device time" in outs["profile"] and 0 < util <= 1,
          f"the profile printed no top ops or a rowop_util outside (0, 1]: {util}")
    numbers.update(ml25m_test_recall10=float(test[1]), train_losses=losses,
                   bridge_epochs=kinds, bridge_correction_builds=len(builds),
                   profile_rowop_util=util, graph_reused=reuse.reused,
                   phase_s=time.time() - t_phase)
    del results
    log(f"[examples] {json.dumps(numbers)}")
    check(numbers["phase_s"] <= EXAMPLES_BUDGET_S,
          f"phase 6c took {numbers['phase_s']:.1f} s of its {EXAMPLES_BUDGET_S}")
    for row in rows:
        got = {n: numbers[n]["holds"][row["name"]] for n in EXAMPLES
               if numbers[n]["holds"].get(row["name"])}
        if got:
            errs = [h["max_abs_err"] for v in got.values() for h in v
                    if h["max_abs_err"] is not None]
            row["max_abs_err"] = max([row["max_abs_err"]] + errs)
            row["examples"] = {n: dict(launches=numbers[n]["launches"][row["name"]],
                                       held=v) for n, v in got.items()}
    return numbers


def surface_phase(data, trained, params0, smi: str) -> dict:
    """Phase 6b: the user-facing surface at ML-25M width, on phase 4's graph
    and phase 5's trained tables. (a) the graph written as ML-25M's CSVs;
    (b) ``MovieLensDataHandler`` over them against ``load_movielens``, its
    split and its 100 cluster batches on the card; (c) ``cli --dataset
    ml-25m`` at ``ml25m_config()``'s model and clusters: ``train
    --fused-bpr`` (B1 100 times an epoch, the history plot's line; B1 held
    against its plain version on a copy of its widest call's inputs; the
    saved tables finite and moved from the run's initial ones), ``eda``
    (its counts against the rows written) and ``recommend --plots``; (d) the
    analysis' selection on the card against its host copy's; (e) step-numbered
    parameter checkpoints of the trained tables on the card; (f) the three
    PNGs where matplotlib is installed, else "skipped" lines naming it."""
    import importlib.util
    import re

    from movie_recommender_system_with_gnns_tpu_torch import cli
    from movie_recommender_system_with_gnns_tpu_torch.config import ml25m_config
    from movie_recommender_system_with_gnns_tpu_torch.data.handler import MovieLensDataHandler
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import load_movielens
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr
    from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES as launches
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        latest_step, load_params, load_params_orbax, save_params_orbax)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import create_train_state
    from movie_recommender_system_with_gnns_tpu_torch.utils.visualizations import (
        user_neighbourhood)

    t_phase = time.time()
    found = {p: importlib.util.find_spec(p) is not None for p in SURFACE_PACKAGES}
    log(f"[surface] packages found: {found}; numpy {np.__version__}")
    csv_dir, idx = WORK / "ml25m", WORK / "ml25m_indexes"
    numbers = dict(card=smi, packages=found, numpy=np.__version__)

    # (a) the CSVs
    t0 = time.time()
    written = write_surface_csvs(data, csv_dir, SEED)
    numbers.update(csv=written, csv_s=time.time() - t0)
    log(f"[surface] (a) CSVs: {written['rows']} ratings ({written['positives']} rated 4.0 "
        f"to 5.0, {written['negatives']} rated 0.5 to 3.5), ratings.csv "
        f"{written['ratings_bytes']} bytes in {written['ratings_write_s']:.2f} s; all "
        f"three {written['bytes']} bytes in {numbers['csv_s']:.2f} s")

    # (b) the data-handler API over them
    t0 = time.time()
    ratings, movies = str(csv_dir / "ratings.csv"), str(csv_dir / "movies.csv")
    handler = MovieLensDataHandler(ratings, movies, indexes_dir=str(idx))
    t_init = time.time() - t0
    ref = load_movielens(ratings, movies)
    check(np.array_equal(handler.edge_index, ref.edge_index)
          and np.array_equal(handler.data.user_ids, ref.user_ids)
          and np.array_equal(handler.data.movie_ids, ref.movie_ids),
          "the handler's edges or id maps differ from load_movielens over the same files")
    check(handler.get_num_users_items() == (data.num_users, data.num_items),
          f"the handler counts {handler.get_num_users_items()} users and items")
    check(handler.edge_index.shape[1] == data.edge_index.shape[1],
          "the CSVs' positives are not phase 4's graph")
    t1 = time.time()
    splits = handler.get_datasets()
    t_split = time.time() - t1
    n = data.num_users + data.num_items
    key = lambda e: torch.as_tensor(e, device="cuda").long()
    parts = torch.sort(torch.cat([key(e[0]) * n + key(e[1]) for e in splits])).values
    whole = torch.sort(key(handler.edge_index[0]) * n + key(handler.edge_index[1])).values
    check(torch.equal(parts, whole), "get_datasets' splits do not partition the edges")
    del parts, whole
    t1 = time.time()
    loader, val_e, test_e = handler.get_data_training(100, device="cuda")
    torch.cuda.synchronize()
    t_loader = time.time() - t1
    on_card = all(t.device.type == "cuda" for b in loader
                  for t in (b.graph.src, b.graph.dst, b.graph.w, b.batch.user,
                            b.batch.pos_item, b.batch.mask))
    check(len(loader) == 100 and on_card,
          f"get_data_training(100) gave {len(loader)} batches (on the card: {on_card})")
    check(all(np.array_equal(a, b) for a, b in zip((val_e, test_e), splits[1:])),
          "get_data_training's eval edges differ from get_datasets'")
    numbers.update(handler_s=time.time() - t0, handler_init_s=t_init, split_s=t_split,
                   loader_s=t_loader, loader_edges=int(sum(b.num_edges for b in loader)))
    log(f"[surface] (b) MovieLensDataHandler: {handler.num_users} users x "
        f"{handler.num_movies} movies, {handler.edge_index.shape[1]} directed edges, equal to "
        f"load_movielens'; splits {[e.shape[1] for e in splits]} partition them; "
        f"get_data_training(100): 100 batches on the card, "
        f"{numbers['loader_edges']} edges, in {t_loader:.2f} s; the handler's load "
        f"{t_init:.2f} s, the split {t_split:.2f} s, the whole step "
        f"{numbers['handler_s']:.2f} s")
    del handler, ref, splits, loader, val_e, test_e

    # (c) the CLI at ML-25M width
    ml = ml25m_config()
    base = ["--device", "cuda", "--dataset", "ml-25m", "--data-dir", str(csv_dir),
            "--indexes-dir", str(idx), "--checkpoint", str(WORK / "ml25m_model.npz"),
            "--histories-dir", str(WORK / "ml25m_hist"), "--layers", "4", "--dim", "128",
            "--clusters", "100", "--epochs", "1"]
    cfg = cli._build_cfg(cli.build_parser().parse_args(base + ["train"]))
    check((cfg.data.dataset, cfg.model.num_layers, cfg.model.dim, cfg.train.num_clusters)
          == (ml.data.dataset, ml.model.num_layers, ml.model.dim, ml.train.num_clusters),
          "the surface CLI's model and clusters are not ml25m_config()'s")
    plots = WORK / "ml25m_plots"
    plots.mkdir()
    rcs, outs, secs = {}, {}, {}
    launches.clear()
    with WidestBprCall(cuda_bpr) as widest:
        rcs["train"], outs["train"], secs["train"] = run_cli(
            cli, base + ["train", "--fused-bpr"])
    b1 = launches.get("bpr_tile", 0)
    check(rcs["train"] == 0, f"cli --dataset ml-25m train exited {rcs['train']}")
    check(b1 == 100 and widest.calls == 100,
          f"cli train at ML-25M width launched bpr_tile {b1} times in {widest.calls} "
          f"calls, not 100")
    check("REAL DATASET UNAVAILABLE" not in outs["train"],
          "cli train did not read the CSVs")
    check(re.search(r"^history plot( skipped)?: ", outs["train"], re.M) is not None,
          "cli train printed no history-plot line")
    # B1 at the widest cluster this path gave it, on the inputs it gave it,
    # against its plain version (check_bpr's tolerances and bit-equalities)
    kargs, kw = widest.args, dict(widest.kw)
    step_lists = kw.pop("incidence")
    u_pad, i_pad = kargs[0].shape[0], kargs[1].shape[0]
    nb, kd = kargs[2].shape
    check(kd == ml.model.dim, f"cli train gave bpr_tile d = {kd}, not {ml.model.dim}")
    b1_err = check_bpr(kargs, f"bpr_tile at the ML-25M CLI's widest cluster (u_pad {u_pad}, "
                       f"i_pad {i_pad}, B {nb}, d {kd})", step_lists,
                       also=[cuda_bpr.bpr_incidence(*kargs[3:], u_pad, i_pad)], **kw)
    b1_check = dict(u_pad=u_pad, i_pad=i_pad, B=nb, valid=int(kargs[7].sum()), d=kd,
                    loss=kw["loss"], max_abs_err=b1_err)
    del kargs, step_lists, widest
    # the trained tables: finite, and moved from the ones the run started from
    moved, _ = load_params(str(WORK / "ml25m_model.npz"), device="cuda")
    start = create_train_state(cfg, data.num_users, data.num_items, device="cuda").params
    check(all(bool(torch.isfinite(t).all()) for t in moved),
          "cli train at ML-25M width saved tables that are not finite")
    rows_moved = [float((a != b).any(dim=1).float().mean()) for a, b in zip(moved, start)]
    check(all(r > 0 for r in rows_moved),
          f"cli train at ML-25M width left a table as it started: rows moved {rows_moved}")
    hist = np.load(WORK / "ml25m_hist" / "hist_train_loss.npy")
    check(hist.size == 1 and bool(np.isfinite(hist).all()),
          f"cli train at ML-25M width logged the training loss {hist}")
    b1_check.update(rows_moved=dict(user=rows_moved[0], item=rows_moved[1]),
                    train_loss=float(hist[0]))
    del moved, start
    log(f"[surface] (c) bpr_tile at the CLI's widest cluster: {json.dumps(b1_check)}; "
        f"the trained tables finite and moved")
    rcs["eda"], outs["eda"], secs["eda"] = run_cli(cli, base + ["eda"])
    check(rcs["eda"] == 0, f"cli eda exited {rcs['eda']}")
    check(f"\nratings: {written['rows']}\n" in "\n" + outs["eda"],
          f"cli eda's ratings line is not the {written['rows']} rows written")
    check(re.search(rf"^ratings >= 4\.0: {written['positives']} \(", outs["eda"], re.M)
          is not None, f"cli eda's ratings >= 4.0 line is not the {written['positives']} "
          f"positives")
    raw_user = int(data.raw_user_id(SURFACE["users"][1]))
    rcs["recommend"], outs["recommend"], secs["recommend"] = run_cli(
        cli, base + ["recommend", "--user-id", str(raw_user), "--plots"], cwd=plots)
    check(rcs["recommend"] == 0, f"cli recommend --plots exited {rcs['recommend']}")
    numbers.update(cli_rc=rcs, cli_s=secs, b1_launches=b1, b1_check=b1_check)
    log(f"[surface] (c) cli --dataset ml-25m (4 layers, d 128, 100 clusters): exit codes "
        f"{rcs}, seconds {json.dumps(secs)}; bpr_tile launches in train {b1}")

    # (d) the analysis' selection on the card against its host copy's
    t0 = time.time()
    host = LightGCNParams(*(t.cpu() for t in trained))
    sel = {}
    for uidx in SURFACE["users"]:
        uid = int(data.raw_user_id(uidx))
        card = user_neighbourhood(trained, uid, data)
        ref = user_neighbourhood(host, uid, data, num_similar_users=26, num_top_movies=51)
        check(card.similar.device.type == "cuda", "the selection left the card")
        swaps = 0
        for what, ids, scores, rids, rscores in (
                ("similar users", card.similar, card.similar_scores, ref.similar,
                 ref.similar_scores),
                ("dissimilar users", card.dissimilar, card.dissimilar_scores,
                 ref.dissimilar, ref.dissimilar_scores),
                ("top movies", card.top_movies, card.movie_scores, ref.top_movies,
                 ref.movie_scores)):
            swaps += check_topk(scores.cpu()[None], ids.cpu()[None], rscores[None],
                                rids[None], torch.float32, FULL["dim"],
                                f"user {uid}'s {what}, card vs host")
        check(uidx not in card.similar.tolist() + card.dissimilar.tolist(),
              f"user {uid} is among its own similar or dissimilar users")
        check(np.array_equal(card.stack[0], host.user_emb[uidx].numpy()),
              "the stack's first row is not the user's")
        sel[uid] = dict(swaps=swaps, ms=time_ms(lambda: user_neighbourhood(trained, uid, data),
                                                5))
    numbers.update(selection=sel, selection_s=time.time() - t0)
    log(f"[surface] (d) user_neighbourhood on the card (162,541 users, 59,047 movies, "
        f"d {FULL['dim']}): equal to the host's up to near ties, the user in neither list: "
        f"{json.dumps(sel)}")
    del host

    # (e) step-numbered parameter checkpoints on the card
    steps = WORK / "param_steps"
    t0 = time.time()
    check(save_params_orbax(str(steps), params0, step=3), "the step-3 save wrote nothing")
    t1 = time.time()
    check(save_params_orbax(str(steps), trained, step=5), "the step-5 save wrote nothing")
    t_save = time.time() - t1
    check(save_params_orbax(str(steps), trained, step=4) is False,
          "a save at step 4 after step 5 wrote")
    (steps / ".6.tmp-stale").mkdir()
    (steps / ".6.tmp-stale" / "params.npz").write_bytes(b"partial")
    check(latest_step(str(steps)) == 5, "the latest step is not 5")
    torch.cuda.synchronize()
    t1 = time.time()
    latest = load_params_orbax(str(steps), device="cuda")
    torch.cuda.synchronize()
    t_load = time.time() - t1
    three = load_params_orbax(str(steps), step=3, device="cuda")
    check(all(t.device.type == "cuda" for t in (*latest, *three))
          and all(torch.equal(a, b) for a, b in zip(latest, trained))
          and all(torch.equal(a, b) for a, b in zip(three, params0)),
          "a step-numbered checkpoint did not round-trip on the card")
    mb = (steps / "5" / "params.npz").stat().st_size / 1e6
    numbers.update(ckpt_mb=mb, ckpt_save_s=t_save, ckpt_load_s=t_load,
                   ckpt_s=time.time() - t0)
    log(f"[surface] (e) save_params_orbax / load_params_orbax of the trained tables "
        f"({mb:.1f} MB): steps 3 and 5 saved, step 4 refused, a stale temporary directory "
        f"ignored, latest and step 3 torch.equal on the card; save {t_save:.3f} s, load "
        f"{t_load:.3f} s")
    del latest, three

    # (f) the rendering
    skipped = [ln for o in outs.values() for ln in o.splitlines() if "skipped" in ln]
    pngs = [WORK / "ml25m_hist" / "histories_training.png", plots / "recommendations.png",
            plots / "user_analysis.png"]
    if found["matplotlib"]:
        check(not skipped, f"a plot was skipped with matplotlib installed: {skipped}")
        sizes = {p.name: p.stat().st_size if p.exists() else 0 for p in pngs}
        check(all(s > 4000 for s in sizes.values()), f"PNG sizes {sizes}")
        numbers["plots"] = sizes
    else:
        check(len(skipped) == 2 and all("matplotlib" in ln for ln in skipped),
              f"without matplotlib the skipped lines are {skipped}")
        numbers["plots"] = "not rendered: no matplotlib"
    numbers["phase_s"] = time.time() - t_phase
    log(f"[surface] {json.dumps(numbers)}")
    check(numbers["phase_s"] <= 120, f"phase 6b took {numbers['phase_s']:.1f} s, over 120")
    return numbers


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
    only_infonce = "--infonce-only" in sys.argv[1:]
    only_triplet = "--triplet-only" in sys.argv[1:]
    built = _build.build(*(["infonce"] if only_infonce else
                           ["triplet_loss", "sorted_index_add"] if only_triplet else
                           [*KERNEL_ROWS, "graphcore"]))
    for kname, path in built.items():
        log(f"[build] {kname}: {path.name} in {time.time() - t0:.1f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Performance Loss" in line):
                log(f"[build]   {line.strip()}")
            elif "Compiling entry function" in line:
                log(f"[build]   {line.strip()[:120]}")

    if "--mesh-only" in sys.argv[1:]:
        return mesh_cards_only(t_start, smi)
    if only_infonce:
        infonce_phase(smi, bf16_flops)
        log(f"[done] infonce only: {time.time() - t_start:.1f} s")
        return 0
    if only_triplet:
        triplet_phase(smi, bw)
        log(f"[done] triplet only: {time.time() - t_start:.1f} s")
        return 0

    # 3. kernels against their plain versions
    kernel_err = kernel_phase()
    bpr_err = bpr_kernel_phase(bw)
    scatter_err = scatter_kernel_phase()
    ell_err = ell_kernel_phase()
    block_err = mips_block_phase()
    infonce_phase(smi, bf16_flops)
    triplet_phase(smi, bw)
    if "--kernels-only" in sys.argv[1:]:
        log(f"[done] kernels only: {time.time() - t_start:.1f} s")
        return 0

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        # 4. the serving path at ML-25M width
        t0 = time.time()
        full_graph = dict(num_users=FULL["users"], num_items=FULL["items"],
                          num_interactions=FULL["interactions"], seed=SEED,
                          power=FULL["power"], num_communities=FULL["communities"])
        data = make_synthetic_movielens(**full_graph)
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
        n_local, width = cc.u_pad + cc.i_pad, cc.user_local.shape[1]
        compact_shapes = dict(u_pad=cc.u_pad, i_pad=cc.i_pad, b_pad=width,
                              num_clusters=cc.num_clusters)
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
                epoch_s=t_epoch, step_ms=1e3 * t_epoch / cc.num_clusters,
                busy_ms_per_step=prof["busy_ms"] / 10,
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

        # 5g. the compact trainer's frozen boundary correction
        correction_phase(data, train_e, cfg, cc, cc_seg, state, copy, smi, bw,
                         next(r for r in rows if r["name"] == "ell_spmm"))

        # 5h. the full-node trainer's fused epoch, captured as a CUDA graph
        fnp = fullnode_phase(data, parts, val, test, copy, smi, bw)
        del parts
        sc_row = next(r for r in rows if r["name"] == "sorted_index_add")
        sc_row["max_abs_err"] = max([sc_row["max_abs_err"]] + [
            h["max_abs_err"] for h in fnp["holds"] if h["max_abs_err"] is not None])
        sc_row.update(fullnode_epoch=dict(
            launches_per_step=fnp["sorted_index_add_per_step"],
            train_model_launches=fnp["train_model_launches"].get("sorted_index_add", 0),
            captured_step_ms=fnp["epochs"]["captured"]["step_ms"],
            eager_step_ms=fnp["epochs"]["eager"]["step_ms"], held=fnp["holds"]))

        # 5e. the multi-device slice on a one-rank NCCL group
        mesh_phase(data, train_e, val_e, test_e, cfg, cc, val, test, smi)
        del cc, val, test

        # 5f. the sharded hybrid path at the JAX package's bench configuration
        shp = sharded_hybrid_phase(data, fgp["train_e"], smi, bw,
                                   next(r for r in rows if r["name"] == "ell_spmm"))
        del fgp

        # 7r. the epochs' floors at measured row-op rates, against 5a's and 5f's
        roofline_phase(compact_shapes, data.num_users, data.num_items, timings, shp, smi)

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
        del index, tindex

        # 6b. the user-facing surface at ML-25M width; B1's row gains its
        # check at the ML-25M CLI's widest cluster
        surface = surface_phase(data, trained, params0, smi)
        b1_row = next(r for r in rows if r["name"] == "bpr_tile")
        b1_row["max_abs_err"] = max(b1_row["max_abs_err"], surface["b1_check"]["max_abs_err"])
        b1_row["ml25m_cli"] = dict(surface["b1_check"], launches=surface["b1_launches"])

        # 6c. the four example drivers in this process, each kernel they
        # launch held at the shapes they gave it
        examples_phase(data, full_graph, rows, smi, bw)
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
