#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
     power limit;
  2. build every kernel from the sources in this checkout (one ``nvcc`` per
     source, started together);
  3. each kernel against its plain PyTorch version. ``score_chunkmax``: random
     normalized inputs, d in {64, 128, 256}, ragged N, masks none / int8 /
     packed, bf16 and f32. ``bpr_tile``: d in {16, 64, 128, 256}, both losses,
     ragged B, negatives all / none / partly in the cluster, one user in most
     triplets, a masked tail, four negatives per positive, and the run-to-run
     difference of two launches (the table gradients are summed by atomics);
  4. the serving path at ML-25M width (``bench.py``'s ``SCALES["full"]``:
     162,541 users x 59,047 items, 18 M sampled interactions, d = 64): split,
     seeded random weights through save/load, ``ServingIndex.build`` over
     the train split, 32,768-user masked ``batch_recommend`` dispatches;
     1,024 of the served users are held against the plain version;
  5. the training path at the same width, on the same graph and split: 100
     greedy clusters, compact clusters, dense bf16 adjacency blocks where
     they fit the configured width (the segment path otherwise), then
     ``train_model`` for 2 epochs (compact trainer, fused BPR kernel, Adam,
     L = 3, d = 64) with the best-val checkpoint; one cluster's gradients
     through the kernel against the plain route; a third, timed epoch and a
     profiled window of steps;
  6. trained -> served: the checkpoint of phase 5 behind the ``ServingIndex``
     for one 32,768-user dispatch; then the CLI at a small synthetic size:
     ``train --fused-bpr --epochs 1`` and the three ``recommend`` modes;
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
import subprocess
import sys
import time
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
#: the training path: reference defaults (100 clusters, L = 3, d = 64)
TRAIN = dict(clusters=100, layers=3, epochs=2)
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
}


def check(cond, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
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


def kernel_phase() -> float:
    """Phase 3: kernel vs plain version at three depths, ragged N, three mask
    modes, two score types. Returns the largest |kernel - plain| score."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import normalize_embedding
    from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_mips import (
        mips_topk_fused, score_chunkmax, score_chunkmax_plain)
    from movie_recommender_system_with_gnns_tpu_torch.ops.topk import (
        NEG_INF, pack_mask_tiles)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    nq, n, n_tile, k = 1000, 3001, 2048, TOP_K
    qp, np_ = 1024, 4096
    worst = 0.0
    for d in (64, 128, 256):
        q = torch.randn(nq, d, device="cuda", generator=gen)
        c = torch.randn(n, d, device="cuda", generator=gen)
        dense = torch.rand(nq, n, device="cuda", generator=gen) < 0.1
        rows, cols = dense.nonzero(as_tuple=True)
        packed = pack_mask_tiles(rows, cols, nq, n, n_tile)
        int8 = dense.to(torch.int8)
        for dtype in (torch.bfloat16, torch.float32):
            qn = torch.nn.functional.pad(normalize_embedding(q).to(dtype), (0, 0, 0, qp - nq))
            cn = torch.nn.functional.pad(normalize_embedding(c).to(dtype), (0, 0, 0, np_ - n))
            for mode in ("none", "int8", "packed"):
                what = f"d={d} {str(dtype)[6:]} mask={mode}"
                kw = {}
                if mode == "int8":
                    kw["mask"] = torch.nn.functional.pad(int8, (0, np_ - n, 0, qp - nq))
                elif mode == "packed":
                    kw["mask_packed"] = torch.nn.functional.pad(packed, (0, 0, 0, qp - nq))
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
                banned = (torch.nn.functional.pad(int8, (0, np_ - n, 0, qp - nq)) != 0
                          if mode != "none" else None)
                neg = torch.tensor(NEG_INF, dtype=dtype).item()
                pad_ok = bool((a[:, n:] == neg).all())
                mask_ok = banned is None or bool((a[banned] == neg).all())
                check(pad_ok and mask_ok, f"{what}: pad or masked column not NEG_INF")
                worst = max(worst, err.max().item())
                # top-k through the whole fused lane vs its plain run on the host
                mk = {} if mode == "none" else (
                    {"exclude_mask": int8} if mode == "int8" else
                    {"exclude_mask_packed": packed})
                s_t, i_t = mips_topk_fused(q, c, k=k, score_dtype=dtype, **mk)
                s_r, i_r = mips_topk_fused(q.cpu(), c.cpu(), k=k + 1, score_dtype=dtype,
                                           **{key: v.cpu() for key, v in mk.items()})
                swaps = check_topk(s_t.cpu(), i_t.cpu(), s_r, i_r, dtype, d, what)
                check(bool((i_t < n).all()), f"{what}: a pad column was returned")
                if mode != "none":
                    check(not bool(dense.gather(1, i_t).any()),
                          f"{what}: an excluded item was returned")
                log(f"[kernel] {what}: max |s - plain| {err.max().item():.3e}, "
                    f"cm exact, top-{k} ok ({swaps} rows with near-tie swaps)")
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


def profile_window(what: str, reps: int, top: int, fn) -> None:
    """Run ``fn`` ``reps`` times under torch.profiler and print the wall time,
    the device-busy time and the kernels that take most of it, per repeat."""
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


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def bpr_inputs(gen, d, u_pad, i_pad, b, neg_mode, dup=False, kneg=1):
    """Random inputs of ``bpr_tile`` on the card: a masked tail of b // 5
    triplets; ``dup`` puts one user into about 70 % of them."""
    dev = "cuda"
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen) * 0.1
    ints = lambda hi, n: torch.randint(0, hi, (n,), device=dev, generator=gen,
                                       dtype=torch.int32)
    u_tab, i_tab = rnd(u_pad, 2 * d), rnd(i_pad, 2 * d)
    ul, pl = ints(u_pad, b), ints(i_pad, b)
    if dup:
        ul = torch.where(torch.rand(b, device=dev, generator=gen) < 0.7,
                         torch.full_like(ul, 3), ul)
    m = torch.ones(b, dtype=torch.int32, device=dev)
    m[b - b // 5:] = 0
    if kneg > 1:
        ul, pl, m = (t.repeat_interleave(kneg) for t in (ul, pl, m))
    n = b * kneg
    loc = ints(i_pad, n)
    inc = {"all": torch.ones(n, dtype=torch.int32, device=dev),
           "none": torch.zeros(n, dtype=torch.int32, device=dev),
           "mixed": ints(2, n)}[neg_mode]
    return u_tab, i_tab, rnd(n, d), ul, pl, loc, inc, m


def check_bpr(args, what: str, **kw):
    """``bpr_tile`` against its plain version on the same tensors: loss within
    1e-5 relative, gradients within 1e-4 of the plain autograd gradients'
    largest entry, masked rows' gni exactly zero. Returns (largest abs error,
    largest difference between two launches)."""
    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr

    out_k = cuda_bpr.bpr_tile(*args, **kw)
    again = cuda_bpr.bpr_tile(*args, **kw)
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
    rerun = max((a - b).abs().max().item() for a, b in zip(out_k[1:3], again[1:3]))
    return worst, rerun


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


def time_bpr(args, iters: int = 20, **kw) -> dict:
    """Four times (ms per call) of ``bpr_tile`` on these inputs.

    ``device``: what the card spends on one call of the wrapper, summed by the
    profiler over everything the call enqueues (the fill of the zeroed loss
    and gradient tables, the three small launches that make the weights, the
    kernel). ``kernel``: the kernel's share of that. ``wrapper``: CUDA events
    around ``iters`` calls of the wrapper. ``launch``: CUDA events around
    ``iters`` calls of the bare launch function on buffers allocated once.
    The last two hold the host's time to enqueue the work whenever the card
    finishes it sooner, as it does here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from movie_recommender_system_with_gnns_tpu_torch.ops import cuda_bpr

    call = lambda: cuda_bpr.bpr_tile(*args, **kw)
    wrapper_ms = time_ms(call, iters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    dev = [(e.self_device_time_total, e.key) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    kernel_us = sum(us for us, key in dev if "bpr_tile_kernel" in key)
    check(kernel_us > 0, "the profiler recorded no bpr_tile kernel")

    u_tab, i_tab, ni = args[:3]
    w = cuda_bpr._weights(args[7], ni.shape[1], kw["bpr_coeff"], kw["loss"])
    out = torch.zeros(1, device="cuda")
    gu, gi, gni = (torch.zeros_like(t) for t in (u_tab, i_tab, ni))
    launch_ms = time_ms(lambda: cuda_bpr._launch(*args, w, out, gu, gi, gni,
                                                 kw["scale"], kw["loss"]), iters)
    return dict(device=sum(us for us, _ in dev) / (1e3 * iters),
                kernel=kernel_us / (1e3 * iters), wrapper=wrapper_ms,
                launch=launch_ms)


def bpr_kernel_phase() -> float:
    """Phase 3, kernel B1: every d, both losses, the three negative mixes,
    then heavy duplication and four negatives per positive; B is ragged
    (not a multiple of the block's 8 triplets) and has a masked tail."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = 0.0
    for d in (16, 64, 128, 256):
        scale = 1.0 / 16.0
        errs, reruns, n = [], [], 0
        for loss in ("reference", "standard"):
            kw = dict(scale=scale, bpr_coeff=5e-3, loss=loss)
            cases = [dict(neg_mode=mode) for mode in ("all", "none", "mixed")]
            cases += [dict(neg_mode="mixed", dup=True), dict(neg_mode="mixed", kneg=4)]
            for case in cases:
                args = bpr_inputs(gen, d, u_pad=384, i_pad=640, b=4099, **case)
                e, r = check_bpr(args, f"bpr_tile d={d} {loss} {case}", **kw)
                errs.append(e)
                reruns.append(r)
                n += 1
        worst = max(worst, max(errs))
        log(f"[kernel] bpr_tile d={d}: {n} cases agree with the plain version "
            f"(max abs err {max(errs):.3e}; two launches differ by at most "
            f"{max(reruns):.3e} in gu/gi)")
    return worst


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
        _build, bpr, cuda_bpr, cuda_mips)
    from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import sample_negative
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
        _MASK_TILE, ServingIndex)
    from movie_recommender_system_with_gnns_tpu_torch.training import compact
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_params, save_params)
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
        densify_if_fits)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        build_eval_batch, create_train_state, epoch_generator, loss_and_grads,
        train_model)

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
    built = _build.build(*KERNEL_ROWS)
    for kname, path in built.items():
        log(f"[build] {kname}: {path.name} in {time.time() - t0:.1f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")

    # 3. kernels against their plain versions
    kernel_err = kernel_phase()
    bpr_err = bpr_kernel_phase()

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
        check(serve_launches.get("score_chunkmax", 0) > 0,
              "score_chunkmax never launched on the serving path")

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
        log(f"[train] {cc.num_clusters} clusters: u_pad {cc.u_pad}, i_pad {cc.i_pad}, "
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
        check(all(np.isfinite(v) for key in hist for v in hist[key]),
              f"a loss or metric is not finite: {hist}")
        check(hist["train_loss"][1] < hist["train_loss"][0],
              f"train loss did not fall: {hist['train_loss']}")
        check(state.step == steps, f"state.step {state.step} != {steps}")
        check(bool(saved) and Path(cfg.train.checkpoint_path).exists(),
              "no best-val checkpoint was written")
        log(f"[train] train loss {hist['train_loss']}, val loss {hist['val_loss']}, "
            f"val recall {hist['val_recall']}, test recall {hist['test_recall']}")

        # one cluster's gradients: the kernel route against the plain route
        cfg_plain = cfg.replace(train=TrainConfig(fused_bpr=False))
        adj_of = lambda c: None if cc.adj is None else cc.adj[c]
        gen_c = torch.Generator(device="cuda").manual_seed(SEED + 2)
        c_id = 7
        neg = sample_negative(gen_c, width, data.num_items)
        l_k, g_k = loss_and_grads(compact.compact_cluster_loss, state.params,
                                  cc.cluster(c_id), neg, cfg, cc.u_pad, cc.i_pad,
                                  adj_of(c_id))
        l_p, g_p = loss_and_grads(compact.compact_cluster_loss, state.params,
                                  cc.cluster(c_id), neg, cfg_plain, cc.u_pad,
                                  cc.i_pad, adj_of(c_id))
        ru, ri = rel_max(g_k.user_emb, g_p.user_emb), rel_max(g_k.item_emb, g_p.item_emb)
        check(abs(l_k.item() - l_p.item()) <= 1e-5 * abs(l_p.item()) and ru < 1e-4
              and ri < 1e-4, f"cluster {c_id}: kernel route loss {l_k.item()!r} vs "
              f"plain {l_p.item()!r}, grad rel err user {ru:.3e} item {ri:.3e}")
        log(f"[train] cluster {c_id} step gradients, kernel route vs plain route: "
            f"loss {l_k.item():.6f} vs {l_p.item():.6f}, rel err user {ru:.3e}, "
            f"item {ri:.3e}")
        del g_k, g_p

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
        l_s, g_s = loss_and_grads(compact.compact_cluster_loss, state.params,
                                  cc.cluster(c_id), neg, cfg_plain, cc.u_pad,
                                  cc.i_pad, None)
        ri = rel_max(g_d.item_emb, g_s.item_emb)
        check(abs(l_d.item() - l_s.item()) < 5e-4 and ri < 5e-2,
              f"dense bf16 adjacency vs segment path: loss {l_d.item()!r} vs "
              f"{l_s.item()!r}, item grad rel err {ri:.3e}")
        log(f"[train] cluster {c_id}, dense bf16 adjacency vs segment path: loss "
            f"{l_d.item():.6f} vs {l_s.item():.6f}, item grad rel err {ri:.3e}")
        del one, g_d, g_s

        # a third epoch, timed alone (no eval), then a profiled window of steps
        epoch_fn = compact.make_compact_epoch_fn(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss3 = epoch_fn(state, cc, epoch_generator(cfg, TRAIN["epochs"],
                                                           torch.device("cuda")))
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        check(np.isfinite(loss3), "third epoch's loss is not finite")
        log(f"[train] epoch 3 alone: {t_epoch:.3f} s per epoch, "
            f"{1e3 * t_epoch / cc.num_clusters:.3f} ms per step, train loss {loss3:.4f}")
        gen_p = torch.Generator(device="cuda").manual_seed(SEED + 3)
        st = [state]

        def ten_steps():
            st[0], _ = epoch_fn(st[0], cc, gen_p, perm=list(range(10)))

        profile_window("10 train steps", 2, 14, ten_steps)
        state = st[0]

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
        kw = dict(scale=scale, bpr_coeff=cfg.train.bpr_coeff, loss="reference")
        b1_err, b1_rerun = check_bpr(kargs, f"bpr_tile at cluster {c_id}'s shape", **kw)
        b1 = time_bpr(kargs, **kw)
        b1_plain = time_ms(lambda: cuda_bpr.bpr_tile_plain(*kargs, **kw), 5, warmup=1)
        valid, in_cl = int(mask.sum()), int((inc & mask).sum())
        d = FULL["dim"]
        b1_bound, b1_by, byts, flops = bpr_bound(kargs, bw)
        log(f"[kernel] bpr_tile at (u_pad {cc.u_pad}, i_pad {cc.i_pad}, B {width} "
            f"of which {valid} valid and {in_cl} negatives in the cluster, d={d}): "
            f"{b1['device']:.4f} ms of device time per wrapper call (profiler: "
            f"zero fill, weight ops and the kernel), of which the kernel "
            f"{b1['kernel']:.4f} ms; {b1['wrapper']:.4f} ms per wrapper call and "
            f"{b1['launch']:.4f} ms per bare launch by CUDA events (both "
            f"host-bound); plain forward+backward {b1_plain:.4f} ms; bound "
            f"{b1_bound:.4f} ms ({b1_by}: {byts / 1e6:.2f} MB, "
            f"{flops / 1e6:.1f} MFLOP), {b1_bound / b1['device']:.3f} of the "
            f"bound ({b1_bound / b1['kernel']:.3f} for the kernel alone); max abs "
            f"err {b1_err:.3e}, two launches differ by {b1_rerun:.3e} (phase 3 "
            f"max err {bpr_err:.3e})")
        # the kernel's reference shape, the width a refined partition gives
        # (about 40 % of the edges kept in 100 clusters): random inputs, every
        # triplet valid
        wide = list(bpr_inputs(gen_c, d, u_pad=1792, i_pad=1152, b=40_960,
                               neg_mode="mixed"))
        wide[7] = torch.ones_like(wide[7])
        wide[6] = (torch.rand(40_960, device="cuda", generator=gen_c) < 0.02).to(torch.int32)
        check_bpr(wide, "bpr_tile at the reference shape", **kw)
        wt = time_bpr(wide, **kw)
        w_bound, w_by, wb, wf = bpr_bound(wide, bw)
        log(f"[kernel] bpr_tile at its reference shape (u_pad 1792, i_pad 1152, "
            f"B 40960 all valid, 2 % of the negatives in the cluster, d={d}, "
            f"random inputs): {wt['device']:.4f} ms of device time per wrapper "
            f"call, of which the kernel {wt['kernel']:.4f} ms; "
            f"{wt['wrapper']:.4f} ms per wrapper call and {wt['launch']:.4f} ms "
            f"per bare launch by CUDA events; plain "
            f"{time_ms(lambda: cuda_bpr.bpr_tile_plain(*wide, **kw), 5, warmup=1):.4f} ms; "
            f"bound {w_bound:.4f} ms ({w_by}: {wb / 1e6:.2f} MB, "
            f"{wf / 1e6:.1f} MFLOP), {w_bound / wt['device']:.3f} of the bound")
        del wide
        rows.append(dict(name="bpr_tile", **KERNEL_ROWS["bpr_tile"],
                         launches=train_launches["bpr_tile"], max_abs_err=b1_err,
                         ms=b1["device"], plain_ms=b1_plain, bound_ms=b1_bound,
                         bound_by=b1_by, library_ms=None,
                         ms_method="device time of one wrapper call, torch.profiler",
                         kernel_ms=b1["kernel"], wrapper_ms=b1["wrapper"],
                         launch_ms=b1["launch"]))
        del cc, val, test, kargs, u_tab, i_tab, ni, acc, final

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
        for extra in (["train", "--fused-bpr"],
                      ["recommend", "--user-id", str(int(small.user_ids[0]))],
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
              and meet_launches.get("score_chunkmax", 0) >= 2,
              "the CLI phase did not go through both kernels")
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
