#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
     power limit;
  2. build every kernel of the serving path from the sources in this checkout;
  3. each kernel against its plain PyTorch version on random normalized
     inputs: d in {64, 128, 256}, ragged N, masks none / int8 / packed, bf16
     and f32;
  4. the serving path at ML-25M width (``bench.py``'s ``SCALES["full"]``:
     162,541 users x 59,047 items, 18 M sampled interactions, d = 64): split,
     seeded random weights through save/load, ``ServingIndex.build`` over
     the train split, 32,768-user masked ``batch_recommend`` dispatches, and
     the CLI's ``--user-id``, ``--movie-id`` and ``--users-file`` modes;
     1,024 of the served users are held against the plain version;
  5. each kernel timed at the serving shape beside its plain version, one
     library call and its bound.

Prints the card's ``nvidia-smi`` line and a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line. Exits non-zero when CUDA is not available.
"""

from __future__ import annotations

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
KERNEL_ROWS = {
    "score_chunkmax": dict(
        route="cuda",
        source="movie_recommender_system_with_gnns_tpu_torch/csrc/score_chunkmax.cu",
        replaces="movie_recommender_system_with_gnns_tpu/ops/pallas_mips.py:140"),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from movie_recommender_system_with_gnns_tpu_torch import cli
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import init_params
    from movie_recommender_system_with_gnns_tpu_torch.ops import _build, bpr, cuda_mips
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
        _MASK_TILE, ServingIndex)
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (
        load_params, save_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

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

    # 4. the serving path at ML-25M width
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        t0 = time.time()
        data = make_synthetic_movielens(
            FULL["users"], FULL["items"], FULL["interactions"], seed=SEED,
            power=FULL["power"], num_communities=FULL["communities"])
        train_e, _, _ = split_edges(data, str(WORK / "indexes"), seed=SEED)
        log(f"[path] graph {data.num_users} users x {data.num_items} items, "
            f"{data.edge_index.shape[1]} directed edges, train {train_e.shape[1]}: "
            f"{time.time() - t0:.1f} s")
        check(data.num_users == FULL["users"] and data.num_items == FULL["items"],
              "synthetic graph lost users or items")
        gen = torch.Generator().manual_seed(SEED)
        params0 = init_params(data.num_users, data.num_items, FULL["dim"],
                              generator=gen, device="cuda")
        ckpt = WORK / "model.npz"
        save_params(str(ckpt), params0, meta={"seed": SEED})
        params, meta = load_params(str(ckpt), device="cuda")
        check(torch.equal(params.user_emb, params0.user_emb)
              and torch.equal(params.item_emb, params0.item_emb)
              and meta == {"seed": SEED}, "checkpoint round trip changed the tables")

        cuda_mips.LAUNCHES.clear()
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
        steady = sorted(times[1:])
        ms = 1e3 * steady[len(steady) // 2]
        log(f"[path] batch_recommend {DISPATCH} users, top-{TOP_K}, masked: "
            f"{ms:.3f} ms per dispatch (median of {len(steady)}; all "
            f"{[round(1e3 * t, 3) for t in times]} ms), "
            f"{DISPATCH / ms * 1e3:.0f} queries/s")

        cli_base = ["--device", "cuda", "--dataset", "synthetic",
                    "--synthetic-users", str(FULL["users"]),
                    "--synthetic-items", str(FULL["items"]),
                    "--synthetic-interactions", str(FULL["interactions"]),
                    "--synthetic-communities", str(FULL["communities"]),
                    "--synthetic-power", str(FULL["power"]),
                    "--indexes-dir", str(WORK / "indexes"),
                    "--checkpoint", str(ckpt), "recommend"]
        users_file = WORK / "users.txt"
        batch_raw = data.raw_user_id(perm[:2048])
        users_file.write_text("\n".join(map(str, batch_raw)) + "\n999999999\n")
        for extra in (["--user-id", str(int(data.user_ids[0]))],
                      ["--movie-id", str(int(data.movie_ids[0]))],
                      ["--users-file", str(users_file), "--out", str(WORK / "recs.csv")]):
            t0 = time.time()
            rc = cli.main(cli_base + extra)
            check(rc == 0, f"cli recommend {extra[0]} exited {rc}")
            log(f"[path] cli recommend {extra[0]}: rc 0 in {time.time() - t0:.1f} s")
        lines = (WORK / "recs.csv").read_text().splitlines()
        check(len(lines) == 1 + 2048 * TOP_K, f"recs.csv has {len(lines)} lines")
        torch.cuda.synchronize()
        launches = dict(cuda_mips.LAUNCHES)
        log(f"[path] kernel launches on the main path: {launches}")
        for kname in KERNEL_ROWS:
            check(launches.get(kname, 0) > 0, f"{kname} never launched on the main path")

        # outputs: shape, finite, sorted, valid, not train-seen, plain agreement
        for users, s, i in outs:
            check(s.shape == (len(users), TOP_K) and i.shape == s.shape, "output shape")
            check(bool(torch.isfinite(s).all()) and bool((s > -1.0001).all()),
                  "non-finite or masked score served")
            check(bool((s[:, :-1] >= s[:, 1:]).all()), "scores not descending")
            check(bool(((i >= 0) & (i < data.num_items)).all()), "item out of range")
            rows = index.mask[torch.as_tensor(users, device="cuda")]
            seen = cuda_mips.unpack_mask_tiles(rows, _MASK_TILE).gather(1, i)
            check(not bool(seen.any()), "a train-seen item was served")
        users, s, i = outs[1]
        sub = torch.as_tensor(users[:1024])
        s_r, i_r = cuda_mips.mips_topk_fused(
            params.user_emb.cpu()[sub], params.item_emb.cpu(), k=TOP_K + 1,
            n_tile=_MASK_TILE, exclude_mask_packed=index.mask.cpu()[sub])
        swaps = check_topk(s[:1024].cpu(), i[:1024].cpu(), s_r, i_r,
                           torch.bfloat16, FULL["dim"], "main path vs plain")
        log(f"[path] 1024 served users agree with the plain version "
            f"({swaps} rows with near-tie swaps)")

        # where a dispatch's device time goes (profiler over 3 dispatches)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                index.batch_recommend(users, top_k=TOP_K)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        dev = sorted(((e.self_device_time_total / 3e3, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
        busy = sum(ms for ms, _ in dev)
        log(f"[trace] per dispatch under the profiler: wall {wall_ms:.3f} ms, device "
            f"busy {busy:.3f} ms (idle share {1 - busy / wall_ms:.3f})")
        for ms, key in dev[:8]:
            log(f"[trace]   {ms:.4f} ms  {key[:100]}")

        # 5. the kernel at the serving shape: time, plain, library, bound
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
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    log(f"[done] {time.time() - t_start:.1f} s")
    log(smi)
    row = dict(name="score_chunkmax", **KERNEL_ROWS["score_chunkmax"],
               launches=launches["score_chunkmax"], max_abs_err=main_err,
               ms=k_ms, plain_ms=p_ms, bound_ms=bound,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=lib_ms)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
