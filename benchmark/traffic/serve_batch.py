"""Traffic kind ``serve_batch``: a closed loop of one client sending batch
dispatches, each ``dispatch_users`` users taken as consecutive slices of a
seeded permutation of all users (wrapping round, so every dispatch has the
same size), the way a nightly refresh recomputes every user's list.

Entry: ``serving/recommend.py::ServingIndex.build`` at set-up, then
``ServingIndex.batch_recommend`` in the window; a dispatch ends when its
top-k ids and scores are on the host. The tables are drawn on the card from
the seed (N(0, init_std²), the model's init law); the train-seen sets are the
configuration's train split; the configuration's ``serve.normalize`` picks
cosine (true) or dot-product (false) scores.

Correctness: ``check_rows`` rows of every dispatch, chosen from the seed, are
kept and judged after the window against the float32 reference
(``reference/serve.py``). A dispatch that returns another shape, or raises,
counts as failed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import dataset
from benchmark.harness import Context, Result, check_limits, free_device
from benchmark.reference import serve as ref


def _tables(ctx: Context, num_users: int, num_items: int):
    model = ctx.config["model"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    d, std = model["dim"], model["init_std"]
    tab = torch.randn((num_users + num_items, d), generator=gen, device=ctx.device) * std
    return tab[:num_users], tab[num_users:]


def run(ctx: Context) -> Result:
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import ServingIndex

    p = ctx.params
    q_n, k = p["dispatch_users"], p["top_k"]
    normalize = bool(ctx.config["serve"]["normalize"])
    data = dataset.load(ctx)
    num_users, num_items, train = data["num_users"], data["num_items"], data["train"]
    user_tab, item_tab = _tables(ctx, num_users, num_items)
    rng = np.random.default_rng(ctx.seed)
    order = rng.permutation(num_users)

    with ctx.spans("setup.port", sync=True):
        index = ServingIndex.build(LightGCNParams(user_tab, item_tab), train, num_users)
    if ctx.mode == "control":
        seen = ref.seen_csr(train, num_users)
        serve = lambda users: ref.serve_topk(user_tab, item_tab, users, seen, k, "fp8",
                                             normalize)
    else:
        serve = lambda users: index.batch_recommend(users, top_k=k, normalize=normalize)

    # the permutation with its head repeated after its tail: every dispatch's
    # users are one slice of it, taken with no copy
    ring = np.concatenate([order, np.resize(order, q_n)])

    def users_of(i: int) -> np.ndarray:
        lo = (i * q_n) % num_users
        return ring[lo:lo + q_n]

    # the client receives each dispatch's answers into page-locked buffers
    pinned = ctx.device.type == "cuda"
    host_s = torch.empty((q_n, k), dtype=torch.float32, pin_memory=pinned)
    host_ids = torch.empty((q_n, k), dtype=torch.int64, pin_memory=pinned)
    def receive(s, ids) -> bool:
        """Copy a dispatch's answers to the host; False if it has another shape."""
        if ids.shape != (q_n, k) or s.shape != (q_n, k):
            return False
        with ctx.spans("to_host"):
            host_s.copy_(s)
            host_ids.copy_(ids)
        return True

    for i in range(p.get("warmup_dispatches", 2)):
        receive(*serve(users_of(i)))
    gc.collect()
    ctx.sync()
    setup_s = ctx.since_start()

    check_rng = np.random.default_rng([ctx.seed, 1])
    kept_users, kept_ids, kept_scores = [], [], []
    lat, failed = [], 0
    cap = p["trace_dispatches"] if ctx.trace else None
    prof = None
    if ctx.trace:
        from benchmark.trace import Profiled

        prof = Profiled().__enter__()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.disable()
    t_start = time.perf_counter()
    i = 0
    while True:
        users = users_of(i)
        t0 = time.perf_counter()
        try:
            with ctx.spans("dispatch"):
                s, ids = serve(users)
            answered = receive(s, ids)
        except RuntimeError:
            answered = False
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        pos = check_rng.integers(0, q_n, size=p["check_rows"])
        if not answered:
            failed += 1
        else:
            kept_users.append(users[pos])
            kept_ids.append(host_ids.numpy()[pos])
            kept_scores.append(host_s.numpy()[pos])
        i += 1
        if t1 - t_start >= ctx.seconds or (cap is not None and i >= cap):
            break
    window_s = time.perf_counter() - t_start
    gc.enable()
    torch.set_num_threads(threads)
    if prof is not None:
        prof.__exit__(None, None, None)
    ctx.sync()
    memory_peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0

    info = {"dispatches": i, "queries": q_n, "items": num_items,
            "dim": ctx.config["model"]["dim"],
            "host_ms": [x * 1e3 for x in ctx.spans.durations("dispatch")],
            "setup_port_s": ctx.spans.total("setup.port"),
            "checked_rows": int(sum(len(u) for u in kept_users))}
    del index, serve
    free_device()
    seen = ref.seen_csr(train, num_users)
    if kept_users:
        numbers = ref.judge(user_tab, item_tab, np.concatenate(kept_users),
                            np.concatenate(kept_ids), np.concatenate(kept_scores), seen, k,
                            normalize)
    else:
        numbers = {"invalid_rows": float(q_n), "rank_gap": 0.0, "score_gap": 0.0}
    info["numbers"] = numbers
    checks, ok = check_limits(numbers, ctx.workload["limits"])
    lat_ms = np.asarray(lat) * 1e3
    e2e = {"setup_s": (setup_s, "s"),
           "serve_qps": (q_n * (i - failed) / window_s, "queries/s"),
           "serve_p95_ms": (float(np.quantile(lat_ms, 0.95)), "ms")}
    return Result(end_to_end=e2e, attempted=i, failed=failed, checks=checks,
                  correct=ok and failed == 0, memory_peak_bytes=memory_peak, info=info,
                  trace=prof.trace if prof is not None else None,
                  window_s=window_s if prof is not None else 0.0)
