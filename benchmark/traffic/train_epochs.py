"""Traffic kind ``train_epochs``: a trainer's epochs back to back, no
evaluation in the window. The configuration's ``train.trainer`` picks the
entry:

  * ``fullgraph``: ``training/fullgraph.py::build_fullgraph_data`` at set-up
    (the hybrid blocks, the remainder's ELL, the positives), then the epoch
    function of ``make_fullgraph_epoch_fn``; each step propagates over the
    whole train graph;
  * ``full``: the train graph cut into parts by the benchmark's frozen
    partitioner (``benchmark/data/partition.py``), the parts padded by
    ``training/pipeline.py::build_cluster_batches`` and stacked
    (``StackedClusters``) at set-up, then the epoch function of
    ``training/train.py::make_epoch_fn`` (the captured step replayed once per
    cluster; one Adam step over the whole tables per cluster).

The tables are drawn on the card from the seed (N(0, init_std²)); every
epoch's order and negatives come from the benchmark's own sampler (a seeded
permutation; negatives uniform, or by the inverse of the popularity^power
law's distribution function), drawn for ``draw_epochs`` epochs at set-up
and cycled, and handed to the epoch function (``perm=``, ``neg=``). The
port's own sampler is therefore not in the window.

Correctness: the first epoch is checked. It is the window's own call on the
window's own objects (the whole ``FullGraphTrainData`` or the whole
``StackedClusters``, the first draw's order and negatives), run from the
seed's tables and a fresh optimizer state at set-up; it also warms the
window's shapes, and for the full-node trainer it captures the step that the
window replays (the epoch's first step runs eagerly, the other 99 replay the
capture). Its mean loss, Adam's first moment (every step's clipped gradient,
as the optimizer got it) and the tables' change after it are kept, and the
window runs on from that state. Once the window has closed and the port's
state is freed, the float32 reference (``reference/lightgcn.py``) runs every
step of that epoch from the same tables and triplets, and the three are
compared.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from benchmark import dataset
from benchmark.harness import BenchError, Context, Result, check_limits, free_device
from benchmark.reference import lightgcn as ref


def port_config(config: dict):
    from movie_recommender_system_with_gnns_tpu_torch.config import (Config, DataConfig,
                                                                     ModelConfig, TrainConfig)

    m, t = config["model"], config["train"]
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return Config(
        data=DataConfig(split_level=config["split"]),
        model=ModelConfig(num_layers=m["layers"], dim=m["dim"], init_std=m["init_std"],
                          readout=m["readout"]),
        train=TrainConfig(**{k: v for k, v in t.items() if k in fields}))


def forward_pairs(edges: np.ndarray, num_users: int):
    """(users, 0-based items) of the user→item edges, in edge order."""
    head, tail = edges[0], edges[1]
    fwd = (head < num_users) & (tail >= num_users)
    return head[fwd].astype(np.int64), (tail[fwd] - num_users).astype(np.int64)


def negative_cdf(ct: dict, train: np.ndarray, num_users: int, num_items: int,
                 device) -> torch.Tensor:
    """Distribution function of the configuration's negative law over items."""
    if ct["negatives"] == "popularity":
        w = np.bincount(forward_pairs(train, num_users)[1],
                        minlength=num_items).astype(np.float64) ** ct["negatives_power"]
    else:
        w = np.ones(num_items)
    return torch.from_numpy(np.cumsum(w / w.sum())).to(device)


def draw_epochs(gen: torch.Generator, order_len: int, neg_shape, cdf: torch.Tensor,
                epochs: int):
    """[(order (order_len,) int64, negatives ``neg_shape`` int32)] per epoch."""
    out = []
    for _ in range(epochs):
        perm = torch.randperm(order_len, generator=gen, device=gen.device)
        u = torch.rand(neg_shape, generator=gen, device=gen.device, dtype=torch.float64)
        neg = torch.searchsorted(cdf, u, right=True).clamp_max_(cdf.shape[0] - 1)
        out.append((perm, neg.to(torch.int32)))
    return out


class FullGraph:
    """The full-graph trainer: an epoch is ``num_steps`` steps over a shuffle
    of every train positive."""

    def __init__(self, ctx: Context, cfg, data: dict):
        from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph

        self.data, self.dev = data, ctx.device
        nu, n = data["num_users"], data["num_users"] + data["num_items"]
        fg = ctx.cache.get("fg")
        if fg is None:
            with ctx.spans("setup.port", sync=True):
                fg = fullgraph.build_fullgraph_data(cfg, data["train"], nu, n, ctx.device)
            if ctx.cache.get("keep_program"):
                ctx.cache["fg"] = fg
        self.fg = fg
        self.steps, self.batch, self.e_real = fg.num_steps, fg.batch, fg.e_real
        self.epoch_fn = fullgraph.make_fullgraph_epoch_fn(cfg, fg)
        if ctx.trace:
            _annotate_optimizer(self.epoch_fn)

    def draws(self, gen, cdf, k: int, epochs: int):
        return draw_epochs(gen, self.e_real, (self.steps, self.batch, k), cdf, epochs)

    def epoch(self, state, draw):
        return self.epoch_fn(state, self.fg, None, perm=draw[0], neg=draw[1])

    def reference_steps(self, draw, lowp: bool = False):
        d, b = self.data, self.batch
        adj = ref.build_adjacency(d["train"], d["num_users"] + d["num_items"], self.dev, lowp)
        users, items = (torch.from_numpy(x).to(self.dev)
                        for x in forward_pairs(d["train"], d["num_users"]))
        out = []
        for s in range(self.steps):
            sl = draw[0][s * b:(s + 1) * b]     # the last step's padding is masked
            out.append(ref.Step(adj, users[sl], items[sl], draw[1][s][:sl.shape[0]],
                                float(sl.shape[0])))
        return out

    def info(self, k: int, layers: int) -> dict:
        """Shapes for the work counters: each step's real pairs and row sums
        (the triplet rows' gradients, final and initial, into each table),
        the train edges, and the sparse remainder as the program laid it out."""
        b, s, d = self.batch, self.steps, self.data
        real = [b] * (s - 1) + [self.e_real - (s - 1) * b]
        ell = getattr(self.fg.hybrid, "off_ell", None)
        rem = {}
        if ell is not None:
            rem = {"edges": sum(int((blk.nbr != ell.num_src).sum()) for blk in ell.blocks),
                   "rows": sum(int(blk.node_ids.numel()) for blk in ell.blocks),
                   "num_src": int(ell.num_src), "num_nodes": int(ell.num_nodes)}
        sums = [(r, d["num_users"], 2) for r in real]
        sums += [(r * (1 + k), d["num_items"], 2) for r in real]
        return {"real_per_step": real, "edges_per_step": [int(d["train"].shape[1])] * s,
                "remainder": rem, "row_sums": sums}

    def free(self):
        del self.fg, self.epoch_fn


class FullNode:
    """The full-node trainer: an epoch is one step per cluster, in a shuffled
    order, each over the cluster's edges in the global id space."""

    def __init__(self, ctx: Context, cfg, data: dict):
        from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
            build_cluster_batches)
        from movie_recommender_system_with_gnns_tpu_torch.training.train import (
            StackedClusters, make_epoch_fn)

        from benchmark.data import partition

        ct, nu, ni = ctx.config["train"], data["num_users"], data["num_items"]
        self.dev = ctx.device
        cached = ctx.cache.get("clusters")
        if cached is None:
            with ctx.spans("setup.parts"):
                parts = [p for p in partition.cluster_edges(
                    data["train"], nu, ni, ct["num_clusters"], seed=0,
                    balance_tol=ct["partition_balance_tol"]) if p.shape[1] > 0]
            with ctx.spans("setup.port", sync=True):
                batches = build_cluster_batches(parts, nu, nu + ni,
                                                bucket_floor=ct["bucket_floor"],
                                                device=ctx.device)
                stacked = StackedClusters.from_batches(batches)
            cached = (parts, batches, stacked)
            if ctx.cache.get("keep_program"):
                ctx.cache["clusters"] = cached
        self.parts, self.batches, self.stacked = cached
        self.nu, self.n = nu, nu + ni
        self.steps = len(self.parts)
        self.batch = int(self.stacked.user.shape[1])
        self.e_real = int(self.stacked.mask.sum())
        self.epoch_fn = make_epoch_fn(cfg)

    def draws(self, gen, cdf, k: int, epochs: int):
        shape = (self.steps, self.batch) if k <= 1 else (self.steps, self.batch, k)
        return draw_epochs(gen, self.steps, shape, cdf, epochs)

    def epoch(self, state, draw):
        return self.epoch_fn(state, self.stacked, None, perm=draw[0], neg=draw[1])

    def reference_steps(self, draw, lowp: bool = False):
        out = []
        for s, c in enumerate(draw[0].tolist()):
            e = self.parts[c]
            users, items = (torch.from_numpy(x).to(self.dev) for x in forward_pairs(e, self.nu))
            # the epoch's mean loss weighs each cluster by its edges
            out.append(ref.Step(ref.build_adjacency(e, self.n, self.dev, lowp), users, items,
                                draw[1][s][:users.shape[0]], float(e.shape[1])))
        return out

    def info(self, k: int, layers: int) -> dict:
        """Shapes for the work counters: each cluster's real pairs and edges;
        a step's row sums are the propagation's (the cluster's real edges
        into every node, ``layers`` hops forward and as many backward) and
        the triplet rows' (final and initial, into each table)."""
        real = [int(b.batch.mask.sum()) for b in self.batches]
        edges = [int(b.num_edges) for b in self.batches]
        sums = [(e, self.n, 2 * layers) for e in edges]
        sums += [(r, self.nu, 2) for r in real]
        sums += [(r * (1 + k), self.n - self.nu, 2) for r in real]
        return {"real_per_step": real, "edges_per_step": edges, "row_sums": sums}

    def free(self):
        del self.parts, self.batches, self.stacked, self.epoch_fn


TRAINERS = {"fullgraph": FullGraph, "full": FullNode}


def run(ctx: Context) -> Result:
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (TrainState,
                                                                             make_optimizer)

    p, cm, ct = ctx.params, ctx.config["model"], ctx.config["train"]
    if ct.get("trainer") not in TRAINERS:
        raise BenchError(f"train_epochs drives {sorted(TRAINERS)}, not {ct.get('trainer')!r}")
    data = dataset.load(ctx)
    num_users, num_items = data["num_users"], data["num_items"]
    cfg = port_config(ctx.config)
    dev = ctx.device
    sut = TRAINERS[ct["trainer"]](ctx, cfg, data)
    k = ct["num_negatives"]

    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    tab = torch.randn((num_users + num_items, cm["dim"]), generator=gen, device=dev)
    tab *= cm["init_std"]
    user0, item0 = tab[:num_users].clone(), tab[num_users:].clone()
    del tab
    cdf = negative_cdf(ct, data["train"], num_users, num_items, dev)
    draws = sut.draws(gen, cdf, k, p["draw_epochs"])

    info = {"epochs": 0, "steps": 0, "dim": cm["dim"], "layers": cm["layers"],
            "negatives": k, "users": num_users, "items": num_items, "e_real": sut.e_real,
            **sut.info(k, cm["layers"])}
    e2e, memory_peak, prof, window_s, failed = {}, 0, None, 0.0, 0
    if ctx.mode == "control":
        low = ref.train_steps(user0, item0, sut.reference_steps(draws[0], lowp=True), cm, ct,
                              lowp=True)
        loss = sum(w * x for w, x in zip(low.weights, low.losses)) / sum(low.weights)
        mu = [float(m.double().norm()) for m in low.mu]
        change = [float(c.double().norm()) for c in low.change]
        del low
    else:
        opt = make_optimizer(cfg)
        params = LightGCNParams(user0.clone(), item0.clone())
        state = TrainState(params, opt.init(params), 0)
        # the checked epoch, which also warms the window up
        with ctx.spans("checked_epoch", sync=True):
            state, loss = sut.epoch(state, draws[0])
        mu = [float(m.double().norm()) for m in state.opt_state.mu]
        change = [float((x - x0).double().norm()) for x, x0 in zip(state.params, (user0, item0))]
        gc.collect()
        setup_s = ctx.since_start()

        if ctx.trace:
            from benchmark.trace import Profiled

            prof = Profiled().__enter__()
        cap = p["trace_epochs"] if ctx.trace else None
        epochs = 0
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        gc.disable()
        t_start = time.perf_counter()
        while True:
            with ctx.spans("epoch"):
                state, mean = sut.epoch(state, draws[(epochs + 1) % len(draws)])
            failed += 0 if math.isfinite(mean) else sut.steps
            epochs += 1
            window_s = time.perf_counter() - t_start
            if window_s >= ctx.seconds or (cap is not None and epochs >= cap):
                break
        gc.enable()
        torch.set_num_threads(threads)
        if prof is not None:
            prof.__exit__(None, None, None)
        memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        info.update(epochs=epochs, steps=epochs * sut.steps)
        e2e = {"setup_s": (setup_s, "s"),
               "train_pairs_per_s": (sut.e_real * epochs / window_s, "pairs/s")}
        del state, opt, params
    info["setup_port_s"] = ctx.spans.total("setup.port")
    checked = sut.reference_steps(draws[0])
    sut.free()
    del draws
    free_device()

    steps_ref = ref.train_steps(user0, item0, checked, cm, ct)
    numbers = ref.compare(loss, mu, change, steps_ref)
    info["numbers"] = numbers
    checks, ok = check_limits(numbers, ctx.workload["limits"])
    return Result(end_to_end=e2e, attempted=info["steps"], failed=failed, checks=checks,
                  correct=ok and failed == 0, memory_peak_bytes=memory_peak, info=info,
                  trace=prof.trace if prof is not None else None,
                  window_s=window_s if prof is not None else 0.0)


def _annotate_optimizer(epoch_fn) -> None:
    """Wrap the full-graph epoch function's optimizer update (the ``opt``
    its closure holds) in a ``bench.optimizer`` span, so the traced run can
    tell its kernels apart. An epoch function without one raises, rather
    than leave ``train.optimizer_ms`` with nothing to read."""
    cells = dict(zip(epoch_fn.__code__.co_freevars, epoch_fn.__closure__ or ()))
    cell = cells.get("opt")
    if cell is None or not hasattr(cell.cell_contents, "update"):
        raise BenchError("the full-graph epoch function holds no optimizer `opt` to "
                         "annotate, so train.optimizer_ms has nothing to read")
    opt = cell.cell_contents
    update = opt.update

    def traced(*a, **kw):
        with torch.profiler.record_function("bench.optimizer"):
            return update(*a, **kw)

    cell.cell_contents = opt._replace(update=traced)
