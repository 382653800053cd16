"""Traffic kind ``train_epochs_cl``: XSimGCL's full-graph epochs back to
back, no evaluation in the window.

It is ``train_epochs``' full-graph trainer (``FullGraph``: the port's
``build_fullgraph_data`` in a ``setup.port`` span, then the epoch function of
``make_fullgraph_epoch_fn``), with the model's noise: each drawn epoch's
order and negatives come from ``train_epochs.draw_epochs``, and then, from
the same generator, the raw U(0,1) noise of every step's hops, (steps, L, n,
d), all drawn on the card at set-up and handed to the epoch function
(``noise=``). The row normalisation, the sign and ε stay in the timed step.
At set-up each drawn step's distinct users and distinct positive items are
counted (``info["cl_rows"]``), and after the window those of the epochs it
ran (``info["window_cl_rows"]``) for the work counters.

Correctness as ``train_epochs``: the window's first epoch, run at set-up
from the seed's tables on the window's own objects, against the float32
reference (``reference/xsimgcl.py``) on the same order, negatives and
noise, once the window has closed: mean loss, Adam's first moment and the
tables' change (``reference/lightgcn.py::compare``). The reference's seconds
are reported on stderr and as ``reference_s`` beside the compared numbers.

The first thing a run does is look for the port's XSimGCL, so a port
without it fails at once with no result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import sys
import time

import torch

from benchmark import dataset
from benchmark.harness import BenchError, Context, Result, check_limits, free_device
from benchmark.reference import lightgcn as ref_lightgcn
from benchmark.reference import xsimgcl as ref
from benchmark.traffic.train_epochs import FullGraph, draw_epochs, forward_pairs, negative_cdf

PORT = "movie_recommender_system_with_gnns_tpu_torch"


def require_port_model() -> None:
    try:
        importlib.import_module(f"{PORT}.models.xsimgcl")
    except ImportError as e:
        raise BenchError(f"the port has no XSimGCL model ({e}); this cell trains it") from None


def port_config(config: dict):
    from movie_recommender_system_with_gnns_tpu_torch.config import (Config, DataConfig,
                                                                     ModelConfig, TrainConfig)

    m, t = config["model"], config["train"]
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return Config(
        data=DataConfig(split_level=config["split"]),
        model=ModelConfig(model=m["model"], num_layers=m["layers"], dim=m["dim"],
                          init_std=m["init_std"], cl_layer=m["cl_layer"], cl_eps=m["cl_eps"]),
        train=TrainConfig(**{k: v for k, v in t.items() if k in fields}))


def reference_dicts(config: dict):
    m, t = config["model"], config["train"]
    return (dict(layers=m["layers"], cl_layer=m["cl_layer"], cl_eps=m["cl_eps"]), t)


class FullGraphCL(FullGraph):
    """``FullGraph`` whose epochs take each step's hop noise too."""

    def __init__(self, ctx: Context, cfg, data: dict):
        super().__init__(ctx, cfg, data)
        self.layers, self.dim = cfg.model.num_layers, cfg.model.dim
        self.n = data["num_users"] + data["num_items"]

    def draws(self, gen, cdf, k: int, epochs: int):
        """[(order, negatives, noise (steps, L, n, d) float32)] per epoch."""
        out = []
        for perm, neg in draw_epochs(gen, self.e_real, (self.steps, self.batch, k), cdf, epochs):
            noise = torch.rand((self.steps, self.layers, self.n, self.dim), generator=gen,
                               device=gen.device)
            out.append((perm, neg, noise))
        return out

    def epoch(self, state, draw):
        return self.epoch_fn(state, self.fg, None, perm=draw[0], neg=draw[1], noise=draw[2])

    def cl_rows(self, draw):
        """[(distinct users, distinct positive items)] of each step."""
        users, items = (torch.from_numpy(x).to(draw[0].device)
                        for x in forward_pairs(self.data["train"], self.data["num_users"]))
        out = []
        for s in range(self.steps):
            sl = draw[0][s * self.batch:(s + 1) * self.batch]
            out.append((int(torch.unique(users[sl]).numel()),
                        int(torch.unique(items[sl]).numel())))
        return out

    def reference_steps(self, draw):
        d, b = self.data, self.batch
        adj = ref.build_adjacency(d["train"], self.n, self.dev)
        users, items = (torch.from_numpy(x).to(self.dev)
                        for x in forward_pairs(d["train"], d["num_users"]))
        out = []
        for s in range(self.steps):
            sl = draw[0][s * b:(s + 1) * b]     # the last step's padding is masked
            out.append(ref.Step(adj, users[sl], items[sl], draw[1][s][:sl.shape[0]],
                                float(sl.shape[0]), draw[2][s]))
        return out


def run(ctx: Context) -> Result:
    require_port_model()
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (TrainState,
                                                                             make_optimizer)

    p, cm, ct = ctx.params, ctx.config["model"], ctx.config["train"]
    if ct.get("trainer") != "fullgraph" or cm.get("model") != "xsimgcl":
        raise BenchError("train_epochs_cl drives XSimGCL on the full-graph trainer")
    data = dataset.load(ctx)
    num_users, num_items = data["num_users"], data["num_items"]
    cfg = port_config(ctx.config)
    dev = ctx.device
    sut = FullGraphCL(ctx, cfg, data)
    k = ct["num_negatives"]

    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    tab = torch.randn((num_users + num_items, cm["dim"]), generator=gen, device=dev)
    tab *= cm["init_std"]
    user0, item0 = tab[:num_users].clone(), tab[num_users:].clone()
    del tab
    cdf = negative_cdf(ct, data["train"], num_users, num_items, dev)
    draws = sut.draws(gen, cdf, k, p["draw_epochs"])
    cl_rows = [sut.cl_rows(dr) for dr in draws]
    flat = [r for rows in cl_rows for r in rows]
    print(f"train_epochs_cl: distinct users a step {min(u for u, _ in flat)}-"
          f"{max(u for u, _ in flat)}, items {min(i for _, i in flat)}-"
          f"{max(i for _, i in flat)}, over {len(flat)} drawn steps", file=sys.stderr)

    info = {"epochs": 0, "steps": 0, "dim": cm["dim"], "layers": cm["layers"],
            "negatives": k, "users": num_users, "items": num_items, "e_real": sut.e_real,
            "cl_rows": cl_rows, **sut.info(k, cm["layers"])}
    model, train = reference_dicts(ctx.config)
    e2e, memory_peak, prof, window_s, failed = {}, 0, None, 0.0, 0
    if ctx.mode == "control":
        low = ref.train_steps(user0, item0, sut.reference_steps(draws[0]), model, train,
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
        ran = []
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        gc.disable()
        t_start = time.perf_counter()
        while True:
            which = (epochs + 1) % len(draws)
            with ctx.spans("epoch"):
                state, mean = sut.epoch(state, draws[which])
            failed += 0 if math.isfinite(mean) else sut.steps
            ran.append(which)
            epochs += 1
            window_s = time.perf_counter() - t_start
            if window_s >= ctx.seconds or (cap is not None and epochs >= cap):
                break
        gc.enable()
        torch.set_num_threads(threads)
        if prof is not None:
            prof.__exit__(None, None, None)
        memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        info.update(epochs=epochs, steps=epochs * sut.steps,
                    window_cl_rows=[r for w in ran for r in cl_rows[w]])
        e2e = {"setup_s": (setup_s, "s"),
               "train_pairs_per_s": (sut.e_real * epochs / window_s, "pairs/s")}
        del state, opt, params
    info["setup_port_s"] = ctx.spans.total("setup.port")
    checked = sut.reference_steps(draws[0])
    sut.free()
    del draws
    free_device()

    t_ref = time.perf_counter()
    steps_ref = ref.train_steps(user0, item0, checked, model, train)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reference_s = time.perf_counter() - t_ref
    print(f"train_epochs_cl: the reference's epoch took {reference_s:.2f} s", file=sys.stderr)
    numbers = ref_lightgcn.compare(loss, mu, change, steps_ref)
    info["numbers"] = {**numbers, "reference_s": reference_s}
    checks, ok = check_limits(numbers, ctx.workload["limits"])
    return Result(end_to_end=e2e, attempted=info["steps"], failed=failed, checks=checks,
                  correct=ok and failed == 0, memory_peak_bytes=memory_peak, info=info,
                  trace=prof.trace if prof is not None else None,
                  window_s=window_s if prof is not None else 0.0)
