"""Trace and attribute one ML-25M training epoch on the GPU, against its
row-op floor (the PyTorch port's counterpart of ``examples/profile_epoch.py``).

Builds ``bench.py``'s problem at ``--scale`` (the ML-25M-statistics synthetic
graph and its 100 greedy clusters at ``full``), runs the compact epoch with
``--optimizer`` (or, with ``--trainer sharded``, the one-rank fused sharded
hybrid epoch) once to warm up, times ``--epochs`` epochs, then runs as many
under ``torch.profiler`` and prints the top ops by self device time, the
device's idle share, and the epoch's floor and ``rowop_util`` from the port's
``utils/roofline.py``, its rates measured on the same device at the epoch's
shapes.

Usage:  python examples/torch_profile_epoch.py [--scale full]
        [--optimizer hybrid_adam] [--trainer sharded] [--device cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from movie_recommender_system_with_gnns_tpu_torch.config import (  # noqa: E402
    Config, ModelConfig, TrainConfig)
from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (  # noqa: E402
    ML25M_SYNTHETIC)
from movie_recommender_system_with_gnns_tpu_torch.utils import roofline  # noqa: E402
from movie_recommender_system_with_gnns_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)

#: bench.py SCALES: users, items, interactions, clusters, layers, dim; full:
#: ML-25M statistics with 200 planted taste communities
SCALES = {
    "full": dict(ML25M_SYNTHETIC, clusters=100, layers=3, dim=64,
                 sharded_parts=64, sharded_ghost_cap=4608,
                 sharded_balance_tol=0.0, sharded_refine_rounds=8),
    "small": dict(users=16_254, items=5_905, interactions=1_800_000,
                  clusters=10, layers=3, dim=64, communities=40, power=0.9),
    "tiny": dict(users=943, items=1_682, interactions=100_000,
                 clusters=4, layers=3, dim=64, communities=8, power=0.9),
}


def build_problem(scale: dict, seed: int = 0):
    """``bench.py``'s problem: the synthetic graph and its greedy clusters,
    each cluster's kept edges capped at 1.1× the mean."""
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens)
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
        partition_bipartite_greedy)

    t0 = time.time()
    data = make_synthetic_movielens(scale["users"], scale["items"], scale["interactions"],
                                    seed=seed, num_communities=scale.get("communities", 0),
                                    power=scale.get("power", 1.1))
    parts = partition_bipartite_greedy(data.edge_index, data.num_users,
                                       data.num_users + data.num_items, scale["clusters"],
                                       seed=seed, balance_tol=1.1)
    parts = [p for p in parts if p.shape[1] > 0]
    kept = sum(p.shape[1] for p in parts)
    print(f"built {data.num_users}x{data.num_items} graph, {data.edge_index.shape[1]} "
          f"edges, {len(parts)} clusters (retention {kept / data.edge_index.shape[1]:.2%}) "
          f"in {time.time() - t0:.1f}s")
    return data, parts


def compact_epoch(data, parts, scale, optimizer, dev):
    """``(run, floor)``: ``run()`` trains one compact epoch; ``floor(rates,
    flops, hbm)`` its floor; and the triplet width the rates are measured at."""
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import init_params
    from movie_recommender_system_with_gnns_tpu_torch.training import compact
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
        densify_if_fits)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        create_train_state)

    cfg = Config(model=ModelConfig(num_layers=scale["layers"], dim=scale["dim"]),
                 train=TrainConfig(fused_bpr=True, optimizer=optimizer))
    cc = densify_if_fits(compact.build_compact_clusters(parts, data.num_users, device=dev),
                         cfg.train)
    b_pad = cc.user_local.shape[1]
    print(f"compact clusters: u_pad={cc.u_pad} i_pad={cc.i_pad} triplets={b_pad} "
          f"dense_adj={cc.adj is not None} optimizer={optimizer}")
    if optimizer in compact.LAZY_OPTIMIZERS:
        params = init_params(data.num_users, data.num_items, scale["dim"],
                             generator=torch.Generator().manual_seed(0), device=dev)
        state = [compact.create_lazy_train_state(cfg, params)]
    else:
        state = [create_train_state(cfg, data.num_users, data.num_items, device=dev)]
    epoch_fn = compact.make_compact_epoch_fn(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run():
        state[0], loss = epoch_fn(state[0], cc, gen)
        return loss

    def floor(rates, flops, hbm):
        f = roofline.compact_epoch_floor(
            num_users=data.num_users, num_items=data.num_items, d=scale["dim"],
            num_layers=scale["layers"], num_clusters=cc.num_clusters, u_pad=cc.u_pad,
            i_pad=cc.i_pad, b_pad=b_pad, rates=rates, peak_flops=flops,
            peak_hbm_bps=hbm, optimizer=optimizer)
        return f["floor_s"], f

    return run, floor, b_pad


def sharded_epoch(data, scale, dev):
    """The one-rank fused sharded hybrid epoch, as ``bench.py`` builds it:
    ``sharded_parts`` native parts (doubled while a block does not fit),
    ghost columns, the symmetric VJP, Adam at a constant rate."""
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import forward_half
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import init_params
    from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as pmesh
    from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as sh
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        TrainState, make_adam)

    nu, ni = data.num_users, data.num_items
    cfg = Config(model=ModelConfig(num_layers=scale["layers"], dim=scale["dim"]),
                 train=TrainConfig(symmetric_vjp=True))
    mesh = pmesh.make_mesh(1, 1, device=dev)
    plan = sh.ShardPlan.create(nu, ni, 1)
    t0 = time.time()
    uv = forward_half(data.edge_index, nu)
    g, _, num_parts, _, _ = sh.build_sharded_hybrid(
        data.edge_index, plan, scale.get("sharded_parts", scale["clusters"]),
        ghost_cap=scale.get("sharded_ghost_cap", 0),
        balance_tol=scale.get("sharded_balance_tol", 1.1),
        refine_rounds=scale.get("sharded_refine_rounds"))
    shard = sh.shard_hybrid(g, plan, 0, dev)
    print(f"sharded hybrid graph: {num_parts} parts, block width {g.blk_ids.shape[-1]}, "
          f"built in {time.time() - t0:.1f}s")
    params = init_params(nu, ni, scale["dim"], generator=torch.Generator().manual_seed(0),
                         device=dev)
    local = sh.shard_params(sh.pad_params(params, plan), plan, 0)
    adam = make_adam(cfg, lr_of=lambda t: cfg.train.lr)
    state = [TrainState(local, adam.init(local), 0)]
    epoch = sh.make_sharded_epoch_fn(cfg, mesh, plan, adam, hybrid=True,
                                     symmetric=True)(state[0])
    user = torch.from_numpy(uv[0].astype(np.int32)).to(dev)
    pos = torch.from_numpy(uv[1].astype(np.int32)).to(dev)
    sp = sh.sharded_epoch_plan(cfg, int(user.shape[0]), 1)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run():
        state[0], loss, _ = epoch(state[0], shard, user, pos, gen)
        return float(loss)

    def floor(rates, flops, hbm):
        f = roofline.sharded_epoch_floor(
            n_pad=plan.n_pad, d=scale["dim"], num_layers=scale["layers"],
            steps=sp["num_steps"], batch=sp["batch"],
            e_off_directed=int(g.off_counts[0]),
            ell_chunks=roofline.ell_rows_written(shard.off_ell.schedule),
            blk_k=int(np.prod(g.blk_ids.shape[:2])), blk_p=int(g.blk_ids.shape[-1]),
            rates=rates, peak_flops=flops, peak_hbm_gbps=hbm / 1e9)
        return f["sharded_floor_s"], f

    return run, floor, sp["batch"]


def top_ops(prof, dev, epochs: int, top: int):
    """``(rows, busy_s)``: the ``top`` ops by self device time (self CPU time
    on the CPU), per epoch, and the device-busy seconds per epoch (None on
    the CPU, where no device is traced)."""
    from torch.autograd import DeviceType

    kind = DeviceType.CUDA if dev.type == "cuda" else DeviceType.CPU
    events = [e for e in prof.key_averages() if e.device_type == kind]
    self_us = (lambda e: e.self_device_time_total) if dev.type == "cuda" else (
        lambda e: e.self_cpu_time_total)
    events.sort(key=self_us, reverse=True)
    rows = [dict(op=e.key[:90], self_ms=self_us(e) / (1e3 * epochs),
                 calls=e.count / epochs) for e in events[:top]]
    busy = (sum(self_us(e) for e in events) / (1e6 * epochs)
            if dev.type == "cuda" else None)
    return rows, busy


def main(argv=None):
    """Run the driver; returns ``{"epoch_s", "idle_share", "floor_s",
    "rowop_util", "top_ops"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="full")
    ap.add_argument("--optimizer", default="hybrid_adam")
    ap.add_argument("--trainer", default="compact", choices=["compact", "sharded"])
    ap.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(), "mrs_profile"))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    dev = resolve_device(args.device)
    owned = not dist.is_initialized()
    try:
        return profile_epoch(args, dev)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def profile_epoch(args, dev: torch.device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    scale = SCALES[args.scale]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    data, parts = build_problem(scale)
    if args.trainer == "sharded":
        run, floor, batch = sharded_epoch(data, scale, dev)
    else:
        run, floor, batch = compact_epoch(data, parts, scale, args.optimizer, dev)

    t0 = time.time()
    run()
    sync()
    print(f"warm-up epoch: {time.time() - t0:.2f}s")
    times = []
    for _ in range(args.epochs):
        t0 = time.perf_counter()
        loss = run()
        sync()
        times.append(time.perf_counter() - t0)
    epoch_s = min(times)
    print(f"epoch times: {[round(t, 4) for t in times]} s, final loss {loss:.4f}")

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            run()
        sync()
        wall = (time.perf_counter() - t0) / args.epochs
    os.makedirs(args.logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.logdir, "epoch_trace.json"))
    rows, busy = top_ops(prof, dev, args.epochs, 30)
    idle = None if busy is None else 1.0 - busy / wall
    print(f"top ops by self {'device' if dev.type == 'cuda' else 'CPU'} time, per epoch "
          f"(profiled wall {wall:.4f} s; device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} s'}; idle share "
          f"{'not measured' if idle is None else f'{idle:.4f}'}):")
    for r in rows:
        print(f"  {r['self_ms']:10.4f} ms  x{r['calls']:<8g} {r['op']}")

    t0 = time.time()
    rates = roofline.measure_rowop_rates(num_rows=data.num_items, d=scale["dim"],
                                         batch=batch, device=dev)
    # on the CPU the floor prices the CPU's rates at the H100's published peaks
    kind, flops, hbm = roofline.device_peaks(
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    floor_s, parts_s = floor(rates, flops, hbm)
    util = floor_s / epoch_s
    print(f"row-op rates on {kind} ({time.time() - t0:.1f}s): {rates._asdict()}")
    print(f"epoch floor {floor_s:.6f} s: {json.dumps(parts_s)}")
    print(f"rowop_util {util:.4f} (floor {floor_s:.6f} s / epoch {epoch_s:.6f} s)")
    return dict(epoch_s=epoch_s, idle_share=idle, floor_s=floor_s, rowop_util=util,
                top_ops=rows)


if __name__ == "__main__":
    main()
