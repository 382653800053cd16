"""Bridge recipe: fast compact-cluster epochs + periodic full-graph refresh
(the PyTorch port's counterpart of ``examples/train_bridge.py``).

The compact trainer is fast but plateaus: the Cluster-GCN partition drops
about 60 % of the edge mass, so inter-cluster signal never produces a
gradient (reference data/dataset_handler.py:256-288 has the same
compromise). The full-graph trainer keeps every edge but costs more per
epoch. This driver interleaves them: mostly compact epochs, with one
full-graph epoch every ``--refresh-every`` epochs injecting the dropped
inter-cluster gradients. One Adam state is shared by both epoch fns, so the
moments carry across the switch.

Usage:
  python examples/torch_train_bridge.py --epochs 60 --refresh-every 5 \\
      --dim 128 --split interaction --loss standard --out runs/bridge [--device cpu]
"""

import argparse
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from movie_recommender_system_with_gnns_tpu_torch.config import (  # noqa: E402
    Config, DataConfig, ModelConfig, TrainConfig)
from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (  # noqa: E402
    ML25M_SYNTHETIC)
from movie_recommender_system_with_gnns_tpu_torch.training import compact  # noqa: E402
from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import (  # noqa: E402
    load_params, save_params)
from movie_recommender_system_with_gnns_tpu_torch.training.evaluate import (  # noqa: E402
    evaluate_full_ranking)
from movie_recommender_system_with_gnns_tpu_torch.training.fullgraph import (  # noqa: E402
    build_fullgraph_data, make_fullgraph_epoch_fn)
from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (  # noqa: E402
    prepare_training_data)
from movie_recommender_system_with_gnns_tpu_torch.training.train import (  # noqa: E402
    TrainState, create_train_state, epoch_generator)
from movie_recommender_system_with_gnns_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)
from movie_recommender_system_with_gnns_tpu_torch.utils.observability import (  # noqa: E402
    MetricsLogger)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--refresh-every", type=int, default=5,
                    help="every Nth epoch is a full-graph epoch (0 = never)")
    ap.add_argument("--out", default="runs/bridge")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--num-negatives", type=int, default=8)
    ap.add_argument("--loss", default="standard", choices=["reference", "standard"])
    ap.add_argument("--split", default="interaction", choices=["edge", "interaction"])
    ap.add_argument("--negatives", default="uniform",
                    choices=["uniform", "feasible", "popularity"])
    ap.add_argument("--fullgraph-steps", type=int, default=16)
    ap.add_argument("--compact-lr-scale", type=float, default=1.0,
                    help="lr multiplier for compact epochs only: cluster "
                    "gradients are biased (every inter-cluster message and "
                    "negative dropped), so shrinking only the biased steps "
                    "bounds their drift between refreshes")
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="cosine decays over the WHOLE recipe (compact and "
                    "full-graph steps share one Adam state and schedule)")
    ap.add_argument("--lr-warmup-epochs", type=float, default=0.0)
    ap.add_argument("--correction", default="boundary",
                    choices=["none", "boundary"],
                    help="'boundary' rebuilds the frozen inter-cluster "
                    "correction (training/compact.py::"
                    "build_boundary_correction) at every full-graph refresh, "
                    "so compact gradients are evaluated at the true forward "
                    "point; 'none' keeps raw Cluster-GCN semantics")
    ap.add_argument("--compact-optimizer", default="adam",
                    choices=["adam", "hybrid_adam", "lazy_item_adam"],
                    help="optimizer for the COMPACT epochs. hybrid_adam / "
                    "lazy_item_adam are the fast paths (training/compact.py); "
                    "the shared Adam moments convert losslessly at each "
                    "trainer switch (lazy_state_from_optax / _to_optax), so "
                    "the recipe still advances one schedule")
    ap.add_argument("--eval-propagated", type=int, default=1,
                    help="1 = rank with K-layer propagated tables (the "
                    "LightGCN-paper serving protocol, which loss='standard' "
                    "optimizes); 0 = raw layer-0 tables (the reference's "
                    "serving contract)")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--eval-users", type=int, default=5000)
    ap.add_argument("--final-eval-users", type=int, default=0,
                    help="user count for the final test eval (0 = ALL users)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--users", type=int, default=ML25M_SYNTHETIC["users"])
    ap.add_argument("--items", type=int, default=ML25M_SYNTHETIC["items"])
    ap.add_argument("--interactions", type=int, default=ML25M_SYNTHETIC["interactions"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernel versions)")
    return ap.parse_args(argv)


def is_refresh(args, epoch: int) -> bool:
    """Whether ``epoch`` is a full-graph epoch: every ``refresh_every``-th."""
    return args.refresh_every > 0 and (epoch + 1) % args.refresh_every == 0


def configs(args):
    """``(cfg_c, cfg_f)``: the compact epochs' config and the refreshes'."""
    base_train = dict(
        num_clusters=100, loss=args.loss,
        num_negatives=args.num_negatives, negatives=args.negatives,
        fullgraph_steps=args.fullgraph_steps, seed=args.seed,
        partition_balance_tol=1.1, fused_bpr=(args.loss == "reference"),
    )
    cfg_c = Config(
        data=DataConfig(dataset="synthetic",
                        synthetic_users=args.users, synthetic_items=args.items,
                        synthetic_interactions=args.interactions,
                        synthetic_communities=ML25M_SYNTHETIC["communities"],
                        synthetic_power=ML25M_SYNTHETIC["power"],
                        split_level=args.split,
                        indexes_dir=os.path.join(args.out, "indexes")),
        model=ModelConfig(num_layers=args.layers, dim=args.dim),
        train=TrainConfig(trainer="compact", epochs=args.epochs,
                          lr=args.lr * args.compact_lr_scale,
                          optimizer=args.compact_optimizer, **base_train),
    )
    cfg_f = cfg_c.replace(train=TrainConfig(trainer="fullgraph",
                                            epochs=args.epochs, lr=args.lr,
                                            **base_train))
    return cfg_c, cfg_f


def main(argv=None):
    """Run the recipe; returns ``{"state": the final TrainState, "kinds":
    ["comp" | "FULL" per epoch], "losses": each epoch's train loss, "test":
    (recall, ndcg)}``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    print("argv:", " ".join(sys.argv[1:] if argv is None else argv))
    cfg_c, cfg_f = configs(args)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    t0 = time.time()
    bundle = prepare_training_data(cfg_c, device=dev)
    data, cc, val, test = bundle
    train_e, val_e, test_e = bundle.splits
    print(f"data ready in {time.time()-t0:.0f}s: {data.num_users} users, "
          f"{data.edge_index.shape[1]} edges (train {train_e.shape[1]})")

    t0 = time.time()
    fg = build_fullgraph_data(cfg_f, train_e, data.num_users,
                              data.num_users + data.num_items, device=dev)
    print(f"fullgraph data built in {time.time()-t0:.0f}s "
          f"({fg.num_steps} steps x {fg.batch})")

    if args.lr_schedule == "cosine":
        nf = sum(1 for e in range(args.epochs) if is_refresh(args, e))
        nc = args.epochs - nf
        total_steps = nc * cfg_c.train.num_clusters + nf * fg.num_steps
        warm = int(args.lr_warmup_epochs * cfg_c.train.num_clusters)
        # ONE decay horizon across both trainers: the shared Adam state's
        # step count advances by 100 per compact epoch and fg.num_steps per
        # refresh, so each epoch fn reads the same schedule position
        cos = dict(lr_schedule="cosine", lr_total_steps=total_steps,
                   lr_warmup_steps=warm)
        cfg_c = cfg_c.replace(train=replace(cfg_c.train, **cos))
        cfg_f = cfg_f.replace(train=replace(cfg_f.train, **cos))
        print(f"cosine lr: {total_steps} total steps ({nc} compact + {nf} "
              f"fullgraph epochs), {warm} warmup")

    compact_epoch = compact.make_compact_epoch_fn(cfg_c)
    fullgraph_epoch = make_fullgraph_epoch_fn(cfg_f, fg)

    state = create_train_state(cfg_c, data.num_users, data.num_items, device=dev)
    # the compact fast paths keep the moments as a LazyAdamState; the
    # full-graph refresh runs Adam's state: the two relabel each other
    # losslessly at each switch (same update law, same schedule position)
    lazy = args.compact_optimizer != "adam"
    if lazy:
        state = TrainState(state.params, compact.init_lazy_adam(state.params), state.step)

    def refresh_corr(cc_, params):
        t = time.time()
        corr, neg_rest = compact.build_boundary_correction(
            params, fg.hybrid, cc_, cfg_c, data.num_users)
        if corr.is_cuda:
            torch.cuda.synchronize(corr.device)
        return cc_.with_correction(corr, neg_rest), time.time() - t

    if args.correction == "boundary":
        cc, dt_corr = refresh_corr(cc, state.params)
        print(f"boundary correction built in {dt_corr:.2f}s "
              f"(corr {tuple(cc.corr.shape)}, neg_rest {tuple(cc.neg_rest.shape)})")
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    eval_normalize = args.loss != "standard"
    best = {"r": -1.0, "epoch": -1}
    best_path = os.path.join(args.out, "best_fullrank.npz")
    full_eval = dict(train_edges=train_e, num_users=data.num_users, k=10,
                     use_propagated=bool(args.eval_propagated), normalize=eval_normalize,
                     cfg=cfg_c)

    t_compact, t_full, kinds, losses = [], [], [], []
    for epoch in range(args.epochs):
        gen = epoch_generator(cfg_c, epoch, dev)
        refresh = is_refresh(args, epoch)
        t0 = time.time()
        if refresh:
            if lazy:
                fst = TrainState(state.params, compact.lazy_state_to_optax(state.opt_state),
                                 state.step)
                fst, loss = fullgraph_epoch(fst, fg, gen)
                state = TrainState(fst.params, compact.lazy_state_from_optax(fst.opt_state),
                                   fst.step)
            else:
                state, loss = fullgraph_epoch(state, fg, gen)
            if args.correction == "boundary":
                # correction staleness resets here: rebuild from the freshly
                # refreshed tables (its cost counted inside the refresh epoch)
                cc, dt_corr = refresh_corr(cc, state.params)
                print(f"boundary correction rebuilt in {dt_corr:.2f}s")
        else:
            state, loss = compact_epoch(state, cc, gen)
        dt = time.time() - t0
        (t_full if refresh else t_compact).append(dt)
        kind = "FULL" if refresh else "comp"
        kinds.append(kind)
        losses.append(loss)
        print(f"Epoch {epoch:03d} [{kind}] loss {loss:.4f} ({dt:.2f}s)")
        logger.log(epoch, train_loss=loss, epoch_time_s=dt, kind=1.0 if refresh else 0.0)
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            # in-run evals rank bf16 scores; the final test eval keeps f32
            r, n = evaluate_full_ranking(state.params, eval_edges=val_e,
                                         max_users=args.eval_users,
                                         score_dtype="bfloat16", **full_eval)
            et = evaluate_full_ranking.last_timings
            print(f"  full-ranking val Recall@10 {r:.4f} NDCG@10 {n:.4f} "
                  f"(eval {et['total_s']:.2f}s, mask {et['mask_build_s']:.2f}s"
                  f"{', cached' if et.get('groupby_cached') else ''})")
            logger.log(epoch, val_full_recall10=r, val_full_ndcg10=n,
                       eval_total_s=et["total_s"], eval_mask_build_s=et["mask_build_s"])
            if r > best["r"]:
                best.update(r=r, epoch=epoch)
                save_params(best_path, state.params,
                            meta={"val_full_recall10": r, "epoch": epoch})

    # amortized epoch cost of the recipe; each kind's first epoch (the
    # kernels' first launches) left out of its steady-state mean
    n_c, n_f = len(t_compact), len(t_full)
    sc = float(np.mean(t_compact[1:])) if n_c > 1 else float(np.mean(t_compact or [0]))
    sf = float(np.mean(t_full[1:])) if n_f > 1 else float(np.mean(t_full or [0]))
    amort = (sc * n_c + sf * n_f) / max(n_c + n_f, 1)
    print(f"steady-state: compact {sc:.2f}s x{n_c}, fullgraph {sf:.2f}s x{n_f} "
          f"-> amortized {amort:.2f}s/epoch")

    # test metric at the best-val checkpoint, at the full user count by default
    bp, _ = load_params(best_path, device=dev)
    rt, nt = evaluate_full_ranking(bp, eval_edges=test_e,
                                   max_users=args.final_eval_users or None, **full_eval)
    timings = evaluate_full_ranking.last_timings
    print(f"TEST at best-val (epoch {best['epoch']}): Recall@10 {rt:.4f} "
          f"NDCG@10 {nt:.4f}; amortized epoch {amort:.2f}s; "
          f"eval timings {timings}")
    logger.log(args.epochs, test_full_recall10=rt, test_full_ndcg10=nt,
               amortized_epoch_s=amort, **{f"eval_{k_}": v for k_, v in
                                           timings.items() if k_ != "sharded"})
    return {"state": state, "kinds": kinds, "losses": losses, "test": (rt, nt)}


if __name__ == "__main__":
    main()
