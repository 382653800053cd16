"""Command-line entry point of the port: ``train``, ``recommend`` (one-shot
or batch) and ``eda``.

    python -m movie_recommender_system_with_gnns_tpu_torch.cli train --fused-bpr
    python -m movie_recommender_system_with_gnns_tpu_torch.cli recommend --user-id N [--plots]
    python -m movie_recommender_system_with_gnns_tpu_torch.cli recommend --movie-id N
    python -m movie_recommender_system_with_gnns_tpu_torch.cli recommend \\
        --users-file users.txt --out recs.csv
    python -m movie_recommender_system_with_gnns_tpu_torch.cli --dataset ml-25m eda

The options are the JAX package's, so one command line, one checkpoint and one
indexes dir serve both. ``--device`` picks the device (default ``cuda``;
without a GPU, pass ``--device cpu``). ``train`` runs the compact cluster
trainer (``--trainer compact``, the default), the full-node one
(``--trainer full``, Adam) or the full-graph one (``--trainer fullgraph``,
Adam, ``--fullgraph-steps`` steps an epoch over every train edge);
``--optimizer`` picks the compact trainer's Adam variant (``adam``,
``lazy_adam``, ``hybrid_adam``, ``lazy_item_adam``); ``--negatives
popularity`` draws the full-graph trainer's negatives by count^0.75 and
``--negatives feasible`` the full-graph and compact trainers' negatives
among the items a user has no train pair with; ``--max-retries N`` runs the
elastic driver (``training/recovery.py``: a transient failure resumes from
the last full-state checkpoint, bit-equal to an uninterrupted run);
``--full-eval`` adds the full-ranking Recall@k / NDCG@k on the test split
after training. ``--model xsimgcl`` (with ``train --trainer fullgraph``)
trains XSimGCL at its published constants (``ModelConfig`` /
``TrainConfig``'s defaults), whose ``recommend --propagated`` serves its
unperturbed readout; the other trainers refuse it. Every ``train`` appends one row per epoch to
``<histories-dir>/metrics.jsonl`` and ends with the history plot
(``<histories-dir>/histories_training.png``). ``recommend --propagated``
scores with the K-layer propagated tables; ``recommend --plots`` also writes
the bar chart (``recommendations.png``) and the user's embedding-space
analysis (``user_analysis.png``) in the working directory. ``eda`` prints
the dataset statistics of ``<data-dir>/ratings.csv`` (the synthetic graph's
when it is absent). The plots need matplotlib; without it they print a
"skipped" line and the command goes on.

``train --mesh DPxMP`` trains the row-sharded full-graph trainer
(``training/distributed.py``) over DP·MP ranks, one card each, and
``--full-eval`` then evaluates with the catalog sharded over them:

    torchrun --nproc-per-node=4 -m movie_recommender_system_with_gnns_tpu_torch.cli \\
        train --mesh 2x2 --full-eval

``--mesh 1x1`` runs in one process without a launcher; any other mesh
without one raises. Only rank 0 prints and writes files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from .config import MODELS, Config, DataConfig, ModelConfig, TrainConfig, check_model


def _build_cfg(args) -> Config:
    data = DataConfig(
        dataset=args.dataset,
        data_dir=args.data_dir or f"data/movielens-{args.dataset.replace('ml-', '')}",
        indexes_dir=args.indexes_dir,
        synthetic_users=args.synthetic_users,
        synthetic_items=args.synthetic_items,
        synthetic_interactions=args.synthetic_interactions,
        synthetic_communities=args.synthetic_communities,
        synthetic_power=args.synthetic_power,
        split_level=getattr(args, "split_level", "edge"),
    )
    model = ModelConfig(num_layers=args.layers, dim=args.dim, readout=args.readout,
                        model=args.model)
    train = TrainConfig(epochs=args.epochs, lr=args.lr, num_clusters=args.clusters,
                        checkpoint_path=args.checkpoint,
                        histories_dir=args.histories_dir,
                        loss=getattr(args, "loss", "reference"),
                        optimizer=getattr(args, "optimizer", "adam"),
                        partitioner=getattr(args, "partitioner", "greedy"),
                        trainer=getattr(args, "trainer", "compact"),
                        fullgraph_steps=getattr(args, "fullgraph_steps", 16),
                        num_negatives=getattr(args, "num_negatives", 1),
                        negatives=getattr(args, "negatives", "uniform"),
                        fused_bpr=getattr(args, "fused_bpr", False),
                        lr_schedule=getattr(args, "lr_schedule", "constant"),
                        lr_warmup_steps=getattr(args, "lr_warmup_steps", 0))
    return Config(data=data, model=model, train=train)


def metrics_path(cfg: Config) -> str:
    return os.path.join(cfg.train.histories_dir, "metrics.jsonl")


def mesh_from_args(args):
    """The mesh of ``train --mesh DPxMP`` (None without the option): the
    launcher's ranks (``torchrun`` sets ``RANK`` and ``WORLD_SIZE``), or one
    rank in this process for ``1x1``. A mesh of more ranks without a
    launcher raises with the command line that runs it; one that does not
    fit the launcher's world size raises in ``make_mesh``."""
    if not getattr(args, "mesh", None):
        return None
    import torch.distributed as dist

    from .parallel.mesh import make_mesh

    dp, mp = (int(x) for x in args.mesh.lower().split("x"))
    launched = dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)
    if dp * mp > 1 and not launched:
        raise ValueError(
            f"--mesh {args.mesh} needs {dp * mp} ranks, one card each; start them with "
            f"torchrun --nproc-per-node={dp * mp} -m "
            f"movie_recommender_system_with_gnns_tpu_torch.cli train --mesh {args.mesh} "
            "[options]")
    return make_mesh(dp, mp, device=args.device)


def train_from_args(args, mesh=None):
    """Reference train_test.py __main__ (:259-293): build data, resume if a
    checkpoint exists, train (through the elastic driver with
    ``--max-retries``; the sharded trainer on ``mesh``), log each epoch to
    :func:`metrics_path`, persist histories. Returns ``(cfg, bundle,
    state)``: the config with its cosine horizon, the pipeline's bundle (no
    clusters on a mesh) and the trained state."""
    from .training.checkpoint import load_params_if_exists, save_params
    from .training.pipeline import TrainingBundle, load_and_split, prepare_training_data
    from .training.recovery import train_with_recovery
    from .training.train import (build_eval_batch, create_train_state, save_histories,
                                 train_model)
    from .utils.device import resolve_device
    from .utils.observability import MetricsLogger

    main = mesh is None or mesh.is_main
    say = print if main else (lambda *a, **k: None)
    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = _build_cfg(args)
    check_model(cfg, "sharded" if mesh is not None else cfg.train.trainer)
    say(f"device: {device}")
    if mesh is None:
        bundle = prepare_training_data(cfg, device=device)
    else:
        import torch.distributed as dist

        from .config import MeshConfig

        cfg = cfg.replace(mesh=MeshConfig(data_parallel=mesh.dp, model_parallel=mesh.mp))
        if not main:       # rank 0 writes the split's index files first
            dist.barrier()
        data, splits = load_and_split(cfg)
        if main:
            dist.barrier()
        n = data.num_users + data.num_items
        bundle = TrainingBundle(
            data, None, build_eval_batch(splits[1], n, data.num_users, device),
            build_eval_batch(splits[2], n, data.num_users, device), splits)
    data, clusters, val, test = bundle
    say(f"Number of users: {data.num_users}")
    say(f"Number of items: {data.num_items}")
    say(f"Number of relevant interactions: {data.edge_index.shape[1]}")

    if cfg.train.lr_schedule == "cosine" and cfg.train.lr_total_steps <= 0:
        from .training.fullgraph import FullGraphTrainData

        steps_per_epoch = (clusters.num_steps if isinstance(clusters, FullGraphTrainData)
                           else cfg.train.num_clusters)
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, lr_total_steps=steps_per_epoch * cfg.train.epochs))

    state = create_train_state(cfg, data.num_users, data.num_items, device=device)
    if cfg.train.resume:
        state = state._replace(
            params=load_params_if_exists(cfg.train.checkpoint_path, state.params))

    def save_cb(st, recall):
        save_params(cfg.train.checkpoint_path, st.params,
                    meta={"val_recall": recall, "config": cfg.to_json()})

    logger = MetricsLogger(metrics_path(cfg))
    if mesh is not None:
        from .training.distributed import train_model_sharded

        params, hist = train_model_sharded(
            cfg, data.num_users, data.num_items, bundle.splits[0], val, test, mesh=mesh,
            save_checkpoint=lambda p, r: save_cb(state._replace(params=p), r),
            metrics_logger=logger, params=state.params)
        state = state._replace(params=params)
    elif args.max_retries > 0:
        state, hist = train_with_recovery(
            cfg, state, clusters, val, test, max_retries=args.max_retries,
            save_checkpoint=save_cb, metrics_logger=logger)
    else:
        state, hist = train_model(cfg, state, clusters, val, test,
                                  save_checkpoint=save_cb, metrics_logger=logger)
    if main:
        save_histories(hist, cfg.train.histories_dir)
    return cfg, bundle, state


def cmd_train(args) -> int:
    """Train (:func:`train_from_args`), then the optional full-ranking eval
    of the layer-0 tables on the test split (catalog sharded over the mesh
    with ``--mesh``), then the history plot. A process group this command
    starts, it ends."""
    import torch.distributed as dist

    owned = not dist.is_initialized()
    mesh = mesh_from_args(args)
    try:
        cfg, bundle, state = train_from_args(args, mesh)
        if args.full_eval:
            from .training.evaluate import evaluate_full_ranking
            from .utils.observability import MetricsLogger

            train_e, _, test_e = bundle.splits
            recall, ndcg = evaluate_full_ranking(
                state.params, train_e, test_e, bundle.data.num_users, k=args.full_eval_k,
                max_users=args.full_eval_users, mesh=mesh)
            if mesh is None or mesh.is_main:
                print(f"Full-ranking test Recall@{args.full_eval_k}: {recall:.4f}, "
                      f"NDCG@{args.full_eval_k}: {ndcg:.4f}")
                print(f"full-ranking eval timings: {evaluate_full_ranking.last_timings}")
                MetricsLogger(metrics_path(cfg)).log(
                    cfg.train.epochs, test_full_recall=recall, test_full_ndcg=ndcg,
                    **evaluate_full_ranking.last_timings)
        if mesh is None or mesh.is_main:
            from .utils.visualizations import plot_histories

            try:
                print(f"history plot: {plot_histories(cfg.train.histories_dir)}")
            except Exception as e:  # a plot must never fail training
                print(f"history plot skipped: {e}")
    finally:
        if owned and mesh is not None and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _write_batch(path, raw_ids, valid, scores, items, data, top_k) -> None:
    with open(path, "w") as f:
        f.write("userId,rank,movieId,title,score\n")
        for r, uid in enumerate(raw_ids[valid]):
            for rank in range(top_k):
                raw_m = int(data.raw_movie_id(int(items[r][rank])))
                title = str(data.title_of(raw_m)).replace(",", ";")
                f.write(f"{uid},{rank + 1},{raw_m},{title},{scores[r][rank]:.4f}\n")


def cmd_recommend(args) -> int:
    """Load the data and split, load the checkpoint's layer-0 tables (or
    propagate them over the train graph with ``--propagated``), print top-k
    with train-seen items excluded (reference recommend.py:115-156)."""
    import numpy as np

    from .serving.recommend import (batch_recommend_users,
                                    compute_serving_tables, recommend_from_movie,
                                    recommend_from_user, train_seen_items)
    from .training.checkpoint import load_params
    from .training.pipeline import load_and_split
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _build_cfg(args)
    data, splits = load_and_split(cfg)
    if not os.path.exists(cfg.train.checkpoint_path):
        print(f"checkpoint {cfg.train.checkpoint_path} not found — train first")
        return 1
    params, _ = load_params(cfg.train.checkpoint_path, device)
    if args.propagated:
        params = compute_serving_tables(params, splits[0], cfg, mode="propagated")

    if args.users_file is not None:
        with open(args.users_file) as f:
            raw_ids = np.asarray([int(x) for x in f.read().split()], dtype=np.int64)
        idx = data.user_index(raw_ids)
        valid = idx >= 0
        scores, items = batch_recommend_users(params, idx[valid], top_k=args.top_k)
        out_path = args.out or "recommendations.csv"
        _write_batch(out_path, raw_ids, valid, scores.cpu().numpy(),
                     items.cpu().numpy(), data, args.top_k)
        skipped = int((~valid).sum())
        print(f"wrote {out_path}: {int(valid.sum())} users, top-{args.top_k}"
              + (f" ({skipped} unknown ids skipped)" if skipped else ""))
        return 0

    if args.movie_id is not None:
        out = recommend_from_movie(params, args.movie_id, data, top_k=args.top_k)
        if "error" in out:
            print(out["error"])
            return 1
        print(f"Top {args.top_k} users for movie {args.movie_id}:")
        for i, rec in enumerate(out["top_users"], 1):
            print(f"{i}. user {rec['user_id']} (Score: {rec['score']:.4f})")
        return 0

    user_id = args.user_id
    if user_id is None:
        print(f"Please enter a user ID (suggested user: {int(data.user_ids[0])}):")
        user_id = int(input())
    uidx = int(data.user_index(user_id))
    excluded = (train_seen_items(splits[0], data.num_users, uidx)
                if uidx >= 0 else None)
    out = recommend_from_user(params, user_id, data, excluded, top_k=args.top_k)
    if "error" in out:
        print(out["error"])
        return 1
    print(f"Top {args.top_k} Recommendations for user {user_id}:")
    for i, rec in enumerate(out["recommendations"], 1):
        print(f"{i}. {rec['title']} (Score: {rec['score']:.4f})")

    if args.plots:
        from .utils.visualizations import (_render_analysis, plot_recommendations,
                                           user_neighbourhood)

        # the analysis' device work runs outside the guard: a fault on the
        # card fails the command, only the rendering may be skipped
        hood = user_neighbourhood(params, user_id, data)
        try:
            print("bar chart:", plot_recommendations(out["recommendations"], user_id))
            print("analysis:", _render_analysis(hood, user_id))
        except Exception as e:
            print(f"plots skipped: {e}")
    return 0


def cmd_eda(args) -> int:
    """Reference data/eda.py: the dataset statistics report (JAX
    ``cli.py:240-276``). ``ratings.csv`` is read by the native reader, all
    rows, and counted again at ``min_rating``; ``movies.csv`` and
    ``tags.csv`` through pandas where it is installed, else the ``csv``
    module. Without ``ratings.csv``, the synthetic graph JAX's ``eda``
    builds for the same command line is reported."""
    import numpy as np

    from .data import native
    from .data.movielens import make_synthetic_movielens, pandas_or_none
    from .utils.eda import eda_report, read_csv_columns

    cfg = _build_cfg(args)
    ratings_path = os.path.join(cfg.data.data_dir, "ratings.csv")
    movies = tags = num_ge = None
    if os.path.exists(ratings_path):
        users, items = native.load_ratings_csv(ratings_path, -np.inf)
        num_ge = native.load_ratings_csv(ratings_path, cfg.data.min_rating)[0].shape[0]
        ratings = {"userId": users, "movieId": items}
        pd = pandas_or_none()
        read = pd.read_csv if pd is not None else read_csv_columns
        movies_path = os.path.join(cfg.data.data_dir, "movies.csv")
        tags_path = os.path.join(cfg.data.data_dir, "tags.csv")
        if os.path.exists(movies_path):
            movies = read(movies_path)
        if os.path.exists(tags_path):
            tags = read(tags_path)
    else:
        print("(no CSVs found — reporting on the synthetic dataset)")
        d = make_synthetic_movielens(cfg.data.synthetic_users, cfg.data.synthetic_items,
                                     cfg.data.synthetic_interactions)
        e = d.edge_index
        fwd = e[0] < d.num_users
        ratings = {"userId": d.raw_user_id(e[0][fwd]),
                   "movieId": d.raw_movie_id(e[1][fwd] - d.num_users),
                   "rating": np.full(int(fwd.sum()), 4.0)}
    eda_report(ratings, movies=movies, tags=tags, min_rating=cfg.data.min_rating,
               num_ge=num_ge)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the global options and the ``train``, ``recommend``
    and ``eda`` subcommands."""
    ap = argparse.ArgumentParser(prog="movie_recommender_system_with_gnns_tpu_torch")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cuda, cuda:1 or cpu (default: cuda)")
    ap.add_argument("--dataset", default="synthetic",
                    help="ml-25m | ml-1m | ml-100k | synthetic")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--indexes-dir", default="data/indexes")
    ap.add_argument("--checkpoint", default="best_model.npz")
    ap.add_argument("--histories-dir", default="data/histories")
    ap.add_argument("--epochs", type=int, default=3)          # train_test.py:287
    ap.add_argument("--lr", type=float, default=1e-3)         # train_test.py:216
    ap.add_argument("--dim", type=int, default=64)            # train_test.py:274
    ap.add_argument("--layers", type=int, default=3)          # train_test.py:274
    ap.add_argument("--clusters", type=int, default=100)      # dataset_handler.py:256
    ap.add_argument("--readout", default="reference", choices=["reference", "standard"])
    ap.add_argument("--model", default="lightgcn", choices=list(MODELS),
                    help="xsimgcl: noise-perturbed hops and an in-batch InfoNCE at "
                         "the published constants (train --trainer fullgraph only); "
                         "served by its unperturbed readout")
    ap.add_argument("--synthetic-users", type=int, default=943)
    ap.add_argument("--synthetic-items", type=int, default=1682)
    ap.add_argument("--synthetic-interactions", type=int, default=100_000)
    ap.add_argument("--synthetic-communities", type=int, default=0,
                    help="planted taste communities of the synthetic graph")
    ap.add_argument("--synthetic-power", type=float, default=1.1,
                    help="Zipf exponent of the synthetic graph's degrees")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="train the LightGCN model")
    pt.add_argument("--loss", default="reference", choices=["reference", "standard"],
                    help="reference-quirk cosine-softplus BPR vs textbook BPR")
    pt.add_argument("--optimizer", default="adam",
                    choices=["adam", "lazy_adam", "hybrid_adam", "lazy_item_adam"],
                    help="compact trainer: adam, or the lazy-row variants "
                         "(hybrid_adam: dense item Adam, lazy user rows)")
    pt.add_argument("--partitioner", default="greedy",
                    choices=["greedy", "random_edges"])
    pt.add_argument("--trainer", default="compact",
                    choices=["compact", "full", "fullgraph"],
                    help="compact = Cluster-GCN in local node space; full = "
                         "reference full-node-space clusters; fullgraph = "
                         "every step propagates ALL train edges (hybrid "
                         "block-diagonal propagation, 100%% edge retention)")
    pt.add_argument("--fullgraph-steps", type=int, default=16,
                    help="optimizer updates per fullgraph epoch")
    pt.add_argument("--split-level", default="edge",
                    choices=["edge", "interaction"],
                    help="edge = reference-parity split of the doubled edge "
                         "list; interaction = leakage-free unique-pair split")
    pt.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine"],
                    help="cosine adds warmup + decay (total steps auto-set "
                         "to steps_per_epoch x epochs)")
    pt.add_argument("--lr-warmup-steps", type=int, default=0)
    pt.add_argument("--num-negatives", type=int, default=1,
                    help="negatives per positive")
    pt.add_argument("--negatives", default="uniform",
                    choices=["uniform", "feasible", "popularity"],
                    help="uniform = reference law (no collision check); "
                         "feasible = exact rejection-resampled negatives "
                         "(compact and fullgraph trainers); popularity = "
                         "count^0.75 alias-table draws (fullgraph trainer)")
    pt.add_argument("--fused-bpr", action="store_true",
                    help="fused CUDA BPR loss+grad kernel (ops/cuda_bpr.py)")
    pt.add_argument("--mesh", default=None,
                    help="DPxMP: the row-sharded full-graph trainer over DP*MP ranks "
                         "(torchrun; 1x1 runs in this process)")
    pt.add_argument("--max-retries", type=int, default=0,
                    help="elastic training: retry transient failures up to N "
                         "times from the last full-state checkpoint")
    pt.add_argument("--full-eval", action="store_true",
                    help="post-training full-ranking Recall@k/NDCG@k on test")
    pt.add_argument("--full-eval-k", type=int, default=10)
    pt.add_argument("--full-eval-users", type=int, default=10_000,
                    help="cap on evaluated users (a seeded sample)")
    pr = sub.add_parser("recommend", help="top-k retrieval")
    pr.add_argument("--user-id", type=int, default=None)
    pr.add_argument("--movie-id", type=int, default=None)
    pr.add_argument("--top-k", type=int, default=10)
    pr.add_argument("--plots", action="store_true",
                    help="also write recommendations.png and user_analysis.png")
    pr.add_argument("--propagated", action="store_true",
                    help="score with K-layer propagated embeddings instead of "
                         "the reference's layer-0 tables")
    pr.add_argument("--users-file", default=None,
                    help="batch mode: file with one raw userId per line")
    pr.add_argument("--out", default=None, help="batch mode output CSV path")
    sub.add_parser("eda", help="dataset statistics report")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "recommend":
        return cmd_recommend(args)
    return cmd_eda(args)


if __name__ == "__main__":
    sys.exit(main())
