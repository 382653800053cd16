"""Command-line entry point of the port: ``recommend`` (one-shot or batch).

    python -m movie_recommender_system_with_gnns_tpu_torch.cli recommend --user-id N
    python -m movie_recommender_system_with_gnns_tpu_torch.cli recommend --movie-id N
    python -m movie_recommender_system_with_gnns_tpu_torch.cli recommend \\
        --users-file users.txt --out recs.csv

The dataset options are the JAX package's, so one checkpoint and one indexes
dir serve both; the training options wait for the training slice. ``--device`` picks the device (default ``cuda``; without a
GPU, pass ``--device cpu``). ``train`` and ``eda`` are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import Config, DataConfig, TrainConfig


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
    )
    return Config(data=data, train=TrainConfig(checkpoint_path=args.checkpoint))


def _write_batch(path, raw_ids, valid, scores, items, data, top_k) -> None:
    with open(path, "w") as f:
        f.write("userId,rank,movieId,title,score\n")
        for r, uid in enumerate(raw_ids[valid]):
            for rank in range(top_k):
                raw_m = int(data.raw_movie_id(int(items[r][rank])))
                title = str(data.title_of(raw_m)).replace(",", ";")
                f.write(f"{uid},{rank + 1},{raw_m},{title},{scores[r][rank]:.4f}\n")


def cmd_recommend(args) -> int:
    """Load the data and split, load the checkpoint's layer-0 tables, print
    top-k with train-seen items excluded (reference recommend.py:115-156)."""
    import numpy as np

    from .serving.recommend import (batch_recommend_users, recommend_from_movie,
                                    recommend_from_user, train_seen_items)
    from .training.checkpoint import load_params
    from .training.pipeline import prepare_training_data
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _build_cfg(args)
    bundle = prepare_training_data(cfg)
    data = bundle.data
    if not os.path.exists(cfg.train.checkpoint_path):
        print(f"checkpoint {cfg.train.checkpoint_path} not found — train first")
        return 1
    params, _ = load_params(cfg.train.checkpoint_path, device)

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
    excluded = (train_seen_items(bundle.splits[0], data.num_users, uidx)
                if uidx >= 0 else None)
    out = recommend_from_user(params, user_id, data, excluded, top_k=args.top_k)
    if "error" in out:
        print(out["error"])
        return 1
    print(f"Top {args.top_k} Recommendations for user {user_id}:")
    for i, rec in enumerate(out["recommendations"], 1):
        print(f"{i}. {rec['title']} (Score: {rec['score']:.4f})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="movie_recommender_system_with_gnns_tpu_torch")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cuda, cuda:1 or cpu (default: cuda)")
    ap.add_argument("--dataset", default="synthetic",
                    help="ml-25m | ml-1m | ml-100k | synthetic")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--indexes-dir", default="data/indexes")
    ap.add_argument("--checkpoint", default="best_model.npz")
    ap.add_argument("--synthetic-users", type=int, default=943)
    ap.add_argument("--synthetic-items", type=int, default=1682)
    ap.add_argument("--synthetic-interactions", type=int, default=100_000)
    ap.add_argument("--synthetic-communities", type=int, default=0,
                    help="planted taste communities of the synthetic graph")
    ap.add_argument("--synthetic-power", type=float, default=1.1,
                    help="Zipf exponent of the synthetic graph's degrees")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("train", help="not ported yet")
    pr = sub.add_parser("recommend", help="top-k retrieval")
    pr.add_argument("--user-id", type=int, default=None)
    pr.add_argument("--movie-id", type=int, default=None)
    pr.add_argument("--top-k", type=int, default=10)
    pr.add_argument("--users-file", default=None,
                    help="batch mode: file with one raw userId per line")
    pr.add_argument("--out", default=None, help="batch mode output CSV path")
    sub.add_parser("eda", help="not ported yet")

    args = ap.parse_args(argv)
    if args.cmd == "recommend":
        return cmd_recommend(args)
    print(f"'{args.cmd}' is not ported to the PyTorch package yet; run it "
          "with movie_recommender_system_with_gnns_tpu.cli", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
