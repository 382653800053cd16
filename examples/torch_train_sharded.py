"""Example: mesh-sharded training (row-sharded tables over a mesh of ranks),
the PyTorch port's counterpart of ``examples/train_sharded.py``.

One rank per card over ``torch.distributed``, as ``cli train --mesh`` sets
it up (``parallel/mesh.py``). A 1x1 mesh runs in this process with no
launcher; a larger one needs one process per card:

    torchrun --nproc-per-node=8 examples/torch_train_sharded.py --mesh 2x4
    python examples/torch_train_sharded.py --mesh 1x1 [--device cpu]

The trainer is ``training/distributed.py::train_model_sharded``: row-sharded
embedding tables over the ``model`` ranks, per-layer all-gather propagation,
data-parallel BPR over the ``data`` ranks, a clip over all shards and Adam on
each rank's rows; held against the single-device trainer by
``tests/test_torch_sharding.py``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x4")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--out", default="runs/sharded")
    ap.add_argument("--device", "--platform", dest="device", default="cuda",
                    help="cuda (default: each rank its card) or cpu (gloo); "
                    "--platform is the JAX driver's spelling")
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns the best checkpoint's path (on rank 0, else None)."""
    args = parse_args(argv)
    import torch.distributed as dist

    from movie_recommender_system_with_gnns_tpu_torch.config import (
        Config, MeshConfig, ModelConfig, TrainConfig)
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens, split_edges)
    from movie_recommender_system_with_gnns_tpu_torch.parallel.mesh import make_mesh
    from movie_recommender_system_with_gnns_tpu_torch.training.checkpoint import save_params
    from movie_recommender_system_with_gnns_tpu_torch.training.distributed import (
        train_model_sharded)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import build_eval_batch
    from movie_recommender_system_with_gnns_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    dp, mp = (int(x) for x in args.mesh.lower().split("x"))
    launched = dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)
    if dp * mp > 1 and not launched:
        raise ValueError(f"--mesh {args.mesh} needs {dp * mp} ranks, one card each; start "
                         f"them with torchrun --nproc-per-node={dp * mp} "
                         f"examples/torch_train_sharded.py --mesh {args.mesh}")
    owned = not dist.is_initialized()
    try:
        mesh = make_mesh(dp, mp, device=device)
        if mesh.is_main:
            print(f"mesh {dp}x{mp} over {dist.get_world_size()} ranks on {mesh.device}")
        os.makedirs(args.out, exist_ok=True)
        cfg = Config(
            model=ModelConfig(num_layers=3, dim=64),
            train=TrainConfig(epochs=args.epochs, batch_size=args.batch_size),
            mesh=MeshConfig(data_parallel=dp, model_parallel=mp),
        )
        data = make_synthetic_movielens(943, 1682, 100_000, seed=0)
        n = data.num_users + data.num_items
        train_e, val_e, test_e = split_edges(data, os.path.join(args.out, "indexes"))
        val = build_eval_batch(val_e, n, data.num_users, mesh.device)
        test = build_eval_batch(test_e, n, data.num_users, mesh.device)
        path = os.path.join(args.out, "best_model.npz")
        params, hist = train_model_sharded(
            cfg, data.num_users, data.num_items, train_e, val, test, mesh=mesh,
            save_checkpoint=lambda p, r: save_params(path, p, meta={"val_recall": r}),
        )
        if mesh.is_main:
            print("done; best checkpoint in", args.out)
        return path if mesh.is_main else None
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
