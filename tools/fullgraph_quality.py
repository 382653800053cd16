#!/usr/bin/env python3
"""Train through ``cli train`` and score the final tables as the JAX package's
``examples/train_ml25m_scale.py --eval-propagated`` does: full-ranking
Recall@k / NDCG@k on the test split with the K-layer propagated tables, by
raw inner products under ``--loss standard`` (cosine otherwise).

    python3 tools/fullgraph_quality.py [cli options] train [train options]

The arguments are ``cli``'s own (``--full-eval-k`` and ``--full-eval-users``
set k and the seeded sample of eval users; ``--full-eval`` is not needed).
The full-graph flagship on the ML-25M-statistics synthetic graph, with the
flags of ``runs/ml25m_fg150_k8_d256_pop.log`` in the CLI's spelling:

    python3 tools/fullgraph_quality.py --dataset synthetic \\
        --synthetic-users 162541 --synthetic-items 59047 \\
        --synthetic-interactions 18000000 --synthetic-communities 200 \\
        --synthetic-power 0.9 --epochs 150 --lr 3e-3 --dim 256 \\
        --readout standard train --trainer fullgraph --fullgraph-steps 16 \\
        --loss standard --num-negatives 8 --negatives popularity \\
        --lr-schedule cosine --lr-warmup-steps 32 --split-level interaction \\
        --full-eval-users 5000

Prints the CLI's training log, then one line with the test metrics and the
wall time of the whole run (data, training and eval).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from movie_recommender_system_with_gnns_tpu_torch import cli  # noqa: E402
from movie_recommender_system_with_gnns_tpu_torch.training.evaluate import (  # noqa: E402
    evaluate_full_ranking)


def main(argv=None) -> int:
    args = cli.build_parser().parse_args(argv)
    if args.cmd != "train":
        print("fullgraph_quality.py takes the arguments of `cli train`", file=sys.stderr)
        return 2
    t0 = time.time()
    mesh = cli.mesh_from_args(args)
    cfg, bundle, state = cli.train_from_args(args, mesh)
    train_e, _, test_e = bundle.splits
    normalize = cfg.train.loss != "standard"
    recall, ndcg = evaluate_full_ranking(
        state.params, train_e, test_e, bundle.data.num_users, k=args.full_eval_k,
        max_users=args.full_eval_users, use_propagated=True, cfg=cfg, normalize=normalize,
        mesh=mesh)
    if mesh is not None and not mesh.is_main:
        return 0
    print(f"TEST full-ranking Recall@{args.full_eval_k} {recall:.4f} "
          f"NDCG@{args.full_eval_k} {ndcg:.4f} (propagated, "
          f"{'cosine' if normalize else 'dot'} scores); wall {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
