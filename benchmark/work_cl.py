"""The work of XSimGCL's step, for the per-layer metrics of its cell
(``benchmark/metrics/train.infonce_roofline.py``, ``train_cl_mfu.py``).

Counted as ``work.py`` counts: what the op needs for the cell's shapes, not
what one kernel happens to do (the port's backward recomputes the logits,
which is not counted)."""

from __future__ import annotations

from benchmark.work import dispatch_model_flops, train_step_model_flops


def infonce_flops(rows: int, dim: int) -> float:
    """Model operations of one InfoNCE over ``rows`` distinct rows of width
    ``dim``: the (n, n) logits forward, every row scored against every row
    (``work.dispatch_model_flops``, 2·n²·d, the counter ``kernels/
    infonce.json`` names), and the two views' products with P backward, 4·n²·d."""
    return 3.0 * dispatch_model_flops(rows, rows, dim)


def train_step_cl_model_flops(edges: int, real_triplets: int, negatives: int, dim: int,
                              layers: int, users: int, items: int) -> float:
    """One XSimGCL step: LightGCN's model operations
    (``work.train_step_model_flops``) plus the InfoNCE of the step's
    ``users`` and ``items`` distinct rows."""
    return (train_step_model_flops(edges, real_triplets, negatives, dim, layers)
            + infonce_flops(users, dim) + infonce_flops(items, dim))
