"""Faults planted in the port's timed path, to show that ``correct`` catches
them: each is a context manager that swaps one of the port's functions for a
broken one while it is open. Used by the calibration script (readings on the
card at a cell's size) and by the tests (at a small size on the CPU).

  * ``serve_altered``: every served row's first id moved to the next item;
  * ``serve_half``: a dispatch answers only the first half of its users;
  * ``train_unchanged``: the optimizer returns the state it was given (the
    full-graph epoch's update, the full-node step's Adam);
  * ``train_half``: the loss masks out the second half of every batch and
    takes its mean over the rest.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def _swap(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def serve_altered():
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import ServingIndex

    real = ServingIndex.batch_recommend

    def broken(self, *a, **kw):
        s, ids = real(self, *a, **kw)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % self.num_items
        return s, ids

    return _swap(ServingIndex, "batch_recommend", broken)


def serve_half():
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import ServingIndex

    real = ServingIndex.batch_recommend

    def broken(self, users, *a, **kw):
        s, ids = real(self, users, *a, **kw)
        half = s.shape[0] // 2
        return s[:half], ids[:half]

    return _swap(ServingIndex, "batch_recommend", broken)


@contextmanager
def train_unchanged():
    from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph, train

    real = fullgraph.make_optimizer

    def broken(cfg):
        opt = real(cfg)
        return opt._replace(update=lambda params, grads, opt_state: (params, opt_state))

    with _swap(fullgraph, "make_optimizer", broken), \
            _swap(train, "adam_step_table_", lambda *a, **kw: None):
        yield


@contextmanager
def train_half():
    from movie_recommender_system_with_gnns_tpu_torch.training import fullgraph, train

    real = train.compute_loss

    def broken(params, graph, batch, neg_item, cfg, spmm):
        b = batch.mask.shape[0]
        keep = torch.arange(b, device=batch.mask.device) < b // 2
        return real(params, graph, batch._replace(mask=batch.mask & keep), neg_item, cfg, spmm)

    with _swap(fullgraph, "compute_loss", broken), _swap(train, "compute_loss", broken):
        yield


FAULTS = {"serve_altered": serve_altered, "serve_half": serve_half,
          "train_unchanged": train_unchanged, "train_half": train_half}
