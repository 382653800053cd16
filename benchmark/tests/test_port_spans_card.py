"""The port's counters on the card: ``host_sync`` counts each blocking wait
of a dispatch, and the full-node epoch's ``graph.capture`` and
``graph.replay`` count its capture and its replays. They need a CUDA device
and skip without one; run with ``python -m pytest benchmark/tests -m card``."""

import warnings

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card


@pytest.fixture
def obs():
    from movie_recommender_system_with_gnns_tpu_torch.utils import observability

    observability.clear()
    yield observability
    observability.clear()


def _data():
    from movie_recommender_system_with_gnns_tpu_torch.data.movielens import (
        make_synthetic_movielens)

    return make_synthetic_movielens(num_users=300, num_items=500, num_interactions=6000,
                                    seed=0)


def test_host_sync_counts_each_sync_of_a_dispatch(card, obs):
    """Under ``set_sync_debug_mode("warn")`` one ``batch_recommend`` warns
    once for each ``host_sync`` it counts."""
    from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import LightGCNParams
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import ServingIndex

    data = _data()
    gen = torch.Generator(device=card).manual_seed(0)
    params = LightGCNParams(torch.randn((data.num_users, 64), generator=gen, device=card),
                            torch.randn((data.num_items, 64), generator=gen, device=card))
    index = ServingIndex.build(params, data.edge_index, data.num_users)
    users = np.arange(0, data.num_users, 2)
    index.batch_recommend(users)          # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, obs.tracing():
            warnings.simplefilter("always")
            index.batch_recommend(users)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert obs.counts().get("host_sync") == len(syncs) == 2, [str(w.message) for w in caught]


def test_full_node_epoch_counts_its_capture_and_replays(card, obs):
    """The first epoch captures the step once and replays it K - 1 times
    (its first step runs eagerly); the next replays it K times."""
    from movie_recommender_system_with_gnns_tpu_torch.config import (Config, ModelConfig,
                                                                     TrainConfig)
    from movie_recommender_system_with_gnns_tpu_torch.data.partition import (
        partition_bipartite_greedy)
    from movie_recommender_system_with_gnns_tpu_torch.training.pipeline import (
        build_cluster_batches)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import (
        StackedClusters, create_train_state, make_epoch_fn)

    data = _data()
    n = data.num_users + data.num_items
    parts = [p for p in partition_bipartite_greedy(data.edge_index, data.num_users, n, 4)
             if p.shape[1] > 0]
    stacked = StackedClusters.from_batches(
        build_cluster_batches(parts, data.num_users, n, bucket_floor=256, device=card))
    cfg = Config(model=ModelConfig(num_layers=2, dim=16), train=TrainConfig(lr=1e-2))
    state = create_train_state(cfg, data.num_users, data.num_items, device=card)
    fn = make_epoch_fn(cfg)
    k = stacked.num_clusters
    with obs.tracing():
        state, _ = fn(state, stacked, torch.Generator(device=card).manual_seed(1))
        first = obs.counts()
        state, _ = fn(state, stacked, torch.Generator(device=card).manual_seed(2))
    assert first["graph.capture"] == 1 and first.get("graph.replay", 0) == k - 1
    assert obs.counts()["graph.capture"] == 1 and obs.counts()["graph.replay"] == 2 * k - 1
    names = {r.name for r in obs.span_records()}
    assert {"train.epoch", "train.draws", "train.prepare", "graph.run", "train.wait"} <= names
