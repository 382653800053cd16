"""Configuration tree of the port: the JAX package's frozen dataclasses, field
for field, so one JSON config (``Config.to_json``) loads in both packages.

Fields that only parts not ported yet read (the sharded hybrid path, the
microbatched loss, the chunked-ELL remainder's width) are kept so a config
written by either package round-trips unchanged. Full-state checkpoints
(``state_checkpoint_path`` / ``state_checkpoint_every``) are written by
``training/train.py::train_model`` and read by ``training/recovery.py``.

Reference defaults (reference repo file:line):
  * ``num_layers=3`` training override, ``dim_h=64``   — train_test.py:274, light_gcn.py:14
  * ``train_size=0.9`` then 50/50 val/test               — dataset_handler.py:144,:167-168
  * ``num_train_clusters=100``                            — dataset_handler.py:256
  * ``bpr_coeff=5e-3``, Adam ``lr=1e-3``, clip 1.0        — train_test.py:21,:216,:95
  * rating filter ``>= 4.0``                              — dataset_handler.py:106
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset ingest and split."""

    dataset: str = "ml-25m"           # ml-100k | ml-1m | ml-25m | synthetic
    data_dir: str = "data/movielens-25m"
    indexes_dir: str = "data/indexes"
    min_rating: float = 4.0
    train_size: float = 0.9
    val_test_ratio: float = 0.5
    split_seed: int = 0
    # "edge" splits the direction-doubled edge list as the reference does;
    # "interaction" splits unique (user, item) pairs and doubles each split
    # (no held-out pair leaks into the train graph)
    split_level: str = "edge"
    synthetic_users: int = 1000
    synthetic_items: int = 1700
    synthetic_interactions: int = 100_000
    synthetic_communities: int = 0     # >0 plants taste communities
    synthetic_power: float = 1.1


@dataclass(frozen=True)
class ModelConfig:
    """LightGCN hyperparameters."""

    num_layers: int = 3
    dim: int = 64
    init_std: float = 0.01
    # "reference" keeps the reference's double 1/(K+1) readout factor;
    # "standard" is the LightGCN-paper mean over layers
    readout: str = "reference"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation loop."""

    epochs: int = 3
    lr: float = 1e-3
    lr_schedule: str = "constant"     # constant | cosine
    lr_warmup_steps: int = 0
    lr_total_steps: int = 0
    lr_final_frac: float = 0.0
    bpr_coeff: float = 5e-3
    loss: str = "reference"           # reference | standard
    grad_clip_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    seed: int = 0
    num_clusters: int = 100
    use_clusters: bool = True
    partitioner: str = "greedy"       # greedy | random_edges
    partition_balance_tol: float = 0.0
    trainer: str = "compact"          # compact | full | fullgraph
    fullgraph_steps: int = 16
    hybrid_parts: int = 0
    symmetric_vjp: bool = True
    loss_microbatches: int = 0
    hybrid_block_dtype: str = "bfloat16"
    hybrid_off_format: str = "ell"    # ell | coo
    hybrid_ell_width: int = 16
    num_negatives: int = 1
    negatives: str = "uniform"        # uniform | feasible | popularity
    negatives_power: float = 0.75
    optimizer: str = "adam"           # adam | lazy_adam | hybrid_adam | lazy_item_adam
    batch_size: Optional[int] = None
    spmm_chunks: int = 1
    fused_bpr: bool = False
    dense_adjacency: bool = True
    dense_adjacency_max_nodes: int = 4096
    eval_top_k: int = 100
    recall_num_samples: int = 10
    recall_sample_size: int = 100
    checkpoint_path: str = "best_model.npz"
    histories_dir: str = "data/histories"
    resume: bool = True
    state_checkpoint_path: Optional[str] = None
    state_checkpoint_every: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ``cli train --mesh DPxMP`` sets it, and
    ``training/distributed.py::train_model_sharded`` builds its default mesh
    from it (``parallel/mesh.py::make_mesh``: rank ``d·mp + m`` at ``(d, m)``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data_parallel, self.model_parallel)


@dataclass(frozen=True)
class ServeConfig:
    """Retrieval serving."""

    top_k: int = 10
    block_items: int = 8192
    checkpoint_path: str = "best_model.npz"


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        return Config(
            data=DataConfig(**raw.get("data", {})),
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
            serve=ServeConfig(**raw.get("serve", {})),
        )
