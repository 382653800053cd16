"""PyTorch/CUDA port of the LightGCN recommender, held against the JAX package.

The port mirrors the JAX package's subpackage and file names so each module's
counterpart is easy to find. It imports ``torch`` and nothing of JAX or of the
JAX package: host NumPy code it needs is copied here. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``
(:func:`utils.device.resolve_device`).

Ported so far: the batched serving path, whose fused score-and-chunk-max pass
of exact top-k retrieval is a hand-written CUDA kernel
(``csrc/score_chunkmax.cu``, bound in ``ops/cuda_mips.py``), and training with
the full-node and compact cluster trainers, whose fused BPR loss and gradients
are a second one (``csrc/bpr_tile.cu``, bound in ``ops/cuda_bpr.py``), the
full-graph trainer, multi-device training over ``torch.distributed``
(``parallel/``, ``training/distributed.py``, ``training/compact_sharded.py``),
checkpoints and elastic recovery, and the user-facing surface: the
reference's data-handler API (``data/handler.py``), the dataset download,
the milestone configs, ``cli eda`` (``utils/eda.py``) and the plots
(``utils/visualizations.py``); and the epochs' row-op roofline
(``utils/roofline.py``), which the example drivers
(``examples/torch_*.py``) beside the package report against.
"""

from .config import Config
from .models.lightgcn import LightGCNParams, init_params, params_from_numpy

__all__ = ["Config", "LightGCNParams", "init_params", "params_from_numpy"]
