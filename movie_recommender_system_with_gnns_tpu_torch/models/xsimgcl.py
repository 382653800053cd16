"""XSimGCL (Yu et al., "XSimGCL: Towards Extremely Simple Graph Contrastive
Learning for Recommendation", IEEE TKDE 2023, arXiv:2209.02544; the
authors' SELFRec ``model/graph/XSimGCL.py``): LightGCN's tables and
propagation, with noise added to every hop while training and an in-batch
InfoNCE between the readout and one perturbed hop.

With Â the normalised train adjacency and ``E0 = [U; I]`` (the same
:class:`~.lightgcn.LightGCNParams` tables as LightGCN):

  * hop ``l = 1..L``: ``E_l = Â E_{l-1}``, then, while training,
    ``E_l += eps · sign(E_l) ⊙ rownorm(N_l)`` with ``N_l ~ U(0,1)^{n×d}``
    drawn anew each step; the perturbed table feeds the next hop;
  * readout ``Z = (1/L) Σ_{l=1..L} E_l`` (layer 0 left out) and the
    contrastive view ``Z' = E_{l*}`` (``cl_layer``, 1-based);
  * eval and serving propagate without noise (:func:`propagate`).

``sign`` has zero derivative almost everywhere, so a perturbed hop's
Jacobian is Â: the symmetric VJP of the full-graph trainer still holds, and
the noise adds nothing to the backward.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.observability import trace_span
from .lightgcn import LightGCNParams
from .lightgcn import propagate as lightgcn_propagate


def rownorm(noise: torch.Tensor) -> torch.Tensor:
    """Each row over its L2 norm (``F.normalize(noise, dim=-1)``: a norm
    under 1e-12 counts as 1e-12)."""
    return F.normalize(noise, dim=-1)


def perturb(e: torch.Tensor, noise: torch.Tensor, eps: float) -> torch.Tensor:
    """``e + eps · sign(e) ⊙ rownorm(noise)``; its gradient with respect to
    ``e`` is the identity (``sign`` is taken off the graph)."""
    with trace_span("xsimgcl.perturb"):
        return e + eps * e.detach().sign() * rownorm(noise.to(e.dtype))


def propagate_perturbed(
    params: LightGCNParams,
    graph,
    spmm: Callable[[object, torch.Tensor], torch.Tensor],
    num_layers: int,
    cl_layer: int,
    eps: float,
    noise: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training propagation: ``(Z_users, Z_items, Z'_users, Z'_items)``.

    ``noise`` (num_layers, n, d) holds each hop's raw U(0,1) draw; None, or
    ``eps == 0``, propagates without noise."""
    if not 1 <= cl_layer <= num_layers:
        raise ValueError(f"cl_layer={cl_layer} must lie in 1..num_layers={num_layers}")
    if noise is not None and noise.shape[0] < num_layers:
        raise ValueError(f"noise holds {noise.shape[0]} hops, the model {num_layers}")
    nu = params.user_emb.shape[0]
    cur = torch.cat([params.user_emb, params.item_emb], dim=0)
    acc = None
    view = None
    for layer in range(num_layers):
        cur = spmm(graph, cur)
        if noise is not None and eps != 0:
            cur = perturb(cur, noise[layer], eps)
        acc = cur if acc is None else acc + cur
        if layer + 1 == cl_layer:
            view = cur
    z = acc / num_layers
    return z[:nu], z[nu:], view[:nu], view[nu:]


def propagate(
    params: LightGCNParams,
    graph,
    spmm: Callable[[object, torch.Tensor], torch.Tensor],
    num_layers: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval and serving: the mean of hops 1..L without noise, split into the
    user and item tables."""
    z_u, z_i, _, _ = propagate_perturbed(params, graph, spmm, num_layers, 1, 0.0, None)
    return z_u, z_i


def final_tables(params: LightGCNParams, graph, spmm: Callable, cfg
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configured model's unperturbed (user, item) readout: LightGCN's
    :func:`~.lightgcn.propagate` (its readout factor as configured), or
    XSimGCL's :func:`propagate`."""
    from ..config import check_model

    if check_model(cfg) == "xsimgcl":
        return propagate(params, graph, spmm, cfg.model.num_layers)
    return lightgcn_propagate(params, graph, spmm, cfg.model.num_layers, cfg.model.readout)
