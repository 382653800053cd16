"""Plain reference of LightGCN training over the whole train graph, in float32
(TF32 off): the normalised adjacency, K propagation hops, the layer-mean
readout, the BPR loss with K negatives, clip by global norm and Adam under a
warm-up then cosine learning rate. Nothing here imports the port.

The adjacency is the GCN normalisation of the directed train edges
``src → dst``: ``w = d(src)^-1/2 · d(dst)^-1/2`` with ``d`` the in-degree, a
hop summing ``w · x[src]`` into each ``dst`` (PyG's ``LGConv``), as a sparse
CSR product; its backward is the product with the transposed matrix.

``lowp=True`` is the control: the same steps with the tables, every hop's
input and output, the triplet rows and the gradients rounded to bfloat16
(the next precision below the configuration's float32).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Adjacency(NamedTuple):
    a: torch.Tensor        # (N, N) sparse CSR, rows = dst
    at: torch.Tensor       # its transpose, rows = src
    num_nodes: int


def build_adjacency(train_edges: np.ndarray, num_nodes: int, device,
                    lowp: bool = False) -> Adjacency:
    src = torch.from_numpy(train_edges[0].astype(np.int64)).to(device)
    dst = torch.from_numpy(train_edges[1].astype(np.int64)).to(device)
    deg = torch.bincount(dst, minlength=num_nodes).double()
    dinv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    w = (dinv[src] * dinv[dst]).float()
    if lowp:
        w = w.bfloat16().float()

    def csr(rows, cols):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # sparse CSR is "beta"
            coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), w,
                                          (num_nodes, num_nodes)).coalesce()
            return coo.to_sparse_csr()

    return Adjacency(csr(dst, src), csr(src, dst), num_nodes)


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return torch.sparse.mm(adj.a, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.adj.at, g.contiguous()), None


def _round(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    return x.bfloat16().float() if lowp else x


def propagate(e0: torch.Tensor, adj: Adjacency, layers: int, readout: str,
              lowp: bool = False) -> torch.Tensor:
    acc, cur = e0, e0
    for _ in range(layers):
        cur = _round(_Hop.apply(_round(cur, lowp), adj), lowp)
        acc = acc + cur
    final = acc / (layers + 1)
    if readout == "reference":
        final = final / (layers + 1)
    elif readout != "standard":
        raise ValueError(f"unknown readout {readout!r}")
    return final


def bpr_loss(uf, ue, pf, pe, nf, ne, coeff: float, kind: str) -> torch.Tensor:
    """BPR over (B, d) user and positive rows and (B, K, d) negative rows.
    ``standard``: softplus(⟨u,n⟩ − ⟨u,p⟩) averaged over K and B; ``reference``:
    the reference repo's −mean(softplus(10·(cos⁺ − cos⁻)))/10. Both add
    ``coeff`` × the mean over B·d of the initial rows' squares (negatives
    averaged over K)."""
    reg = coeff * (ue.square() + pe.square() + ne.square().mean(dim=1)).mean()
    if kind == "standard":
        pos = (uf * pf).sum(-1)
        neg = torch.einsum("bd,bkd->bk", uf, nf)
        return F.softplus(neg - pos[:, None]).mean() + reg
    if kind == "reference":
        unit = lambda x: x / x.square().sum(-1, keepdim=True).sqrt()
        nu, npos, nneg = unit(uf), unit(pf), unit(nf)
        cpos = (nu * npos).sum(-1)
        cneg = torch.einsum("bd,bkd->bk", nu, nneg)
        return -F.softplus(10.0 * (cpos[:, None] - cneg)).mean() / 10.0 + reg
    raise ValueError(f"unknown loss {kind!r}")


def lr_at(t: int, train: dict) -> float:
    """Learning rate of optimizer step ``t`` (0-based): linear warm-up from 0
    over ``lr_warmup_steps``, then cosine decay to ``lr_final_frac`` × peak at
    ``lr_total_steps``; ``lr_schedule="constant"`` keeps ``lr``."""
    peak = train["lr"]
    if train.get("lr_schedule", "constant") == "constant":
        return peak
    warm, total = train["lr_warmup_steps"], train["lr_total_steps"]
    end = peak * train.get("lr_final_frac", 0.0)
    if t < warm:
        return peak * t / warm
    frac = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    return end + 0.5 * (peak - end) * (1.0 + math.cos(math.pi * frac))


class Steps(NamedTuple):
    losses: List[float]            # each step's loss
    weights: List[float]           # each step's weight in the epoch's mean loss
    mu: List[torch.Tensor]         # Adam's first moment after the last step, per table
    change: List[torch.Tensor]     # the tables' change after the last step


class Step(NamedTuple):
    """One optimizer step's inputs: the graph it propagates over, its real
    triplets (users (B,), 0-based positive items (B,), negatives (B,) or
    (B, K)) and its weight in the epoch's mean loss."""

    adj: Adjacency
    users: torch.Tensor
    pos: torch.Tensor
    neg: torch.Tensor
    weight: float


def train_steps(user0: torch.Tensor, item0: torch.Tensor, steps: List[Step],
                model: dict, train: dict, lowp: bool = False) -> Steps:
    """Run one Adam step per entry of ``steps`` from the given tables (not
    modified)."""
    with_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(user0, item0, steps, model, train, lowp)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = with_tf32


def _train_steps(user0, item0, steps, model, train, lowp) -> Steps:
    num_users = user0.shape[0]
    tables = [_round(user0.detach().float().clone(), lowp),
              _round(item0.detach().float().clone(), lowp)]
    start = [t.clone() for t in tables]
    mu = [torch.zeros_like(t) for t in tables]
    nu = [torch.zeros_like(t) for t in tables]
    b1, b2, eps = train["adam_b1"], train["adam_b2"], train["adam_eps"]
    losses = []
    for t, (adj, u, p, n, _) in enumerate(steps):
        n = n.reshape(n.shape[0], -1)
        leaves = [x.clone().requires_grad_(True) for x in tables]
        with torch.enable_grad():
            final = propagate(torch.cat(leaves), adj, model["layers"], model["readout"], lowp)
            uf, itf = final[:num_users], final[num_users:]
            rows = lambda tab, idx: _round(tab.index_select(0, idx.reshape(-1).long()), lowp)
            k = n.shape[1]
            nf = rows(itf, n).view(-1, k, uf.shape[1])
            ne = rows(leaves[1], n).view(-1, k, uf.shape[1])
            loss = bpr_loss(rows(uf, u), rows(leaves[0], u), rows(itf, p), rows(leaves[1], p),
                            nf, ne, train["bpr_coeff"], train["loss"])
            grads = [_round(g, lowp) for g in torch.autograd.grad(loss, leaves)]
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = 1.0 if float(norm) < train["grad_clip_norm"] else train["grad_clip_norm"] / float(norm)
        grads = [g * scale for g in grads]
        # optax's Adam: bias corrections in float32, eps outside the root
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t + 1))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t + 1))
        lr = lr_at(t, train)
        with torch.no_grad():
            for x, g, m, v in zip(tables, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                x.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + eps))
                x.copy_(_round(x, lowp))
    return Steps(losses, [st.weight for st in steps], mu,
                 [x - s for x, s in zip(tables, start)])


def gap_of_norms(program: List[float], reference: List[float]) -> float:
    """The worst table's |‖program‖ − ‖reference‖| over the larger of its
    reference norm and the median table's. Tables whose reference norm is
    under a thousandth of the median's are left out (round-off alone moves
    them)."""
    med = float(np.median(reference))
    worst = 0.0
    for p, r in zip(program, reference):
        if r < 1e-3 * med:
            continue
        worst = max(worst, abs(p - r) / max(r, med))
    return worst


def compare(mean_loss: float, mu_norms: List[float], change_norms: List[float],
            ref: Steps) -> Dict[str, float]:
    """The compared numbers of a training cell: the epoch's mean loss, and
    the worst table's gap of norms of Adam's first moment (every step's
    clipped gradient, as the optimizer got it) and of the tables' change
    after the epoch."""
    rl = sum(w * x for w, x in zip(ref.weights, ref.losses)) / sum(ref.weights)
    return {
        "loss_gap": abs(mean_loss - rl) / abs(rl),
        "moment_gap": gap_of_norms(mu_norms, [float(m.double().norm()) for m in ref.mu]),
        "change_gap": gap_of_norms(change_norms,
                                   [float(c.double().norm()) for c in ref.change]),
    }
