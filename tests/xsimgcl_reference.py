"""The tests' plain reference of XSimGCL (``benchmark/reference/xsimgcl.py``
is the benchmark's copy): training over the whole train graph (Yu et al.,
TKDE 2023, arXiv:2209.02544; SELFRec ``model/graph/XSimGCL.py``), in float32
with TF32 off. Nothing here imports the port or JAX.

With Â the GCN normalisation of the directed train edges (a hop sums
``w · x[src]`` into each ``dst``, ``w = d(src)^-1/2 d(dst)^-1/2``, ``d`` the
in-degree; a sparse CSR product, its backward the transposed one) and
``E0 = [U; I]``:

  * hop ``l = 1..L``: ``E_l = Â E_{l-1} + eps · sign(Â E_{l-1}) ⊙ rownorm(N_l)``,
    ``N_l`` the step's raw U(0,1) draw for that hop, ``rownorm`` each row
    over its L2 norm (``F.normalize``); ``sign`` carries no gradient;
  * ``Z = (1/L) Σ_{l=1..L} E_l``, the contrastive view ``Z' = E_{l*}``;
  * loss ``= BPR(Z) + reg + λ [InfoNCE(Z_U[Ū], Z'_U[Ū]) + InfoNCE(Z_I[Ī], Z'_I[Ī])]``
    with Ū, Ī the step's distinct users and distinct positive items
    (``torch.unique``) and ``InfoNCE(A, B) = mean_i [−â_i·b̂_i/τ +
    log Σ_j exp(â_i·b̂_j/τ)]`` on rows over their norms;
  * clip by global norm, then Adam (optax's form: bias corrections in
    float32, eps outside the root).

Departures from SELFRec, each a setting of the configuration rather than of
the model: BPR is the repository's ``standard`` loss (softplus(⟨u,n⟩ −
⟨u,p⟩) averaged over the batch, plus ``bpr_coeff`` × the mean square of the
layer-0 triplet rows) where SELFRec adds ``reg`` × Σ‖row‖₂ / B; the batch is
a whole full-graph step; the gradient is clipped at ``grad_clip_norm``.

The InfoNCE is computed in blocks of :data:`BLOCK` rows with its backward
written out (``dÂ = (P B̂ − B̂)/(τ n)``, ``dB̂ = (Pᵀ Â − Â)/(τ n)``, P recomputed
from the saved log-sum-exp), so that the (n, n) logits are never held whole.

``lowp=True`` is the control: the same steps in the next precision below
the one each tensor is stated in: the tables, every hop's input and output,
the triplet rows and the gradients in bfloat16 (stated float32), and the
InfoNCE's operands in float8 e4m3 (stated bfloat16).
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

#: rows of a block of the InfoNCE's logits (BLOCK × n floats at a time)
BLOCK = 4096


class Adjacency(NamedTuple):
    a: torch.Tensor        # (N, N) sparse CSR, rows = dst
    at: torch.Tensor       # its transpose, rows = src
    num_nodes: int


def build_adjacency(train_edges: np.ndarray, num_nodes: int, device) -> Adjacency:
    src = torch.from_numpy(train_edges[0].astype(np.int64)).to(device)
    dst = torch.from_numpy(train_edges[1].astype(np.int64)).to(device)
    deg = torch.bincount(dst, minlength=num_nodes).double()
    dinv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    w = (dinv[src] * dinv[dst]).float()

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


def _round(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype).float()


def propagate(e0: torch.Tensor, adj: Adjacency, layers: int, cl_layer: int, eps: float,
              noise: Optional[torch.Tensor], lowp: bool = False):
    """``(Z, Z')`` of the tables ``e0`` (n, d); ``noise`` (L, n, d) raw U(0,1)
    or None (no noise: eval and serving)."""
    low = torch.bfloat16 if lowp else None
    cur, acc, view = e0, None, None
    for layer in range(layers):
        cur = _round(_Hop.apply(_round(cur, low), adj), low)
        if noise is not None and eps != 0:
            cur = _round(cur + eps * cur.detach().sign() * F.normalize(noise[layer], dim=-1),
                         low)
        acc = cur if acc is None else acc + cur
        if layer + 1 == cl_layer:
            view = cur
    return acc / layers, view


class _InfoNCE(torch.autograd.Function):
    """The mean InfoNCE of unit rows ``ah``, ``bh`` (n, d), blockwise; with
    ``operand`` the rows are rounded to it first, and the gradient with
    respect to the unrounded rows is that of the rounded ones."""

    @staticmethod
    def forward(ctx, ah, bh, tau, operand):
        ah, bh = _round(ah, operand), _round(bh, operand)
        n = ah.shape[0]
        lse = torch.empty(n, dtype=torch.float32, device=ah.device)
        for i in range(0, n, BLOCK):
            e = min(i + BLOCK, n)
            lse[i:e] = torch.logsumexp(ah[i:e] @ bh.T / tau, dim=1)
        loss = (lse - (ah * bh).sum(-1) / tau).mean()
        ctx.save_for_backward(ah, bh, lse)
        ctx.tau = tau
        return loss

    @staticmethod
    def backward(ctx, g):
        ah, bh, lse = ctx.saved_tensors
        tau, n = ctx.tau, ah.shape[0]
        da = torch.empty_like(ah)
        db = torch.zeros_like(bh)
        for i in range(0, n, BLOCK):
            e = min(i + BLOCK, n)
            p = torch.exp(ah[i:e] @ bh.T / tau - lse[i:e, None])
            da[i:e] = p @ bh
            db += p.T @ ah[i:e]
        scale = g / (tau * n)
        return (da - bh) * scale, (db - ah) * scale, None, None


def infonce(a: torch.Tensor, b: torch.Tensor, tau: float,
            operand: Optional[torch.dtype] = None) -> torch.Tensor:
    """InfoNCE of the rows of ``a`` against those of ``b`` (each over its
    norm, then rounded to ``operand`` where given)."""
    if a.shape[0] == 0:
        return a.sum() * 0.0
    return _InfoNCE.apply(F.normalize(a, dim=-1), F.normalize(b, dim=-1), float(tau),
                          operand)


def bpr_standard(uf, ue, pf, pe, nf, ne, coeff: float) -> torch.Tensor:
    """softplus(⟨u,n⟩ − ⟨u,p⟩) averaged over K and B, plus ``coeff`` × the
    mean over B·d of the layer-0 rows' squares (negatives averaged over K);
    negatives (B, K, d)."""
    reg = coeff * (ue.square() + pe.square() + ne.square().mean(dim=1)).mean()
    pos = (uf * pf).sum(-1)
    neg = torch.einsum("bd,bkd->bk", uf, nf)
    return F.softplus(neg - pos[:, None]).mean() + reg


class Step(NamedTuple):
    """One optimizer step's inputs: the graph, its real triplets (users (B,),
    0-based positive items (B,), negatives (B,) or (B, K)), its weight in
    the epoch's mean loss, and the raw U(0,1) noise of its hops (L, n, d)."""

    adj: Adjacency
    users: torch.Tensor
    pos: torch.Tensor
    neg: torch.Tensor
    weight: float
    noise: Optional[torch.Tensor]


class Steps(NamedTuple):
    losses: List[float]            # each step's loss
    weights: List[float]           # each step's weight in the epoch's mean loss
    mu: List[torch.Tensor]         # Adam's first moment after the last step, per table
    change: List[torch.Tensor]     # the tables' change after the last step


def step_loss(leaves, st: Step, model: dict, train: dict, lowp: bool = False):
    """One step's loss from the layer-0 tables ``leaves`` (user, item)."""
    low = torch.bfloat16 if lowp else None
    num_users = leaves[0].shape[0]
    z, view = propagate(torch.cat(leaves), st.adj, model["layers"], model["cl_layer"],
                        model["cl_eps"], st.noise, lowp)
    zu, zi, vu, vi = z[:num_users], z[num_users:], view[:num_users], view[num_users:]
    n = st.neg.reshape(st.neg.shape[0], -1).long()
    rows = lambda tab, idx: _round(tab.index_select(0, idx.reshape(-1).long()), low)
    k, d = n.shape[1], zu.shape[1]
    loss = bpr_standard(rows(zu, st.users), rows(leaves[0], st.users), rows(zi, st.pos),
                        rows(leaves[1], st.pos), rows(zi, n).view(-1, k, d),
                        rows(leaves[1], n).view(-1, k, d), train["bpr_coeff"])
    if train["cl_weight"]:
        operand = torch.float8_e4m3fn if lowp else None
        us, its = torch.unique(st.users), torch.unique(st.pos)
        cl = (infonce(zu[us], vu[us], train["cl_temperature"], operand)
              + infonce(zi[its], vi[its], train["cl_temperature"], operand))
        loss = loss + train["cl_weight"] * cl
    return loss


def lr_at(t: int, train: dict) -> float:
    """Learning rate of optimizer step ``t``: ``lr``, constant (the
    configuration's ``lr_schedule``)."""
    if train.get("lr_schedule", "constant") != "constant":
        raise ValueError("the XSimGCL reference runs a constant learning rate")
    return train["lr"]


def train_steps(user0: torch.Tensor, item0: torch.Tensor, steps: List[Step],
                model: dict, train: dict, lowp: bool = False) -> Steps:
    """One Adam step per entry of ``steps`` from the given tables (not
    modified), TF32 off for the duration."""
    with_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(user0, item0, steps, model, train, lowp)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = with_tf32


def _train_steps(user0, item0, steps, model, train, lowp) -> Steps:
    low = torch.bfloat16 if lowp else None
    tables = [_round(user0.detach().float().clone(), low),
              _round(item0.detach().float().clone(), low)]
    start = [t.clone() for t in tables]
    mu = [torch.zeros_like(t) for t in tables]
    nu = [torch.zeros_like(t) for t in tables]
    b1, b2, eps = train["adam_b1"], train["adam_b2"], train["adam_eps"]
    losses = []
    for t, st in enumerate(steps):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        with torch.enable_grad():
            loss = step_loss(leaves, st, model, train, lowp)
            grads = [_round(g, low) for g in torch.autograd.grad(loss, leaves)]
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        scale = 1.0 if float(norm) < train["grad_clip_norm"] else train["grad_clip_norm"] / float(norm)
        grads = [g * scale for g in grads]
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t + 1))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t + 1))
        lr = lr_at(t, train)
        with torch.no_grad():
            for x, g, m, v in zip(tables, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                x.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + eps))
                x.copy_(_round(x, low))
    return Steps(losses, [st.weight for st in steps], mu,
                 [x - s for x, s in zip(tables, start)])


def readout(user_emb: torch.Tensor, item_emb: torch.Tensor, adj: Adjacency, layers: int):
    """Eval and serving: the mean of hops 1..L without noise, (users, items)."""
    z, _ = propagate(torch.cat([user_emb, item_emb]), adj, layers, 1, 0.0, None)
    return z[:user_emb.shape[0]], z[user_emb.shape[0]:]

