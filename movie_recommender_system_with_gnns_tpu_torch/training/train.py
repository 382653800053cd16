"""Training engine: train step, cluster-epoch loop, evaluation, multi-epoch loop (JAX
package ``training/train.py``).

Capability parity with reference ``utils/train_test.py``:

  * one ``train_step(state, graph, batch, generator)`` replacing the eager
    per-cluster loop body (train_test.py:86-101): propagation + triplet gather
    + negative sampling + BPR + global-norm clip (max 1.0, train_test.py:95) +
    Adam (train_test.py:236);
  * cluster batches are padded to shared static shapes;
  * evaluation (train_test.py:136-163) propagates on the *eval* edge set, the
    reference's semantics (``model(val_data.edge_index)``), and computes the
    parity sampled-recall metric;
  * the multi-epoch loop (train_test.py:214-256) keeps histories, saves the
    best checkpoint on val-recall improvement, and runs a final test eval.

Clip and Adam follow optax, which the JAX package uses, not ``torch.optim``:
the clip scales by ``max_norm / norm`` only when ``norm > max_norm`` (no
``+1e-6``), and Adam's ``eps`` is added outside the square root of the
bias-corrected second moment. The update runs IN PLACE on the state's tables
and moments (no second copy of the tables per step); a caller that wants to
keep a state clones it first. The full-node trainer propagates through
``spmm_rows``, so that its step is bit-reproducible on the card. Its epoch
over cluster batches of one padded shape is fused, as JAX's ``lax.scan``
epoch is (``StackedClusters``, ``make_epoch_fn``): the clusters stacked on
the device, every draw made up front, and on the card the step captured
once as a CUDA graph and replayed per cluster; clusters of several shapes
take the per-cluster loop (``make_train_step`` + ``train_epoch``).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.graph import COOGraph
from ..models.lightgcn import LightGCNParams, init_params, propagate
from ..ops.bpr import select_bpr_loss
from ..ops.cuda_scatter import gather_rows, sort_rows
from ..ops.metrics import sampled_recall_at_k
from ..ops.sampling import (TripletBatch, check_negatives_mode, sample_negative,
                            triplets_from_edges)
from ..ops.spmm import DeviceCOO, spmm_rows, spmm_segment
from ..utils.device import DeviceLike, resolve_device
from ..utils.observability import count, trace_span


class AdamState(NamedTuple):
    """optax ``scale_by_adam`` state: step count and first/second moments."""

    count: int
    mu: LightGCNParams
    nu: LightGCNParams


class TrainState(NamedTuple):
    params: LightGCNParams
    opt_state: AdamState
    step: int


class Optimizer(NamedTuple):
    """``init(params) -> AdamState``; ``update(params, grads, opt_state) ->
    (params, opt_state)``, in place on the tables and moments."""

    init: Callable
    update: Callable


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """``lr_of(t)`` with t the 0-based optimizer step (optax evaluates the
    schedule at the count BEFORE the increment). ``"cosine"`` is linear warmup
    then cosine decay, piecewise equal to
    ``optax.warmup_cosine_decay_schedule``."""
    tc = cfg.train
    if tc.lr_schedule == "constant":
        return lambda t: tc.lr
    if tc.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")
    if tc.lr_total_steps <= 0:
        raise ValueError(
            "lr_schedule='cosine' needs lr_total_steps > 0 "
            "(set it to steps_per_epoch * epochs)")
    warm, total, peak = tc.lr_warmup_steps, tc.lr_total_steps, tc.lr
    init = 0.0 if warm > 0 else peak
    end = peak * tc.lr_final_frac

    def lr_of(t: int) -> float:
        if t < warm:
            return init + (peak - init) * t / max(warm, 1)
        frac = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
        return end + 0.5 * (peak - end) * (1.0 + math.cos(math.pi * frac))

    return lr_of


def bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1 - b1**count, 1 - b2**count)`` in float32, as optax evaluates them:
    1 - 0.999 in f32 is 1.3e-5 off the exact value, which a float64 here
    would not be. ``count`` is the step count after the increment."""
    return tuple(float(np.float32(1) - np.float32(b) ** np.float32(count))
                 for b in (b1, b2))


def adam_step_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
               nu: torch.Tensor, lr: float, bc1: float, bc2: float, b1: float,
               b2: float, eps: float) -> None:
    """One optax-form Adam step in place on ``p`` and its moments, from the
    clipped gradient ``g``: ``eps`` outside the square root of the
    bias-corrected second moment."""
    mu.mul_(b1).add_(g, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    denom = (nu / bc2).sqrt_().add_(eps)
    p.addcdiv_(mu, denom, value=-lr / bc1)


def make_adam(cfg: Config, lr_of: Optional[Callable[[int], float]] = None) -> Optimizer:
    """Adam alone (optax ``adam``), in place on the tables and moments, from
    gradients already clipped; ``lr_of(t)`` defaults to
    :func:`make_lr_schedule`. The sharded trainer clips with the norm over
    all shards and then runs this on its own rows."""
    tc = cfg.train
    lr_of = make_lr_schedule(cfg) if lr_of is None else lr_of
    b1, b2, eps = tc.adam_b1, tc.adam_b2, tc.adam_eps

    def init(params: LightGCNParams) -> AdamState:
        z = lambda: LightGCNParams(torch.zeros_like(params.user_emb),
                                   torch.zeros_like(params.item_emb))
        return AdamState(count=0, mu=z(), nu=z())

    @torch.no_grad()
    def update(params: LightGCNParams, grads, opt_state: AdamState
               ) -> Tuple[LightGCNParams, AdamState]:
        count = opt_state.count + 1
        bc1, bc2 = bias_corrections(count, b1, b2)
        lr = lr_of(opt_state.count)
        for p, g, mu, nu in zip(params, grads, opt_state.mu, opt_state.nu):
            adam_step_(p, g, mu, nu, lr, bc1, bc2, b1, b2, eps)
        return params, AdamState(count, opt_state.mu, opt_state.nu)

    return Optimizer(init, update)


def adam_step_table_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, lr: torch.Tensor, bc1: torch.Tensor,
                     bc2: torch.Tensor, b1: float, b2: float, eps: float) -> None:
    """:func:`adam_step_` with the learning rate and both bias corrections as
    device tensors, so that a captured step reads its own from a table, in
    optax's order: ``p - lr · (mu / bc1) / (sqrt(nu / bc2) + eps)``. It may
    differ from :func:`adam_step_`'s Python-scalar route in the last bit."""
    mu.mul_(b1).add_(g, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    denom = (nu / bc2).sqrt_().add_(eps)
    p.sub_((mu / bc1).div_(denom).mul_(lr))


def clip_by_global_norm(grads, max_norm: float) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm``: the gradients untouched when their
    global norm is below ``max_norm``, else ``(g / norm) * max_norm``; the
    factor stays on the device (no host sync per step)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    clip = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return [g * clip for g in grads]


def make_optimizer(cfg: Config) -> Optimizer:
    """clip-by-global-norm(1.0) → Adam, matching train_test.py:95,:236, as
    plain functions on tensors that follow ``optax.chain(clip_by_global_norm,
    adam)`` step for step."""
    adam = make_adam(cfg)
    max_norm = cfg.train.grad_clip_norm

    @torch.no_grad()
    def update(params: LightGCNParams, grads: LightGCNParams,
               opt_state: AdamState) -> Tuple[LightGCNParams, AdamState]:
        return adam.update(params, clip_by_global_norm(grads, max_norm), opt_state)

    return Optimizer(adam.init, update)


def create_train_state(cfg: Config, num_users: int, num_items: int,
                       generator: Optional[torch.Generator] = None,
                       device: DeviceLike = None) -> TrainState:
    """Fresh N(0, init_std²) tables and zero Adam moments on ``device``; the
    default generator is a CPU one seeded with ``cfg.train.seed``."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    params = init_params(num_users, num_items, cfg.model.dim, cfg.model.init_std,
                         generator=generator, device=device)
    return TrainState(params=params, opt_state=make_optimizer(cfg).init(params),
                      step=0)


def state_checkpoint_path(cfg: Config) -> Optional[str]:
    """Where ``train_model`` writes its periodic full-state checkpoints
    (tables + moments + counts + step): ``cfg.train.state_checkpoint_path``
    when it is set and ``state_checkpoint_every > 0``, else None."""
    tc = cfg.train
    if tc.state_checkpoint_path and tc.state_checkpoint_every > 0:
        return tc.state_checkpoint_path
    return None


def compute_embeddings(
    params: LightGCNParams,
    graph: DeviceCOO,
    batch: TripletBatch,
    neg_item: torch.Tensor,
    cfg: Config,
    spmm: Callable = spmm_segment,
):
    """(final_user, initial_user, final_pos, initial_pos, final_neg,
    initial_neg): the reference's ``compute_embeddings`` 6-tuple contract
    (train_test.py:105-134). ``neg_item`` is (B,) or (B, K).

    When a gradient will be taken, the rows are gathered by
    ``ops/cuda_scatter.py::gather_rows`` over one stable sort of each index
    set (the users; the positives and negatives together), so their
    gradients are summed per row in an order fixed by the data, not by float
    atomics: a step is bit-reproducible on the card. Without a gradient
    (the eval step) they are plain ``index_select`` gathers."""
    users_final, items_final = propagate(
        params, graph, spmm, cfg.model.num_layers, cfg.model.readout)
    sorted_ = torch.is_grad_enabled() and (params.user_emb.requires_grad
                                           or params.item_emb.requires_grad)
    return _triplet_rows(users_final, items_final, params, batch, neg_item, sorted_)


def _triplet_rows(users_final: torch.Tensor, items_final: torch.Tensor,
                  params: LightGCNParams, batch: TripletBatch, neg_item: torch.Tensor,
                  sorted_: bool):
    """:func:`compute_embeddings`' 6-tuple from the final and initial tables:
    gathered through ``gather_rows`` over one ``sort_rows`` of each index set
    when ``sorted_``, by ``index_select`` otherwise."""
    b, d = batch.user.shape[0], params.user_emb.shape[1]
    items = torch.cat([batch.pos_item.reshape(-1), neg_item.reshape(-1)])
    if sorted_:
        u_lists = sort_rows(batch.user, params.user_emb.shape[0])
        i_lists = sort_rows(items, params.item_emb.shape[0])
        gather_u = lambda t: gather_rows(t, batch.user, *u_lists)
        gather_i = lambda t: gather_rows(t, items, *i_lists)
    else:
        gather_u = lambda t: t.index_select(0, batch.user)
        gather_i = lambda t: t.index_select(0, items)
    uf, ue = gather_u(users_final), gather_u(params.user_emb)
    itf, ite = gather_i(items_final), gather_i(params.item_emb)
    neg_shape = tuple(neg_item.shape) + (d,)
    return (uf, ue, itf[:b], ite[:b],
            itf[b:].view(neg_shape), ite[b:].view(neg_shape))


def compute_loss(
    params: LightGCNParams,
    graph: DeviceCOO,
    batch: TripletBatch,
    neg_item: torch.Tensor,
    cfg: Config,
    spmm: Callable = spmm_segment,
) -> torch.Tensor:
    """Propagate on the batch graph and evaluate the BPR loss on the (user,
    pos, neg) triplets: ``compute_embeddings`` + ``bpr_loss``
    (train_test.py:105-134, :18-51)."""
    embs = compute_embeddings(params, graph, batch, neg_item, cfg, spmm)
    loss_fn = select_bpr_loss(cfg.train.loss)
    return loss_fn(*embs, cfg.train.bpr_coeff, mask=batch.mask)


def loss_and_grads(loss_fn: Callable, params: LightGCNParams, *args
                   ) -> Tuple[torch.Tensor, LightGCNParams]:
    """``(loss, d loss / d params)`` of ``loss_fn(params, *args)`` by autograd
    (the role ``jax.value_and_grad`` plays in the JAX package)."""
    leaves = LightGCNParams(params.user_emb.detach().requires_grad_(True),
                            params.item_emb.detach().requires_grad_(True))
    with torch.enable_grad():
        loss = loss_fn(leaves, *args)
        gu, gi = torch.autograd.grad(loss, leaves)
    return loss.detach(), LightGCNParams(gu, gi)


def compute_loss_grads_microbatched(
    params: LightGCNParams,
    graph,
    batch: TripletBatch,
    neg_item: torch.Tensor,
    cfg: Config,
    spmm: Callable,
    num_micro: int,
) -> Tuple[torch.Tensor, LightGCNParams]:
    """``(loss, grads)`` of :func:`compute_loss`, with the triplet loss
    evaluated in ``num_micro`` microbatches over ONE propagation (JAX
    ``compute_loss_grads_microbatched``).

    Exact up to float reassociation: the loss is a masked mean, and the
    mask-count-weighted average of the chunks' masked means is the global
    masked mean, Σ_c w_c·(S_c/w_c) / Σ_c w_c = ΣS/Σw, for the pairwise and
    the reg term alike. The propagation runs once with autograd; each chunk
    takes the gradients of ``l·w / total_w`` with respect to the detached
    finals and the initial tables, summed into four (N, d) accumulators; one
    backward then carries the finals' cotangents through the propagation.
    A chunk's rows are gathered through ``gather_rows`` over its own
    ``sort_rows`` lists, as in :func:`compute_embeddings`, so a step is
    bit-reproducible on the card. Peak memory: one chunk's (B/num_micro, K,
    d) triplet temps and the accumulators, not the whole batch's. A
    ``num_micro`` that does not divide the batch raises ``ValueError``."""
    b = batch.user.shape[0]
    if b % num_micro:
        raise ValueError(f"loss_microbatches={num_micro} must divide the "
                         f"padded batch {b}")
    loss_fn = select_bpr_loss(cfg.train.loss)
    coeff = cfg.train.bpr_coeff
    leaves = LightGCNParams(params.user_emb.detach().requires_grad_(True),
                            params.item_emb.detach().requires_grad_(True))
    bc = b // num_micro
    with torch.enable_grad():
        finals = propagate(leaves, graph, spmm, cfg.model.num_layers, cfg.model.readout)
        uf, itf = (t.detach().requires_grad_(True) for t in finals)
        total_w = batch.mask.sum().to(torch.float32).clamp_min(1.0)
        acc = [torch.zeros_like(t) for t in (uf, itf, leaves.user_emb, leaves.item_emb)]
        lsum = torch.zeros((), dtype=torch.float32, device=total_w.device)
        for c in range(num_micro):
            sl = slice(c * bc, (c + 1) * bc)
            chunk = TripletBatch(batch.user[sl], batch.pos_item[sl], batch.mask[sl])
            embs = _triplet_rows(uf, itf, leaves, chunk, neg_item[sl], True)
            l = loss_fn(*embs, coeff, mask=chunk.mask)
            w = chunk.mask.sum().to(torch.float32)
            gs = torch.autograd.grad(l * w / total_w, (uf, itf) + tuple(leaves))
            for a, g in zip(acc, gs):
                a.add_(g)
            lsum = lsum + l.detach() * w
        torch.autograd.backward(finals, (acc[0], acc[1]))
    grads = LightGCNParams(leaves.user_emb.grad + acc[2], leaves.item_emb.grad + acc[3])
    return lsum / total_w, grads


def make_train_step(cfg: Config, spmm: Callable = spmm_rows):
    """Build ``train_step(state, graph, batch, generator, neg=None)``; ``neg``
    injects the negatives instead of drawing them. ``spmm`` defaults to
    :func:`~..ops.spmm.spmm_rows` over the row runs of
    ``pipeline.build_cluster_batches``' graphs: every sum of repeated rows,
    forward and backward, runs in an order fixed by the data, so a step is
    bit-equal from run to run on the card. :func:`~..ops.spmm.spmm_segment`
    (``index_add``) stays the plain oracle."""
    check_negatives_mode(cfg.train.negatives)
    opt = make_optimizer(cfg)

    def train_step(state: TrainState, graph: DeviceCOO, batch: TripletBatch,
                   generator: Optional[torch.Generator],
                   neg: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        if neg is None:
            neg = sample_negative(generator, batch.user.shape[0],
                                  state.params.item_emb.shape[0],
                                  cfg.train.num_negatives,
                                  device=batch.user.device)
        loss, grads = loss_and_grads(compute_loss, state.params, graph, batch,
                                     neg, cfg, spmm)
        params, opt_state = opt.update(state.params, grads, state.opt_state)
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


# ---------------------------------------------------------------------------
# Epoch loop over cluster batches (reference train(), train_test.py:66-103)
# ---------------------------------------------------------------------------


class ClusterBatch(NamedTuple):
    """One padded training subgraph: device graph + its positive pairs."""

    graph: DeviceCOO
    batch: TripletBatch
    num_edges: int          # true (unpadded) edge count: the loss weight w
                            # (train_test.py:98-101)


def train_epoch(
    state: TrainState,
    clusters: List[ClusterBatch],
    train_step,
    generator: torch.Generator,
    shuffle: bool = True,
) -> Tuple[TrainState, float]:
    """One epoch over shuffled cluster batches; returns the edge-weighted mean
    loss (train_test.py:98-103). Losses stay on the device until the epoch
    ends, so the loop never blocks on a host sync."""
    order = list(range(len(clusters)))
    if shuffle:
        order = torch.randperm(len(clusters), generator=generator,
                               device=generator.device).tolist()
    losses = []
    total_w = 0
    for i in order:
        cb = clusters[i]
        state, loss = train_step(state, cb.graph, cb.batch, generator)
        losses.append(loss * cb.num_edges)
        total_w += cb.num_edges
    total = float(torch.stack(losses).sum()) if losses else 0.0
    return state, total / max(total_w, 1)


# ---------------------------------------------------------------------------
# Whole-epoch fused trainer over stacked cluster batches
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StackedClusters:
    """Every cluster batch stacked on a leading axis of K clusters (all share
    one padded shape), JAX ``StackedClusters``: the fused epoch picks a
    step's cluster on the device by index, so no host work sits between two
    steps.

    Beside JAX's arrays it stacks the graphs' row runs
    (``DeviceCOO.from_arrays(..., row_runs=True)``) that
    :func:`~..ops.spmm.spmm_rows` sums over: ``starts`` and ``src_starts``
    (K, N + 1) and ``src_order`` (K, E_pad). ``order`` is ``arange(E_pad)``
    in every cluster (the edges are stored sorted by destination) and is
    kept once. The four are None when the graphs carry no row runs."""

    src: torch.Tensor          # (K, E_pad) int32
    dst: torch.Tensor          # (K, E_pad) int32
    w: torch.Tensor            # (K, E_pad) float32
    user: torch.Tensor         # (K, B) int32
    pos_item: torch.Tensor     # (K, B) int32
    mask: torch.Tensor         # (K, B) bool
    edge_counts: torch.Tensor  # (K,) float32 true edge counts
    num_nodes: int
    order: Optional[torch.Tensor] = None       # (E_pad,) int32
    starts: Optional[torch.Tensor] = None      # (K, N + 1) int32
    src_order: Optional[torch.Tensor] = None   # (K, E_pad) int32
    src_starts: Optional[torch.Tensor] = None  # (K, N + 1) int32

    @property
    def num_clusters(self) -> int:
        return int(self.src.shape[0])

    @staticmethod
    def from_batches(clusters: List[ClusterBatch]) -> "StackedClusters":
        shapes = {(tuple(c.graph.src.shape), tuple(c.batch.user.shape)) for c in clusters}
        if len(shapes) != 1:
            raise ValueError(f"clusters must share one padded shape, got {shapes}")
        stk = lambda f: torch.stack([f(c) for c in clusters])
        runs = {}
        if all(c.graph.starts is not None for c in clusters):
            runs = dict(order=clusters[0].graph.order,
                        starts=stk(lambda c: c.graph.starts),
                        src_order=stk(lambda c: c.graph.src_order),
                        src_starts=stk(lambda c: c.graph.src_starts))
        src = stk(lambda c: c.graph.src)
        return StackedClusters(
            src=src, dst=stk(lambda c: c.graph.dst), w=stk(lambda c: c.graph.w),
            user=stk(lambda c: c.batch.user), pos_item=stk(lambda c: c.batch.pos_item),
            mask=stk(lambda c: c.batch.mask),
            edge_counts=torch.tensor([float(c.num_edges) for c in clusters],
                                     dtype=torch.float32, device=src.device),
            num_nodes=clusters[0].graph.num_nodes, **runs)

    def cluster(self, c: torch.Tensor) -> Tuple[DeviceCOO, TripletBatch]:
        """The graph and triplets of cluster ``c``, a (1,) index tensor on the
        stack's device, picked by ``index_select`` (no host sync)."""
        pick = lambda t: None if t is None else t.index_select(0, c)[0]
        graph = DeviceCOO(pick(self.src), pick(self.dst), pick(self.w), self.num_nodes,
                          order=self.order, starts=pick(self.starts),
                          src_order=pick(self.src_order),
                          src_starts=pick(self.src_starts))
        return graph, TripletBatch(pick(self.user), pick(self.pos_item), pick(self.mask))


class _EpochSteps:
    """The fused epoch's step over static buffers: a device step counter
    ``j``, the epoch's cluster order and negatives, the learning rate and
    bias corrections of each step (a table filled on the host by
    :func:`make_lr_schedule` and :func:`bias_corrections`, since a captured
    step cannot take them as Python floats), and the edge-weighted loss sum.

    :meth:`prepare` fills the buffers for one epoch; :meth:`step` runs step
    ``j`` and advances ``j``, with no host sync; :meth:`finish` reads the
    mean loss (the epoch's one host sync) and advances the optimizer count
    and the step by K. The captured epoch replays :meth:`step`; the eager
    epoch calls it K times: the same code, so the same bits."""

    def __init__(self, cfg: Config, spmm: Callable):
        self.cfg, self.spmm = cfg, spmm
        self.lr_of = make_lr_schedule(cfg)
        self.bufs: Optional[dict] = None

    def prepare(self, state: TrainState, stacked: StackedClusters,
                perm: torch.Tensor, neg: torch.Tensor) -> None:
        k, dev = stacked.num_clusters, stacked.src.device
        tc = self.cfg.train
        b = self.bufs
        if (b is None or b["neg"].shape != neg.shape or b["perm"].shape[0] != k
                or b["j"].device != dev):
            b = self.bufs = dict(
                j=torch.zeros(1, dtype=torch.int64, device=dev),
                perm=torch.zeros(k, dtype=torch.int64, device=dev),
                neg=torch.zeros(neg.shape, dtype=torch.int32, device=dev),
                sched=torch.zeros((3, k), dtype=torch.float32, device=dev),
                wloss=torch.zeros(1, dtype=torch.float32, device=dev))
        count0 = state.opt_state.count
        sched = [[self.lr_of(count0 + j) for j in range(k)]]
        sched += [list(c) for c in zip(*(bias_corrections(count0 + j + 1, tc.adam_b1,
                                                          tc.adam_b2) for j in range(k)))]
        for dst, src in ((b["sched"], torch.tensor(sched, dtype=torch.float32)),
                         (b["perm"], perm), (b["neg"], neg)):
            dst.copy_(src)
            if dst.is_cuda and not src.is_cuda:
                count("host_sync")      # a blocking copy from the host
        b["j"].zero_()
        b["wloss"].zero_()

    def tensors(self, state: TrainState, stacked: StackedClusters) -> tuple:
        """Every tensor :meth:`step` reads or writes (a capture's key)."""
        ost = state.opt_state
        fields = (getattr(stacked, f.name) for f in dataclasses.fields(stacked))
        return (*state.params, *ost.mu, *ost.nu, *self.bufs.values(),
                *(t for t in fields if isinstance(t, torch.Tensor)))

    def step(self, state: TrainState, stacked: StackedClusters) -> None:
        tc, b = self.cfg.train, self.bufs
        j = b["j"]
        c = b["perm"].index_select(0, j)
        graph, batch = stacked.cluster(c)
        loss, grads = loss_and_grads(compute_loss, state.params, graph, batch,
                                     b["neg"].index_select(0, j)[0], self.cfg, self.spmm)
        with torch.no_grad():
            b["wloss"].add_(loss * stacked.edge_counts.index_select(0, c))
            lr, bc1, bc2 = b["sched"].index_select(1, j)
            grads = clip_by_global_norm(grads, tc.grad_clip_norm)
            ost = state.opt_state
            for p, g, mu, nu in zip(state.params, grads, ost.mu, ost.nu):
                adam_step_table_(p, g, mu, nu, lr, bc1, bc2, tc.adam_b1, tc.adam_b2,
                                 tc.adam_eps)
            j.add_(1)

    def finish(self, state: TrainState, stacked: StackedClusters
               ) -> Tuple[TrainState, float]:
        k = stacked.num_clusters
        mean_loss = float(self.bufs["wloss"][0] / stacked.edge_counts.sum().clamp_min(1.0))
        ost = state.opt_state
        return (TrainState(state.params, AdamState(ost.count + k, ost.mu, ost.nu),
                           state.step + k), mean_loss)


def _epoch_draws(cfg: Config, stacked: StackedClusters, num_items: int,
                 generator: Optional[torch.Generator], perm=None,
                 neg: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The epoch's cluster order (K,) and every step's negatives, (K, B) or
    (K, B, num_negatives), drawn from ``generator`` in that order before the
    first step (JAX splits every step's key up front); ``perm`` / ``neg``
    given are taken as they are."""
    k, b, n = stacked.num_clusters, stacked.user.shape[1], cfg.train.num_negatives
    if perm is None:
        perm = torch.randperm(k, generator=generator, device=generator.device)
    if neg is None:
        neg = sample_negative(generator, k * b, num_items, n).view(
            (k, b) if n <= 1 else (k, b, n))
    return torch.as_tensor(perm), torch.as_tensor(neg)


def _eager_epoch_fn(cfg: Config, spmm: Callable = spmm_rows):
    """:func:`make_epoch_fn`'s epoch with its K steps run one by one, on any
    device: what the CPU runs, and what the card's captured epoch is held
    against. Returns ``epoch_fn`` with the :class:`_EpochSteps` it runs as
    its ``steps`` attribute."""
    check_negatives_mode(cfg.train.negatives)
    steps = _EpochSteps(cfg, spmm)

    def epoch_fn(state: TrainState, stacked: StackedClusters,
                 generator: Optional[torch.Generator], perm=None,
                 neg: Optional[torch.Tensor] = None) -> Tuple[TrainState, float]:
        perm, neg = _epoch_draws(cfg, stacked, state.params.item_emb.shape[0],
                                 generator, perm, neg)
        steps.prepare(state, stacked, perm, neg)
        for _ in range(stacked.num_clusters):
            steps.step(state, stacked)
        return steps.finish(state, stacked)

    epoch_fn.steps = steps
    return epoch_fn


def make_epoch_fn(cfg: Config, spmm: Callable = spmm_rows):
    """Build ``epoch_fn(state, stacked, generator, perm=None, neg=None) ->
    (state, mean_loss)`` (JAX ``make_epoch_fn``): a shuffled pass over every
    cluster of a :class:`StackedClusters`, one clip + Adam step per cluster
    in place on the state, the mean loss weighted by the clusters' true edge
    counts.

    The cluster order and all K steps' negatives are drawn from
    ``generator`` at the epoch's start (:func:`_epoch_draws`); ``perm`` (K,)
    and ``neg`` (K, B) or (K, B, Kneg) inject them instead, ``neg[j]``
    belonging to step j, which trains cluster ``perm[j]``. No generator is
    read after that, so either route leaves it in the same state.

    On the card the step is captured once as a CUDA graph and replayed K
    times (``utils/capture.py::StepGraph``), recaptured when the state's or
    the stack's tensors change; a capture that fails raises. On the CPU the
    same step runs K times eagerly (:func:`_eager_epoch_fn`). Kernel
    launches inside a capture count once in ``ops/_build.py::LAUNCHES``; the
    ``graph.replay`` counter counts the replays."""
    from ..utils.capture import StepGraph, tensor_key

    eager = _eager_epoch_fn(cfg, spmm)
    steps, graph = eager.steps, StepGraph()

    def epoch_fn(state: TrainState, stacked: StackedClusters,
                 generator: Optional[torch.Generator], perm=None,
                 neg: Optional[torch.Tensor] = None) -> Tuple[TrainState, float]:
        dev = stacked.src.device
        if dev.type == "cpu":
            return eager(state, stacked, generator, perm, neg)
        if dev.type != "cuda":
            raise ValueError(f"the fused epoch runs on cuda or cpu tensors, got {dev}")
        with trace_span("train.epoch"):
            with trace_span("train.draws"):
                perm, neg = _epoch_draws(cfg, stacked, state.params.item_emb.shape[0],
                                         generator, perm, neg)
            with trace_span("train.prepare"):
                steps.prepare(state, stacked, perm, neg)
            with torch.cuda.device(dev):
                graph.run(lambda: steps.step(state, stacked),
                          tensor_key(*steps.tensors(state, stacked)), stacked.num_clusters)
            with trace_span("train.wait", wait=True):
                out = steps.finish(state, stacked)
                count("host_sync")
        return out

    return epoch_fn


# ---------------------------------------------------------------------------
# Evaluation (reference evaluate(), train_test.py:136-163)
# ---------------------------------------------------------------------------


def make_eval_step(cfg: Config, spmm: Callable = spmm_rows):
    """The val/test evaluation: loss and sampled recall. ``spmm`` defaults to
    :func:`~..ops.spmm.spmm_rows` (over :func:`build_eval_batch`'s graphs),
    so that an evaluation of the same tables gives the same bits on the card."""

    @torch.no_grad()
    def eval_step(params: LightGCNParams, graph: DeviceCOO, batch: TripletBatch,
                  generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        num_items = params.item_emb.shape[0]
        neg = sample_negative(generator, batch.user.shape[0], num_items,
                              device=batch.user.device)
        loss = compute_loss(params, graph, batch, neg, cfg, spmm)
        # parity recall on initial embeddings (train_test.py:157-159)
        recall = sampled_recall_at_k(
            generator,
            params.user_emb[batch.user],
            params.item_emb[batch.pos_item],
            params.item_emb[neg],
            k=cfg.train.eval_top_k,
            num_samples=cfg.train.recall_num_samples,
            sample_size=cfg.train.recall_sample_size,
        )
        return loss, recall

    return eval_step


def build_eval_batch(edge_index: np.ndarray, num_nodes: int, num_users: int,
                     device: DeviceLike = None) -> Tuple[DeviceCOO, TripletBatch]:
    """Eval graphs propagate over their own edge set (train_test.py:150-153),
    with the row runs :func:`~..ops.spmm.spmm_rows` sums over."""
    dev = resolve_device(device)
    g = DeviceCOO.from_host(COOGraph.build(edge_index, num_nodes), dev, row_runs=True)
    b = triplets_from_edges(edge_index, num_users, device=dev)
    return g, b


# ---------------------------------------------------------------------------
# Multi-epoch loop (reference train_model(), train_test.py:214-256)
# ---------------------------------------------------------------------------


def _callback_takes_state(cb: Callable) -> bool:
    """True if ``cb`` can accept a third positional arg (the live TrainState).

    Keeps the ``(epoch, metrics)`` callback contract intact: metrics stays a
    pure Dict[str, float]; callers that want mid-run state opt in by declaring
    a third parameter.
    """
    try:
        params = list(inspect.signature(cb).parameters.values())
    except (TypeError, ValueError):
        return False
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    has_varargs = any(p.kind == p.VAR_POSITIONAL for p in params)
    return has_varargs or len(positional) >= 3


def epoch_generator(cfg: Config, epoch: int, device: torch.device) -> torch.Generator:
    """The generator of one epoch (its cluster order, negatives and eval
    draws), seeded from ``(cfg.train.seed, epoch)`` alone, so a run resumed at
    ``start_epoch`` draws what the uninterrupted run would have drawn."""
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.train.seed + 1) * 1_000_003 + epoch)
    return gen


def train_model(
    cfg: Config,
    state: TrainState,
    clusters,
    val: Tuple[DeviceCOO, TripletBatch],
    test: Tuple[DeviceCOO, TripletBatch],
    spmm: Callable = spmm_rows,
    on_epoch_end: Optional[Callable] = None,  # (epoch, metrics[, state]) -> None
    save_checkpoint: Optional[Callable[[TrainState, float], None]] = None,
    metrics_logger=None,
    start_epoch: int = 0,
    best_recall: float = 0.0,
    state_meta: Optional[dict] = None,
) -> Tuple[TrainState, Dict[str, List[float]]]:
    """Train for ``cfg.train.epochs`` epochs with a val eval after each, keep
    the best-val checkpoint through ``save_checkpoint``, finish with a test
    eval. ``clusters`` is a :class:`~.compact.CompactClusters` (compact
    trainer), a :class:`~.fullgraph.FullGraphTrainData` (full-graph trainer)
    or a list of :class:`ClusterBatch` (full-node trainer: the fused epoch,
    :func:`make_epoch_fn`, when they share one padded shape, else the
    per-cluster loop, as JAX's ``train_model`` chooses). ``spmm`` is the
    full-node trainer's propagation (:func:`~..ops.spmm.spmm_rows` over the
    clusters' row runs by default); the evaluations sum through
    :func:`~..ops.spmm.spmm_rows` over ``val``/``test`` from
    :func:`build_eval_batch`, bit-equal from run to run on the card.
    ``start_epoch``/``best_recall`` continue an interrupted run: each epoch's
    generator is seeded from ``(seed, epoch)`` alone, so with the full state
    of the epoch before, the resumed run is bit-equal to the uninterrupted
    one (``training/recovery.py``). Every ``state_checkpoint_every`` epochs
    the full state goes to :func:`state_checkpoint_path` with meta
    ``{"epoch": epoch, **state_meta}``. The compact trainer's ``lazy_adam``,
    ``hybrid_adam`` and ``lazy_item_adam`` start fresh lazy moments when
    ``state`` carries Adam's."""
    from .checkpoint import save_train_state
    from .compact import (LAZY_OPTIMIZERS, CompactClusters, LazyAdamState,
                          init_lazy_adam, make_compact_epoch_fn)
    from .fullgraph import FullGraphTrainData, make_fullgraph_epoch_fn

    state_path = state_checkpoint_path(cfg)
    eval_step = make_eval_step(cfg)
    device = state.params.user_emb.device

    if isinstance(clusters, FullGraphTrainData):
        epoch_fn = make_fullgraph_epoch_fn(cfg, clusters)
    elif isinstance(clusters, CompactClusters):
        epoch_fn = make_compact_epoch_fn(cfg)
        if (cfg.train.optimizer in LAZY_OPTIMIZERS
                and not isinstance(state.opt_state, LazyAdamState)):
            state = TrainState(state.params, init_lazy_adam(state.params), state.step)
    else:
        # cluster batches of one padded shape: the fused epoch (captured on
        # the card); otherwise the per-cluster loop
        try:
            clusters = StackedClusters.from_batches(clusters)
            epoch_fn = make_epoch_fn(cfg, spmm)
        except ValueError:
            train_step = make_train_step(cfg, spmm)
            epoch_fn = lambda st, cl, gen: train_epoch(st, cl, train_step, gen)

    hist: Dict[str, List[float]] = {"train_loss": [], "val_loss": [], "val_recall": [],
                                    "epoch_time_s": []}
    for epoch in range(start_epoch, cfg.train.epochs):
        gen = epoch_generator(cfg, epoch, device)
        t0 = time.perf_counter()
        state, train_loss = epoch_fn(state, clusters, gen)
        val_loss, val_recall = eval_step(state.params, val[0], val[1], gen)
        val_loss, val_recall = float(val_loss), float(val_recall)
        dt = time.perf_counter() - t0
        hist["train_loss"].append(train_loss)
        hist["val_loss"].append(val_loss)
        hist["val_recall"].append(val_recall)
        hist["epoch_time_s"].append(dt)
        print(
            f"Epoch: {epoch:03d}, Train Loss: {train_loss:.4f}, "
            f"Val Loss: {val_loss:.4f}, Recall@k: {val_recall:.6f}, "
            f"k={cfg.train.eval_top_k} ({dt:.2f}s)"
        )
        if metrics_logger is not None:
            metrics_logger.log(epoch, train_loss=train_loss, val_loss=val_loss,
                               val_recall=val_recall, epoch_time_s=dt)
        if state_path and (epoch + 1) % cfg.train.state_checkpoint_every == 0:
            save_train_state(state_path, state, meta={"epoch": epoch, **(state_meta or {})},
                             schedule_count=cfg.train.lr_schedule == "cosine")
        if val_recall > best_recall:
            best_recall = val_recall
            if save_checkpoint is not None:
                save_checkpoint(state, val_recall)
        if on_epoch_end is not None:
            m = {k: v[-1] for k, v in hist.items()}
            if _callback_takes_state(on_epoch_end):
                on_epoch_end(epoch, m, state)  # live state for mid-run eval
            else:
                on_epoch_end(epoch, m)

    gen = epoch_generator(cfg, cfg.train.epochs, device)
    test_loss, test_recall = eval_step(state.params, test[0], test[1], gen)
    print(f"Test Loss: {float(test_loss):.4f}, Recall@k: {float(test_recall):.6f}, "
          f"k={cfg.train.eval_top_k}")
    hist["test_loss"] = [float(test_loss)]
    hist["test_recall"] = [float(test_recall)]
    return state, hist


def save_histories(hist: Dict[str, List[float]], histories_dir: str) -> None:
    """Persist training curves as .npy, mirroring train_test.py:289-291."""
    os.makedirs(histories_dir, exist_ok=True)
    np.save(os.path.join(histories_dir, "hist_train_loss.npy"), np.asarray(hist["train_loss"]))
    np.save(os.path.join(histories_dir, "hist_val_loss.npy"), np.asarray(hist["val_loss"]))
    np.save(os.path.join(histories_dir, "hist_val_recall.npy"), np.asarray(hist["val_recall"]))
