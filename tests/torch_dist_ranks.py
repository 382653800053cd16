"""Rank functions of the port's multi-rank tests, and the helper that starts
them: gloo processes on the CPU, started by ``torch.multiprocessing`` with the
``spawn`` method.

This module imports torch, numpy and the port, never JAX, so a child starts in
a few seconds. The test writes the inputs to an ``.npz``; every rank reads
them, runs the port on its part of the mesh, and rank 0 writes its results to
another ``.npz`` that the test holds against the JAX package. A rank that
finds something wrong raises, which fails the spawn.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from movie_recommender_system_with_gnns_tpu_torch.config import (
    Config, ModelConfig, TrainConfig)
from movie_recommender_system_with_gnns_tpu_torch.models.lightgcn import params_from_numpy
from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import TripletBatch
from movie_recommender_system_with_gnns_tpu_torch.parallel import mesh as pmesh
from movie_recommender_system_with_gnns_tpu_torch.parallel import sharding as sh
from movie_recommender_system_with_gnns_tpu_torch.training.train import (
    AdamState, Optimizer, TrainState, make_adam)

#: the mesh shapes the 4-rank spawns run, one after another
SHAPES = ((2, 2), (4, 1), (1, 4))


def spawn(fn: Callable, world: int, tmp_path, inputs: Dict[str, np.ndarray],
          deadline_s: float = 90.0) -> Dict[str, np.ndarray]:
    """Run ``fn(rank, inputs) -> dict`` in ``world`` gloo ranks and return
    rank 0's dict. Past ``deadline_s`` the children are killed and the call
    raises ``TimeoutError``; a rank that raises fails it with its
    traceback."""
    store, inp, out = (str(tmp_path / n) for n in ("store", "in.npz", "out.npz"))
    np.savez(inp, **inputs)
    ctx = mp.start_processes(_entry, args=(fn, world, store, inp, out), nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() >= end:
                raise TimeoutError(f"{fn.__name__}: {world} ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _entry(rank: int, fn: Callable, world: int, store: str, inp: str, out: str) -> None:
    torch.set_num_threads(1)
    pmesh.distributed_init("cpu", init_method=f"file://{store}", world_size=world,
                           rank=rank, timeout_s=60)
    with np.load(inp) as z:
        inputs = {k: z[k] for k in z.files}
    result = fn(rank, inputs)
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank == 0:
        np.savez(out, **result)


def grouped(rank: int, inputs) -> Dict[str, np.ndarray]:
    """The rank functions named in ``inputs["groups"]``, in that order, each
    on its own inputs (keys ``name__key``), in one spawn; their outputs
    come back under the same prefixes. A function that ends the group
    (:func:`solo_group`) goes last."""
    out = {}
    for name in inputs["groups"].tolist():
        sub = {k[len(name) + 2:]: v for k, v in inputs.items() if k.startswith(name + "__")}
        out.update({f"{name}__{k}": v for k, v in globals()[name](rank, sub).items()})
    return out


def solo_group() -> None:
    """End the spawn's group; rank 0 goes on alone in a one-rank group (a
    1×1 mesh). The other ranks return."""
    dist.destroy_process_group()
    pmesh.distributed_init("cpu")


def cfg_of(inputs, **train) -> Config:
    return Config(model=ModelConfig(num_layers=int(inputs["layers"]), dim=int(inputs["dim"])),
                  train=TrainConfig(lr=1e-2, **train))


def sgd(lr: float) -> Optimizer:
    """``optax.sgd(lr)`` on the local shards: the step's clipped gradient is
    ``params_before - params_after``."""
    def update(params, grads, opt_state):
        for p, g in zip(params, grads):
            p.sub_(g, alpha=lr)
        return params, opt_state

    return Optimizer(lambda params: AdamState(0, None, None), update)


def _one_step(cfg, mesh, plan, graph, u, i, batch, neg, opt=None):
    """One sharded step from the UNPADDED tables ``(u, i)``: (loss, the new
    unpadded tables)."""
    m = mesh.coords[1]
    local = sh.shard_params(sh.pad_params(params_from_numpy(u, i, "cpu"), plan), plan, m)
    opt_ = opt or make_adam(cfg, lr_of=lambda t: cfg.train.lr)
    step = sh.make_sharded_train_step(cfg, mesh, plan, opt=opt_)
    state = TrainState(local, opt_.init(local), 0)
    state, loss = step(state, sh.shard_coos(graph, plan, m, "cpu"), batch, neg)
    full = sh.unpad_params(sh.gather_params(state.params, mesh), plan)
    # the padded rows stay exactly zero
    for t, true_rows, loc in ((state.params.user_emb, plan.num_users, plan.u_loc),
                              (state.params.item_emb, plan.num_items, plan.i_loc)):
        lo = m * loc
        start = max(true_rows - lo, 0)
        if start < loc and torch.count_nonzero(t[start:]).item():
            raise AssertionError("a padded table row moved")
    return float(loss), full


def sharded_steps(rank: int, inputs) -> Dict[str, np.ndarray]:
    """On each of :data:`SHAPES`: one Adam step (reference loss, one
    negative), and one unclipped-SGD step per loss with three negatives;
    plus the collectives' backward, the mismatched-mesh error and the
    hybrid step's."""
    e, u, i = inputs["edges"], inputs["u"], inputs["i"]
    nu, ni = u.shape[0], i.shape[0]
    batch = TripletBatch(*(torch.from_numpy(inputs[k]) for k in ("user", "pos", "mask")))
    out = {}
    for dp, mpar in SHAPES:
        mesh = pmesh.make_mesh(dp, mpar, device="cpu")
        plan = sh.ShardPlan.create(nu, ni, mpar)
        graph = sh.shard_graph(e, plan)
        tag = f"{dp}x{mpar}"
        loss, p = _one_step(cfg_of(inputs), mesh, plan, graph, u, i, batch,
                            torch.from_numpy(inputs["neg"]))
        out[f"{tag}_loss"], out[f"{tag}_u"], out[f"{tag}_i"] = loss, p.user_emb, p.item_emb
        for lname in ("reference", "standard"):
            cfg = cfg_of(inputs, loss=lname, num_negatives=3)
            loss, p = _one_step(cfg, mesh, plan, graph, inputs["u3"], inputs["i3"], batch,
                                torch.from_numpy(inputs["neg3"]), opt=sgd(1.0))
            out[f"{tag}_sgd_{lname}_loss"] = loss
            out[f"{tag}_sgd_{lname}_gu"] = inputs["u3"] - p.user_emb.numpy()
            out[f"{tag}_sgd_{lname}_gi"] = inputs["i3"] - p.item_emb.numpy()
    # the collectives' backward: d/dx of Σ_ranks <c_r, all_gather(x)> is the
    # sum over ranks of each rank's cotangent rows; psum's the sum of all
    world = dist.get_world_size()
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    c = torch.arange(world * 6, dtype=torch.float32).view(world * 2, 3) * (rank + 1)
    (g,) = torch.autograd.grad((pmesh.all_gather_rows(x, None) * c).sum(), x)
    ranks_sum = sum(range(1, world + 1))
    want = torch.arange(world * 6, dtype=torch.float32).view(world * 2, 3)[2 * rank:2 * rank + 2]
    if not torch.equal(g, want * ranks_sum):
        raise AssertionError(f"all_gather_rows backward {g} != {want * ranks_sum}")
    y = torch.tensor(float(rank + 1), requires_grad=True)
    (gy,) = torch.autograd.grad(pmesh.psum(y, None) * (rank + 1), y)
    if float(pmesh.psum(y.detach(), None)) != ranks_sum or float(gy) != ranks_sum:
        raise AssertionError("psum or its backward is wrong")
    try:
        pmesh.make_mesh(3, 1, device="cpu")
    except ValueError as err:
        out["mismatch_error"] = str(err)
    try:
        sh.make_sharded_train_step(cfg_of(inputs), mesh, plan, opt=None, hybrid=True)
    except NotImplementedError as err:
        out["hybrid_error"] = str(err)
    return {k: np.asarray(v) for k, v in out.items()}


def mesh_tables(rank: int, inputs) -> Dict[str, np.ndarray]:
    """On a 2×2 mesh: the propagated serving tables, the full-ranking eval
    (layer-0 and propagated) with the catalog over all ranks, and the
    sharded MIPS against ``mips_topk`` on one rank."""
    from movie_recommender_system_with_gnns_tpu_torch.ops.topk import mips_topk
    from movie_recommender_system_with_gnns_tpu_torch.serving.recommend import (
        compute_serving_tables)
    from movie_recommender_system_with_gnns_tpu_torch.training.evaluate import (
        evaluate_full_ranking)

    mesh = pmesh.make_mesh(2, 2, device="cpu")
    cfg = cfg_of(inputs, spmm_chunks=2)
    params = params_from_numpy(inputs["u"], inputs["i"], "cpu")
    t = compute_serving_tables(params, inputs["edges"], cfg, mode="propagated", mesh=mesh)
    out = dict(tab_u=t.user_emb.numpy(), tab_i=t.item_emb.numpy())
    nu = params.user_emb.shape[0]
    for prop in (False, True):
        r, n = evaluate_full_ranking(params, inputs["train_e"], inputs["test_e"], nu, k=10,
                                     batch_users=64, use_propagated=prop, cfg=cfg,
                                     mesh=mesh)
        out[f"eval_{int(prop)}"] = np.asarray([r, n])
        if not evaluate_full_ranking.last_timings["sharded"]:
            raise AssertionError("the mesh eval did not report itself sharded")
    q, c = torch.from_numpy(inputs["q"]), torch.from_numpy(inputs["c"])
    s, ix = sh.make_sharded_mips(mesh, k=8, block=64)(q, c)
    s_l, i_l = mips_topk(q, c, k=8, block=64)
    out.update(mips_s=s.numpy(), mips_i=ix.numpy(), mips_s_local=s_l.numpy(),
               mips_i_local=i_l.numpy())
    try:
        evaluate_full_ranking(params, inputs["train_e"], inputs["test_e"], nu, k=200,
                              mesh=mesh)
    except ValueError as err:
        out["eval_k_error"] = str(err)
    return out


def train_runs(rank: int, inputs) -> Dict[str, np.ndarray]:
    """``train_model_sharded`` for 2 epochs of minibatch steps, each shard's
    edges in two chunks (JAX's milestone-3 knobs), on 2×2 and 4×1, then on
    1×1 (rank 0 alone): histories, the returned tables, and who saved and
    logged."""
    from movie_recommender_system_with_gnns_tpu_torch.training.distributed import (
        train_model_sharded)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import build_eval_batch
    from movie_recommender_system_with_gnns_tpu_torch.utils.observability import (
        MetricsLogger)

    nu, ni = int(inputs["nu"]), int(inputs["ni"])
    n = nu + ni
    cfg = cfg_of(inputs, epochs=2, recall_sample_size=16, recall_num_samples=2,
                 eval_top_k=10, batch_size=int(inputs["batch_size"]) or None,
                 spmm_chunks=2)
    val = build_eval_batch(inputs["val_e"], n, nu, "cpu")
    test = build_eval_batch(inputs["test_e"], n, nu, "cpu")
    out = {}
    for shape in ((2, 2), (4, 1), (1, 1)):
        if shape == (1, 1):
            solo_group()
            if rank:
                return {}
        mesh = pmesh.make_mesh(*shape, device="cpu")
        tag = f"{shape[0]}x{shape[1]}"
        saved = []
        log_path = os.path.join(str(inputs["dir"]), f"metrics_{tag}.jsonl")
        params, hist = train_model_sharded(
            cfg, nu, ni, inputs["train_e"], val, test, mesh=mesh,
            save_checkpoint=lambda p, r: saved.append(r),
            metrics_logger=MetricsLogger(log_path))
        if rank and saved:
            raise AssertionError(f"rank {rank} saved a checkpoint")
        out[f"{tag}_saved"] = len(saved)
        if rank == 0:
            out[f"{tag}_rows"] = len(MetricsLogger.read(log_path))
        for k, v in hist.items():
            if k != "epoch_time_s":
                out[f"{tag}_{k}"] = np.asarray(v)
        out[f"{tag}_u"] = params.user_emb.numpy()
    return out


def compact_supersteps(rank: int, inputs) -> Dict[str, np.ndarray]:
    """The data-parallel compact epoch on 4×1 from injected permutation and
    negatives, through the plain loss and through the fused BPR route, for
    each cluster set of ``inputs["sets"]``; the ``num_clusters % dp``
    error; then on 1×1 the fused epoch against the single-device compact
    epoch, ``torch.equal``."""
    from movie_recommender_system_with_gnns_tpu_torch.training import compact as tc
    from movie_recommender_system_with_gnns_tpu_torch.training.compact_sharded import (
        make_compact_sharded_epoch_fn)
    from movie_recommender_system_with_gnns_tpu_torch.training.train import make_optimizer

    nu = int(inputs["nu"])

    def fresh(cfg):
        p = params_from_numpy(inputs["u"], inputs["i"], "cpu")
        return TrainState(p, make_optimizer(cfg).init(p), 0)

    mesh = pmesh.make_mesh(4, 1, device="cpu")
    out, sets = {}, {}
    for tag in inputs["sets"].tolist():
        parts = [inputs[f"{tag}_part{j}"] for j in range(int(inputs[f"{tag}_parts"]))]
        cc = tc.build_compact_clusters(parts, nu, align=8, device="cpu")
        perm, neg = inputs[f"{tag}_perm"].tolist(), torch.from_numpy(inputs[f"{tag}_neg"])
        sets[tag] = (parts, cc, perm, neg)
        for route, fused in (("plain", False), ("fused", True)):
            cfg = cfg_of(inputs, fused_bpr=fused)
            state, loss = make_compact_sharded_epoch_fn(cfg, mesh)(cc)(
                fresh(cfg), cc, None, perm=perm, neg=neg)
            out.update({f"{tag}_{route}_loss": loss, f"{tag}_{route}_step": state.step,
                        f"{tag}_{route}_u": state.params.user_emb.numpy(),
                        f"{tag}_{route}_i": state.params.item_emb.numpy(),
                        f"{tag}_{route}_mu_u": state.opt_state.mu.user_emb.numpy(),
                        f"{tag}_{route}_mu_i": state.opt_state.mu.item_emb.numpy()})
    parts, cc, perm, neg = sets[tag]
    odd = tc.build_compact_clusters(parts[:-1], nu, align=8, device="cpu")
    try:
        make_compact_sharded_epoch_fn(cfg, mesh)(odd)
    except ValueError as err:
        out["divide_error"] = str(err)
    solo_group()
    if rank:
        return {}
    one = pmesh.make_mesh(1, 1, device="cpu")
    a, la = make_compact_sharded_epoch_fn(cfg, one)(cc)(fresh(cfg), cc, None, perm=perm,
                                                        neg=neg)
    b, lb = tc.make_compact_epoch_fn(cfg)(fresh(cfg), cc, None, perm=perm, neg=neg)
    same = [torch.equal(x, y) for x, y in zip(a.params + a.opt_state.mu + a.opt_state.nu,
                                              b.params + b.opt_state.mu + b.opt_state.nu)]
    out["solo_equal"] = np.asarray(same + [la == lb, a.step == b.step])
    return {k: np.asarray(v) for k, v in out.items()}
