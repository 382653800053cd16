"""Measured row-op roofline for the port's training epochs (JAX package
``utils/roofline.py``).

The epochs are bound by row-granular operations (gathers, sorted row sums,
sorts, table sweeps) whose cost is per row, not per byte. This module

  1. measures the rates of the primitives the port's epochs are built from,
     on the card, by differential timing: two repeat counts of one body,
     each captured as one CUDA graph and replayed, so the marginal cost is
     the work's and not the launches' (:func:`measure_rowop_rates`);
  2. counts the epoch's row ops, sweep bytes, dense FLOPs and the fused BPR
     kernel's bytes from its static shapes;
  3. adds them into a sequential floor, ``floor_s = Σ component costs``,
     every primitive at its measured rate and nothing overlapped.

``rowop_util = floor_s / measured_epoch_s`` is then the utilization of a
row-op-bound program. The counts mirror the port's epochs, not XLA's: where
the port does the JAX package's work the formula is JAX's; where it does
other work (the BPR kernel's real row gathers in place of one-hot products,
the hybrid optimizer's per-step user writes, the ELL kernel's bytes over
its work list in place of a gather per edge of the chunked ELL) the count is
the port's own.

The published peaks of the cards (:data:`PEAKS`) are here too, so a kernel's
bound and an epoch's floor read one table.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .capture import StepGraph
from .device import DeviceLike, resolve_device

#: published dense peaks (bytes/s, bf16 FLOP/s), NVIDIA data sheets
PEAKS = {
    "H100 SXM": (3.35e12, 989e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
}
#: published f32 rate outside the tensor cores (FLOP/s), NVIDIA data sheet
F32_FLOPS = 67e12
#: published dense TF32 tensor-core rate (FLOP/s), NVIDIA data sheet
TF32_FLOPS = 495e12


def peaks_for(name: str) -> Tuple[float, float]:
    """``(bytes/s, bf16 FLOP/s)`` of the card called ``name`` (its
    ``torch.cuda.get_device_name`` or ``nvidia-smi`` name); an H100 SXM part
    when the name says no other."""
    for key in ("H200", "NVL", "PCIe"):
        if key in name:
            return PEAKS["H200" if key == "H200" else f"H100 {key}"]
    return PEAKS["H100 SXM"]


def device_peaks(name: Optional[str] = None) -> Tuple[str, float, float]:
    """``(device_kind, peak_flops, peak_hbm_bps)`` in ``bench.py``'s order:
    of ``name``, or of CUDA device 0 when None."""
    kind = torch.cuda.get_device_name(0) if name is None else name
    bw, flops = peaks_for(kind)
    return kind, flops, bw


class RowOpRates(NamedTuple):
    gather_ns_row: float      # gather_rows of d-wide f32 rows, summed into a carry
    segment_ns_row: float     # sorted_index_add row into a dense (rows, d) table
    sort_ns_row: float        # sort_rows (stable sort + row starts) per key
    sweep_gbps: float         # one fused Adam pass over a table, 7 arrays' bytes


def _best_seconds(f: Callable, args, device: torch.device, clock: Callable) -> float:
    """The least of 3 timed runs of ``f(*args)`` after one warm-up. On CUDA
    the runs are replays of one CUDA graph that captured ``f(*args)``, timed
    by CUDA events; a capture that fails raises. On the CPU a plain call
    timed by ``clock``."""
    if device.type == "cuda":
        step = StepGraph()
        with torch.cuda.device(device):    # warm-up, capture, one replay
            step.run(lambda: f(*args), None, 2)
        best = float("inf")
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            step.graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        return best
    f(*args)
    best = float("inf")
    for _ in range(3):
        t0 = clock()
        f(*args)
        best = min(best, clock() - t0)
    return best


def _diff_time(make_fn: Callable[[int], Callable], args, r1: int = 50, r2: int = 300,
               device: DeviceLike = "cuda", clock: Callable[[], float] = time.perf_counter
               ) -> float:
    """Marginal seconds per iteration between ``make_fn(r1)`` and
    ``make_fn(r2)``, functions that run their body that many times:
    ``max((best(r2) - best(r1)) / (r2 - r1), 1e-9)``, ``best`` the least of 3
    timed runs after a warm-up (:func:`_best_seconds`). The fixed cost of a
    run cancels; so does a launch's, because on CUDA each run is one replay
    of a captured graph (an eager loop would pay a launch per iteration,
    about the time of the work itself at these sizes). ``clock`` times the
    CPU runs."""
    dev = torch.device(device)
    f1, f2 = make_fn(r1), make_fn(r2)
    return max((_best_seconds(f2, args, dev, clock)
                - _best_seconds(f1, args, dev, clock)) / (r2 - r1), 1e-9)


def _repeat(body: Callable) -> Callable[[int], Callable]:
    """``make(rep)``: a function of ``(x, *args)`` that runs ``x = body(x,
    *args)`` ``rep`` times (JAX's ``fori_loop`` body)."""
    def make(rep: int) -> Callable:
        def f(x, *args):
            for _ in range(rep):
                x = body(x, *args)
            return x
        return f
    return make


@torch.no_grad()
def measure_rowop_rates(num_rows: int = 59_047, d: int = 64, batch: int = 30_336,
                        device: DeviceLike = "cuda") -> RowOpRates:
    """The rates of the port's epoch primitives on ``device`` (the card unless
    the caller asks for the CPU, as the tests do):

      * gather: ``ops/cuda_scatter.py::gather_rows`` of ``batch`` rows of a
        ``(num_rows, d)`` f32 table, the indices shifted by the carry so that
        no two iterations read the same rows, the rows summed into it;
      * segment: ``sorted_index_add`` of ``batch`` rows into a ``(num_rows,
        d)`` table over the lists of their random ids (the rows read in
        sorted order, as the step's negatives' rows are), added to the
        carry; the order and the row starts built once, outside the loop;
      * sort: ``sort_rows`` of ``batch`` int keys below ``num_rows``;
      * sweep: one fused, in-place Adam pass (:func:`_adam_pass`) over a
        ``(num_rows, d)`` table, its gradient and its two moments, charged
        JAX's ``7 · num_rows · d · 4`` bytes (4 reads, 3 writes). JAX times
        the same sweep fused by XLA. It is the rate the card gives an Adam
        sweep, not the rate of the port's own optimizer
        (:func:`optimizer_sweep_gbps`), so a floor priced with it does not
        move when the optimizer is made faster.

    At the main path's shapes the item table is 15.1 MB (59,047 × 64 f32),
    which fits in an H100's 50 MB L2: the gather rate is an L2 rate, as it is
    in the real epoch. The sweep's arrays (106 MB) do not fit."""
    from ..ops.cuda_scatter import gather_rows, sort_rows, sorted_index_add

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(num_rows, d, device=dev, generator=gen)
    rows = torch.randint(0, num_rows, (batch,), device=dev, generator=gen,
                         dtype=torch.int32)
    vals = torch.randn(batch, d, device=dev, generator=gen)
    order, starts = sort_rows(rows, num_rows)
    zero = torch.zeros((), device=dev)

    def gather(x, t, r):
        idx = torch.remainder(r + x.to(torch.int32), num_rows)
        return x + gather_rows(t, idx, order, starts).sum()
    t_gather = _diff_time(_repeat(gather), (zero, table, rows), device=dev)

    def seg(t, v):
        return t + sorted_index_add(v, order, starts, num_rows)
    t_seg = _diff_time(_repeat(seg), (table, vals), device=dev)

    def srt(x, r):
        o, s = sort_rows(torch.remainder(r + x.to(torch.int32), num_rows), num_rows)
        return x + o[0].float() * 1e-9 + s[1].float() * 1e-9
    t_sort = _diff_time(_repeat(srt), (zero, rows), device=dev)

    arrays = [table.clone(), torch.randn(num_rows, d, device=dev, generator=gen),
              torch.zeros_like(table), torch.zeros_like(table)]
    step = torch.ones((), device=dev)
    t_sweep = _diff_time(_repeat(_adam_pass), (zero, *arrays, step), device=dev)
    sweep_bytes = 7 * num_rows * d * 4

    return RowOpRates(gather_ns_row=t_gather / batch * 1e9,
                      segment_ns_row=t_seg / batch * 1e9,
                      sort_ns_row=t_sort / batch * 1e9,
                      sweep_gbps=sweep_bytes / t_sweep / 1e9)


def _adam_pass(x, p, g, m, v, step):
    """One fused Adam update of ``p`` and its moments ``m``, ``v`` from ``g``,
    in place: one launch that reads the four arrays once and writes three
    (``torch._fused_adam_``, the fused kernel of ``torch.optim.Adam``; a
    yardstick only, the port's optimizer does not call it). Returns the
    carry ``x``."""
    torch._fused_adam_([p], [g], [m], [v], [], [step], lr=1e-3, beta1=0.9,
                       beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                       maximize=False)
    return x


@torch.no_grad()
def optimizer_sweep_gbps(num_rows: int = 59_047, d: int = 64,
                         device: DeviceLike = "cuda") -> float:
    """The rate, in GB/s of JAX's ``7 · num_rows · d · 4`` bytes, of the
    port's own Adam update (``training/train.py::make_optimizer``: the
    global-norm clip and Adam, in place, in several launches) over a
    ``(num_rows, d)`` table and its two moments, timed as
    :func:`measure_rowop_rates` times its sweep. Reported beside
    ``RowOpRates.sweep_gbps``; no floor is priced with it."""
    from ..config import Config
    from ..models.lightgcn import LightGCNParams
    from ..training.train import make_optimizer

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    opt = make_optimizer(Config())
    table = torch.randn(num_rows, d, device=dev, generator=gen)
    params = LightGCNParams(table, table.new_zeros(0, d))
    grads = (torch.randn(num_rows, d, device=dev, generator=gen), table.new_zeros(0, d))

    def sweep(st, p, g):
        return opt.update(p, g, st)[1]
    t = _diff_time(_repeat(sweep), (opt.init(params), params, grads), device=dev)
    return 7 * num_rows * d * 4 / t / 1e9


def bpr_tile_bytes(*, b: int, d: int, valid: int, users_named: int, items_named: int,
                   neg_only: int, u_rows: int, i_rows: int) -> int:
    """The bytes one ``bpr_tile`` call must move (kernel B1): a masked triplet
    costs its ``m`` entry and its zero ``gni`` row, a valid one its four
    other indices and its negative's initial row; of the ``[propagated ‖
    initial]`` tables (``u_rows`` and ``i_rows`` rows of 2·d f32) only the
    rows a valid triplet names are read (``users_named`` users,
    ``items_named`` positives, and ``neg_only`` items named only as an
    in-cluster negative, which give their propagated half alone); ``gni``,
    both gradient tables and the loss are written once in full."""
    read = (4 * b + 16 * valid + valid * d * 4 + 8
            + (users_named + items_named) * 2 * d * 4 + neg_only * d * 4)
    write = b * d * 4 + (u_rows + i_rows) * 2 * d * 4 + 4
    return read + write


def bpr_tile_counts(u_tab, i_tab, ni, ul, pl, loc, inc, m) -> Dict[str, int]:
    """:func:`bpr_tile_bytes`' keywords counted from one call's inputs (the
    arguments of ``ops/cuda_bpr.py::bpr_tile``, any device)."""
    b, d = ni.shape
    v = m != 0
    pos = torch.unique(pl[v])
    neg = torch.unique(loc[v & (inc != 0)])
    return dict(b=b, d=d, valid=int(v.sum()), users_named=int(torch.unique(ul[v]).numel()),
                items_named=int(pos.numel()), neg_only=int((~torch.isin(neg, pos)).sum()),
                u_rows=u_tab.shape[0], i_rows=i_tab.shape[0])


def bpr_tile_flops(*, d: int, valid: int) -> float:
    """About 30·d f32 operations per valid triplet of a ``bpr_tile`` call."""
    return 30.0 * d * valid


def compact_epoch_floor(
    *,
    num_users: int,
    num_items: int,
    d: int,
    num_layers: int,
    num_clusters: int,
    u_pad: int,
    i_pad: int,
    b_pad: int,
    rates: RowOpRates,
    peak_flops: float,
    peak_hbm_bps: float,
    optimizer: str = "hybrid_adam",
) -> Dict[str, float]:
    """Sequential floor (seconds) for one compact epoch, by component.

    Counts mirror ``training/compact.py::make_compact_epoch_fn`` (Adam) and
    ``make_compact_hybrid_epoch_fn`` (``hybrid_adam``) on the dense path,
    one step per cluster. JAX's formulas where the port does JAX's work: the
    dense propagation's FLOPs (forward and symmetric backward) at
    ``peak_flops``, the row ops per step, the dense sweeps. Departures:

      * ``floor_bpr_s``: the fused BPR kernel (B1) gathers real rows, so it
        is charged its compulsory bytes (:func:`bpr_tile_bytes`) over
        ``peak_hbm_bps``, counted from the shapes: ``b_pad`` triplets, all
        valid, every row of both tables named. JAX charges its one-hot MXU
        FLOPs, a TPU workaround the port does not copy;
      * ``floor_epoch_fixed_s`` under ``hybrid_adam``: the port writes the
        step's user rows (table and both moments) at every step, ``3 ·
        u_pad`` row writes at the gather rate, where JAX writes them back
        once an epoch.
    """
    n_local = u_pad + i_pad
    steps = num_clusters

    prop_flops = 2 * num_layers * 2.0 * n_local * n_local * d  # fwd + sym bwd
    t_mxu = steps * prop_flops / peak_flops

    bpr_bytes = bpr_tile_bytes(b=b_pad, d=d, valid=b_pad, users_named=u_pad,
                               items_named=i_pad, neg_only=0, u_rows=u_pad, i_rows=i_pad)
    t_bpr = steps * bpr_bytes / peak_hbm_bps

    # row ops per step
    gather_rows = b_pad * 3 + i_pad + 3 * u_pad
    segment_rows = b_pad                          # the negatives' gradient rows
    sort_rows = b_pad
    t_rows = steps * (gather_rows * rates.gather_ns_row
                      + segment_rows * rates.segment_ns_row
                      + sort_rows * rates.sort_ns_row) * 1e-9

    # dense sweeps per step: item adam (7 arrays) + grad-norm read (1)
    item_bytes = num_items * d * 4
    sweep_bytes = steps * 8 * item_bytes
    if optimizer == "adam":
        # dense user adam + user grad zeros/densify/norm sweeps as well
        user_bytes = num_users * d * 4
        sweep_bytes += steps * 10 * user_bytes
    t_sweep = sweep_bytes / (rates.sweep_gbps * 1e9)

    # hybrid: the step's user rows written in place (table, mu, nu)
    t_epoch = 0.0
    if optimizer == "hybrid_adam":
        t_epoch = steps * 3 * u_pad * rates.gather_ns_row * 1e-9

    floor = t_mxu + t_bpr + t_rows + t_sweep + t_epoch
    return {
        "floor_s": floor,
        "floor_mxu_s": t_mxu,
        "floor_bpr_s": t_bpr,
        "floor_rowop_s": t_rows,
        "floor_sweep_s": t_sweep,
        "floor_epoch_fixed_s": t_epoch,
    }


def ell_rows_written(schedule) -> int:
    """The rows the ELL kernel's work list (``ops/cuda_spmm.py::ell_schedule``)
    writes in one hop: each run's rows, and one scratch row for each segment
    of a split row. The counterpart of the chunk rows JAX's chunked-ELL
    segment sum writes (``ell_chunks``)."""
    runs = schedule.items[schedule.items[:, 0] >= 0]
    return int((runs[:, 2] - runs[:, 1]).sum()) + schedule.num_segments


def sharded_epoch_floor(
    *,
    n_pad: int,
    d: int,
    num_layers: int,
    steps: int,
    batch: int,
    e_off_directed: int,
    ell_chunks: int,
    blk_k: int,
    blk_p: int,
    rates: RowOpRates,
    peak_flops: float,
    peak_hbm_gbps: float,
    num_devices: int = 1,
    ici_gbps: float = 0.0,
) -> Dict[str, float]:
    """Sequential floor for one fused sharded hybrid epoch.

    Counts mirror ``parallel/sharding.py::make_sharded_epoch_fn`` with the
    hybrid layer and the symmetric VJP: per step the layer runs
    ``2·num_layers`` times (the backward is the same layer), each
    application paying

      * 2 all-gathers (users, items) and 2 ``reduce_scatter_rows``: one
        ``n_pad·d·4``-byte table each way, a copy on one card, a transfer of
        ``(D−1)/D`` of it across ``num_devices`` over ``ici_gbps``;
      * the ELL kernel (B4) over the rank's rectangular remainder, charged
        its compulsory bytes over ``peak_hbm_gbps``: the id and weight of
        each of the ``e_off_directed`` edges (8 bytes), the ``n_pad``-row
        table read once and the ``ell_chunks`` rows its work list writes
        (:func:`ell_rows_written`: row runs and split rows' segments, the
        counterpart of JAX's chunk rows) written once. JAX charges each edge
        a row gather at the gather rate; B4 gathers far faster than a
        ``gather_rows`` of a triplet batch, so that count is no floor for
        the port;
      * the bf16 block products: ``blk_k·blk_p`` row gathers, the
        (K, P, P)×(K, P, d) product at ``peak_flops``, the bf16 block read,
        and the combine by an ``n_pad``-row gather;

    and the loss and Adam tail per step: 4 table gathers and their
    transposes (about 8 table copies), about 3·2 wide triplet row ops over
    ``batch``, one ``batch``-row sort for the scatter transpose, and the
    7-array Adam sweep of both tables. JAX's keys, and its formulas but for
    the remainder's."""
    apps = 2 * num_layers * steps
    table_bytes = n_pad * d * 4

    if num_devices > 1 and ici_gbps > 0:
        t_coll = apps * 2 * table_bytes * (num_devices - 1) / num_devices / (
            ici_gbps * 1e9)
    else:
        t_coll = apps * 2 * 2 * table_bytes / (peak_hbm_gbps * 1e9)

    t_ell = apps * (8 * e_off_directed + (n_pad + ell_chunks) * d * 4) / (
        peak_hbm_gbps * 1e9)

    blk_flops = 2.0 * blk_k * blk_p * blk_p * d
    blk_bytes = blk_k * blk_p * blk_p * 2    # bf16 adjacency read
    t_blk = apps * (blk_k * blk_p * rates.gather_ns_row * 1e-9
                    + blk_flops / peak_flops
                    + blk_bytes / (peak_hbm_gbps * 1e9)
                    + n_pad * rates.gather_ns_row * 1e-9)  # permute combine

    t_loss = steps * (
        8 * 2 * table_bytes / (peak_hbm_gbps * 1e9)   # 4 gathers + transposes
        + 6 * batch * rates.gather_ns_row * 1e-9      # triplet row ops
        + batch * rates.sort_ns_row * 1e-9            # scatter transpose
        + 7 * 2 * table_bytes / (rates.sweep_gbps * 1e9))  # Adam (both tables)

    floor = t_coll + t_ell + t_blk + t_loss
    return {
        "sharded_floor_s": floor,
        "sharded_floor_collective_s": t_coll,
        "sharded_floor_ell_s": t_ell,
        "sharded_floor_block_s": t_blk,
        "sharded_floor_loss_s": t_loss,
    }
