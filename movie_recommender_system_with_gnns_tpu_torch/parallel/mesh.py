"""Process groups for multi-device training (JAX package ``parallel/mesh.py``).

JAX lays its devices out as a named 2-D mesh, ``data`` × ``model``, and
``shard_map`` runs one program per device with collectives over an axis. Here
each rank of a ``torch.distributed`` job is one device: :func:`make_mesh`
places rank ``r`` at ``(r // mp, r % mp)``, JAX's row-major
``devices.reshape(dp, mp)``, and gives it two process groups: ``model`` (the
ranks of its row: one data shard, the tables' rows split among them) and
``data`` (the ranks of its column: the same table rows, the batch split among
them). NCCL carries the collectives on the card, gloo on the CPU.

Autograd does not differentiate ``torch.distributed`` calls, so the
collectives inside a differentiated function are ``autograd.Function``s with
their transposes written out (JAX's ``shard_map`` derives them):
:func:`all_gather_rows` (backward: reduce-scatter, summed) and :func:`psum`
(backward: the same sum of the cotangents). ``COLLECTIVES`` counts the calls
by name.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

#: seconds a collective may wait for the other ranks before it raises
TIMEOUT_S = 600
#: collective calls by name: ``all_gather``, ``reduce_scatter``, ``all_reduce``
COLLECTIVES: collections.Counter = collections.Counter()

# the names of newer releases, where the older ones warn that they are deprecated
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def distributed_init(device: DeviceLike = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.

    The group comes from ``init_method`` with ``world_size`` and ``rank``
    when given, else from a launcher's environment (``torchrun`` sets
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``), else it is a one-rank group in this process over an
    in-memory store. A group already initialised is kept. The backend is
    NCCL for a CUDA device, gloo for the CPU; on the card the rank takes
    ``cuda:LOCAL_RANK`` (when ``device`` names no index) and makes it
    current. ``timeout_s`` bounds every collective, so a rank that dies
    cannot hang the others forever."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = timedelta(seconds=timeout_s)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timeout)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=timeout)
    return dev


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``dp × mp`` mesh and its process groups.

    ``model_group``: the ranks with this rank's data coordinate (they split
    the tables' rows); ``data_group``: the ranks with its model coordinate
    (they split the batch)."""

    dp: int
    mp: int
    rank: int
    model_group: object
    data_group: object
    device: torch.device

    @property
    def coords(self) -> Tuple[int, int]:
        """``(d, m)``: ``rank = d * mp + m``."""
        return divmod(self.rank, self.mp)

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(data_parallel: Optional[int] = None, model_parallel: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the default group
    (initialised by :func:`distributed_init` on ``device`` if it is not).
    A missing knob takes what the world size leaves; neither given is
    ``(n, 1)``, as JAX's. Every rank creates every group, in one fixed
    order, as ``new_group`` requires."""
    dev = distributed_init(device)
    n, rank = dist.get_world_size(), dist.get_rank()
    if data_parallel is None and model_parallel is None:
        data_parallel, model_parallel = n, 1
    elif data_parallel is None:
        data_parallel = n // model_parallel
    elif model_parallel is None:
        model_parallel = n // data_parallel
    dp, mp = int(data_parallel), int(model_parallel)
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    model_groups = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
    data_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
    d, m = divmod(rank, mp)
    # a group's communicator (and NCCL's device buffers) is made at its first
    # collective: make this rank's three now, not in an eval late in a run
    probe = torch.zeros(1, device=dev)
    for group in (model_groups[d], data_groups[m], None):
        dist.all_reduce(probe, group=group)
    return Mesh(dp, mp, rank, model_groups[d], data_groups[m], dev)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad an array along ``axis`` so its size divides evenly over a mesh axis."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, 0
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths), pad


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (not differentiated)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return x


def gather_rows_of(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` stacked along dim 0 in rank order (not
    differentiated)."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows_of(x, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        _reduce_scatter(out, g.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        COLLECTIVES["reduce_scatter"] += 1
        return out, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``all_gather(x, axis, axis=0, tiled=True)``: the group's row
    blocks in rank order. Its backward reduce-scatters the cotangent (each
    rank gets the sum over the group of the cotangents of its rows)."""
    return _AllGatherRows.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``psum``: ``x`` summed over the group, on every rank. Its
    backward sums the ranks' cotangents the same way."""
    return _Psum.apply(x, group)
