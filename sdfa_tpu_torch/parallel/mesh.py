"""The data-parallel mesh of the port (counterpart of
``sdfa_tpu/parallel/mesh.py``): one process per card, the parameters
replicated, the batch split over the ranks.

The JAX step is one SPMD program over the global batch: BatchNorm
statistics, the dropout draw, the loss means and the gradient are all global,
and its result does not depend on the device count. Here each rank runs the
step on its own rows, and what the global batch needs crosses ranks:

- **Rows.** A training batch is doubled: its first half is frame i of each
  pair, its second half frame i + 1 (``data/sliding_window.py::collate``), and
  the motion loss subtracts the halves. Rank r of W holds rows [r·b, (r+1)·b)
  of *each half*, b = pairs / W (``shard_rows``), so every rank keeps whole
  pairs and the mean of the ranks' loss means is the global mean. A contiguous
  split would give one rank the frames i and another the frames i + 1.
- **Random draws.** A rank draws a mask or noise for the global batch from the
  step's generator, seeded alike on every rank, and keeps its rows
  (``draw_rows``): the draw equals a one-process draw on the global batch.
- **Sums.** ``all_reduce_sum`` is autograd-aware: BatchNorm's Σx, Σx² and
  count go through it, and the gradient of the global statistics reaches every
  rank's inputs. ``average_gradients`` is one flat all-reduce after backward.
- **Control.** Values that steer the loop (a loader's end, a validation
  metric) are reduced on a host (gloo) group, so that every rank takes the
  same decision without a device round trip.

``batch_sharding`` and ``replicated`` of the JAX module return ``NamedSharding``
objects, which have no counterpart: a rank holds its rows and the whole
parameters by construction.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """World size, this process's rank and device, the process group (None:
    the default group) and a host group for control values (None: no
    collectives, one process)."""
    world: int
    rank: int
    device: torch.device
    group: Any = None
    host_group: Any = None

    @property
    def parallel(self) -> bool:
        return self.world > 1


def rank_device(device=None) -> torch.device:
    """The rank's device: what the caller passes, ``cuda:{LOCAL_RANK}`` for a
    bare ``cuda`` (or none) under a launcher, else ``cuda``."""
    local = os.environ.get("LOCAL_RANK")
    if device is None or (torch.device(device).type == "cuda"
                          and torch.device(device).index is None):
        return torch.device("cuda" if local is None else f"cuda:{int(local)}")
    return torch.device(device)


def make_mesh(device=None) -> Mesh:
    """The mesh over every process of the default group (one process without
    a group). In a group, the rank's card becomes its current device, as
    NCCL needs."""
    device = rank_device(device)
    if not dist.is_initialized():
        return Mesh(1, 0, device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if dist.get_world_size() == 1:
        return Mesh(1, 0, device)
    host = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return Mesh(dist.get_world_size(), dist.get_rank(), device, None, host)


def shard_rows(x, world: int, rank: int):
    """Rank ``rank``'s rows of a doubled batch (numpy array or tensor,
    leading axis): rows [r·h, (r+1)·h) of each half, h = rows / (2·world)."""
    if world == 1:
        return x
    n = x.shape[0]
    if n % (2 * world):
        raise ValueError(f"{n} rows are not pairs that split over {world} ranks")
    h, half = n // (2 * world), n // 2
    lo = rank * h
    first, second = x[lo:lo + h], x[half + lo:half + lo + h]
    return torch.cat([first, second]) if torch.is_tensor(x) else np.concatenate([first, second])


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (``shard_rows`` of every entry)."""
    return {k: shard_rows(v, mesh.world, mesh.rank) for k, v in batch.items()}


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int],
              mesh: Optional[Mesh]) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows: one process draws ``shape``; rank
    r of W draws the global shape (W times the leading axis) and keeps its
    rows. The leading axis must be sample-major: a batch-first tensor, or one
    reshaped from (N, ...) to (N·k, ...)."""
    if mesh is None or not mesh.parallel:
        return draw(shape)
    full = draw((shape[0] * mesh.world,) + tuple(shape[1:]))
    return shard_rows(full, mesh.world, mesh.rank)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0."""
    if mesh.parallel:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0, group=mesh.group)
    return module


def pad_batch_to_devices(batch, n_devices: int):
    """Pad the leading axis to a multiple of the device count by repeating
    the last row; returns (padded batch, real size). Dicts, lists and tuples
    of arrays, as the JAX function's pytrees."""
    leaves: List[np.ndarray] = []

    def walk(x, fn):
        if isinstance(x, dict):
            return {k: walk(v, fn) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, fn) for v in x)
        return fn(x)

    walk(batch, leaves.append)
    sizes = {x.shape[0] for x in leaves}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch dims: {sizes}")
    n = sizes.pop()
    rem = n % n_devices
    if rem == 0:
        return batch, n
    pad = n_devices - rem
    return walk(batch, lambda x: np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])), n


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the incoming gradients over ranks:
    each rank's loss depends on every rank's share of the sum."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The autograd-aware sum over ranks (``torch.distributed.nn``'s
    ``all_reduce``, which newer releases deprecate, in ten lines)."""
    return _AllReduceSum.apply(tensor, mesh.group)


def mean_over_ranks(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over ranks of a detached tensor, the same bits on every rank."""
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    return out.div_(mesh.world)


def average_gradients(grads: List[torch.Tensor], mesh: Mesh):
    """Every gradient replaced by its mean over ranks, in place: one flat
    all-reduce of all of them."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def host_mean(values: Dict[str, float], mesh: Mesh) -> Dict[str, float]:
    """The mean over ranks of host numbers (every rank passes the same keys),
    reduced on the host group in float64."""
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(t, group=mesh.host_group)
    return dict(zip(keys, (t / mesh.world).tolist()))


def all_ranks_agree(flag: bool, mesh: Mesh) -> bool:
    """The flag, which every rank must hold alike: raises on every rank if
    they differ (loaders out of step would otherwise block a collective)."""
    t = torch.tensor([int(flag), -int(flag)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.host_group)
    lo, hi = int(t[0]), -int(t[1])
    if lo != hi:
        raise RuntimeError(f"ranks disagree ({flag} on rank {mesh.rank}): their loaders are "
                           "out of step")
    return bool(lo)


def barrier(mesh: Mesh):
    if mesh.parallel:
        dist.barrier(group=mesh.host_group)
