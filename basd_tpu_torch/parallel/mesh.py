"""Data parallelism over ``torch.distributed`` (counterpart of
``basd_tpu/parallel/mesh.py``).

The JAX package shards the batch over the mesh's ``data`` axis and lets
GSPMD insert the cross-device sums, so an N-device step computes the
one-device step of the whole (global) batch, with MixUp rolled within each
shard. The port reproduces that math by hand, with two collectives only,
``all_reduce`` (sum) and ``broadcast``, each called in the same order on
every rank:

- every rank draws the global batch's random draws from an identically
  seeded generator and keeps its own rows ``[r*B/N, (r+1)*B/N)``;
- the loss's batch statistics (the selector's token sums and centred
  Grams, the CE and geo means) are summed over the ranks by ``sum``, which
  autograd differentiates as the sum it is (its backward is again an
  all-reduce), so every rank holds the same global loss;
- each rank differentiates that replicated loss, so the sum of the ranks'
  gradients is N times the global gradient: the trainer all-reduces the
  gradients as one flat buffer and divides by N.

``DataParallel()`` with no group is the one-process case: every collective
is the identity and no call reaches ``torch.distributed``. With a group,
even of one rank, every collective runs.

Tensor parallelism over ``tpu.mesh.model`` (``mesh.py:48-74``) is not
ported; ``init_data_parallel`` refuses ``model > 1``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

_MODEL_AXIS = (
    "tpu.mesh.model > 1 (tensor parallelism, basd_tpu/parallel/mesh.py:48-74) "
    "is not ported: ROADMAP.md, section 1, 'tensor parallelism over "
    "tpu.mesh.model'"
)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its adjoint is the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclass
class DataParallel:
    """The ranks of one data-parallel group: ``rank`` of ``world``, or the
    one-process case (``group`` None)."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None
    owned: bool = False  # init_data_parallel created the process group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum of ``x`` over the ranks."""
        if self.group is None:
            return x
        return _AllReduceSum.apply(x, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean from each rank's mean over its equal shard."""
        if self.group is None:
            return x
        return self.sum(x / self.world)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order,
        differentiable: an all-reduce of zero-padded copies, exact."""
        if self.group is None:
            return x
        parts = [torch.zeros_like(x)] * self.world
        parts[self.rank] = x
        return self.sum(torch.cat(parts, dim))

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks, outside autograd."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.group is not None:
            dist.broadcast(t, src=src, group=self.group)
        return t

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch that ``world`` divides."""
        per = batch // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Destroy the process group if ``init_data_parallel`` made it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False


def init_data_parallel(mesh_cfg, device: torch.device) -> DataParallel:
    """The data-parallel group that ``tpu.mesh`` asks for.

    ``data: -1`` means the world size: that of an initialised default
    process group, else ``WORLD_SIZE`` (set by ``torchrun``), else 1. Any
    other value must equal it. One process without a group trains alone;
    otherwise the default group is used, initialised here from the
    ``torchrun`` environment when the caller has not done so (NCCL for a
    CUDA device, gloo for the CPU)."""
    get = mesh_cfg.get if mesh_cfg is not None else (lambda k, d=None: d)
    data, model = int(get("data", -1)), int(get("model", 1))
    if model != 1:
        raise NotImplementedError(_MODEL_AXIS)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if data == -1:
        data = world
    if data != world:
        raise ValueError(
            f"tpu.mesh.data={data} but the world has {world} process(es): "
            f"launch with torchrun --nproc_per_node={data}, or set "
            f"tpu.mesh.data=-1")
    if dist.is_available() and dist.is_initialized():
        return DataParallel(dist.get_rank(), world, dist.group.WORLD)
    if world == 1:
        return DataParallel()
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return DataParallel(dist.get_rank(), world, dist.group.WORLD, owned=True)


def shard_batch(dp: DataParallel, batch: dict, *,
                allow_pad: bool = True) -> dict:
    """This rank's rows of a host numpy batch (``mesh.py:77-105``).

    The batch is padded to a multiple of the world size, padded rows
    labelled -1 (and zero images) so that every metric masks them.
    ``allow_pad=False``, the train path, refuses padding instead: padded
    rows are masked in the metrics but not in the distillation loss, whose
    selector Grams, Procrustes panels and CE they would bias."""
    b = next(iter(batch.values())).shape[0]
    pad = (-b) % dp.world
    if pad and not allow_pad:
        raise ValueError(
            f"train batch of {b} rows is not divisible by the data axis "
            f"({dp.world}): padded rows would silently bias distillation "
            f"gradients. Pick data.batch_size as a multiple of "
            f"tpu.mesh.data (train loading always uses drop_last).")
    rows = dp.rows(b + pad)
    out = {}
    for k, v in batch.items():
        if pad:
            fill = np.full((pad,) + v.shape[1:], -1 if v.ndim == 1 else 0,
                           v.dtype)
            v = np.concatenate([v, fill], axis=0)
        out[k] = v[rows]
    return out
