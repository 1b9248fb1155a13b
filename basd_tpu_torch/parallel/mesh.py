"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
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

Tensor parallelism over ``tpu.mesh.model`` (``mesh.py:48-74``): the grid is
``world = data x model``, rank ``r = d * model + m`` (``make_mesh``'s
``devices.reshape(data, model)``). The ranks of one ``d`` form a model
group (``ModelParallel``), those of one ``m`` a data group
(``DataParallel``, the meaning above). Where the JAX package shards the
qkv / fc1 kernels on their output dim and proj / fc2 on their input dim
and lets GSPMD insert the collectives, the port computes Megatron's form
of the same function in every ViT block half (``models.layers.Block``):
``copy_in`` (identity forward, sum of the gradients backward), the rank's
heads or hidden units (column-parallel qkv / fc1), a partial row-parallel
proj / fc2 in f32 without bias, ``reduce`` (the sum forward, identity
backward), then bias, mask and residual once. Heads and hidden units are
split as evenly as they go (``split_range``: 3 heads over 2 ranks are
2 + 1; a rank may hold none). Everything else (embeddings, norms, biases,
the head, the CNN teachers, the selector) is replicated in a model group,
whose ranks compute it identically; the loss's sums stay on the data group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

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
    owned: bool = False  # init_mesh created the process group

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
        """``t`` of the group's rank ``src`` on every rank of the group."""
        if self.group is not None:
            if self.group is not dist.group.WORLD:
                src = dist.get_global_rank(self.group, src)
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
        """Destroy the process group if ``init_mesh`` made it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False


def split_range(total: int, world: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous share ``[start, stop)`` of ``total`` units
    over ``world`` ranks, as even as it goes: the first ``total % world``
    ranks take one more (3 over 2: 2 + 1; 3 over 4: 1, 1, 1, 0)."""
    base, extra = divmod(total, world)
    start = rank * base + min(rank, extra)
    return start, start + base + (1 if rank < extra else 0)


class _Reduce(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward, the identity
    backward (every rank holds the whole cotangent of the sum)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum of the ranks' gradients
    backward, in f32 and rounded to x's dtype once."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce_(g.float().clone()).to(g.dtype), None


class _Share(torch.autograd.Function):
    """The zero share of a rank without heads or hidden units: zeros of
    ``shape`` in f32 that still depend on ``x``, so that the rank's
    ``copy_in`` takes part in the backward's sum."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.like = (x.shape, x.dtype)
        return torch.zeros(shape, dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.like
        return torch.zeros(shape, dtype=dtype, device=g.device), None


@dataclass
class ModelParallel:
    """The ranks of one model group: ``rank`` of ``world``. ``group`` None
    computes one rank's share alone (every collective the identity), as
    the tests do to add the shares of all ranks in one process."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the model group (g)."""
        if self.group is None:
            return x
        return _Reduce.apply(x, self)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """The identity whose backward sums the ranks' gradients (f)."""
        if self.group is None:
            return x
        return _CopyIn.apply(x, self)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the model group, outside autograd."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def zero_share(self, x: torch.Tensor, shape) -> torch.Tensor:
        return _Share.apply(x, tuple(shape))

    def heads(self, num_heads: int) -> tuple[int, int]:
        """This rank's heads ``[start, stop)`` of ``num_heads``."""
        return split_range(num_heads, self.world, self.rank)

    def hidden(self, hidden: int) -> tuple[int, int]:
        """This rank's MLP hidden units ``[start, stop)`` of ``hidden``."""
        return split_range(hidden, self.world, self.rank)


def check_shards(world: int, dim: int, num_heads: int, hidden: int) -> None:
    """Refuse a split of a block of width ``dim``, ``num_heads`` heads and
    ``hidden`` MLP units over ``world`` ranks whose shards break TMA's
    16-byte rule: a rank's proj shard (D, h E) and fc2 shard (D, F) rows
    must be a multiple of 8 bf16 elements long (``gemm_sm90.cuh``)."""
    e = dim // num_heads
    for r in range(world):
        h0, h1 = split_range(num_heads, world, r)
        f0, f1 = split_range(hidden, world, r)
        for what, width in (("proj", (h1 - h0) * e), ("fc2", f1 - f0)):
            if width % 8:
                raise ValueError(
                    f"tpu.mesh.model={world}: rank {r}'s {what} shard "
                    f"({dim}, {width}) of a block of D={dim}, {num_heads} "
                    f"heads of {e}, {hidden} MLP units has a row of {width} "
                    f"elements, not a multiple of 8 (TMA's 16-byte rows)")


def init_mesh(mesh_cfg, device: torch.device
              ) -> tuple[DataParallel, Optional[ModelParallel]]:
    """The data group and the model group (None for ``model: 1``) of this
    rank of the ``tpu.mesh`` grid.

    The world is that of an initialised default process group, else
    ``WORLD_SIZE`` (set by ``torchrun``), else 1. ``data: -1`` means
    ``world / model``; a grid larger than the world, or a ``data`` other
    than ``world / model``, is refused. One process without a group trains
    alone; otherwise the default group is used, initialised here from the
    ``torchrun`` environment when the caller has not done so (NCCL for a
    CUDA device, gloo for the CPU). With ``model > 1`` every rank creates
    every data group and every model group, in the same order; a data group
    of one rank is the one-process ``DataParallel()``."""
    get = mesh_cfg.get if mesh_cfg is not None else (lambda k, d=None: d)
    data, model = int(get("data", -1)), int(get("model", 1))
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if model < 1 or model > world:
        raise ValueError(
            f"tpu.mesh.model={model} exceeds the world of {world} "
            f"process(es): launch with torchrun --nproc_per_node="
            f"{max(model, 1)} or more")
    if data == -1:
        data = world // model
    if data * model > world:
        raise ValueError(
            f"tpu.mesh.data={data} x tpu.mesh.model={model} exceeds the "
            f"world of {world} process(es)")
    if data * model != world:
        raise ValueError(
            f"tpu.mesh.data={data} but the world has {world} process(es) "
            f"and tpu.mesh.model={model}: launch with torchrun "
            f"--nproc_per_node={data * model}, or set tpu.mesh.data=-1 "
            f"(world / model)")
    owned = False
    if not (dist.is_available() and dist.is_initialized()):
        if world == 1:
            return DataParallel(), None
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
        owned = True
    rank = dist.get_rank()
    if model == 1:
        return DataParallel(rank, world, dist.group.WORLD, owned=owned), None
    d, m = divmod(rank, model)
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    dp = (DataParallel(d, data, data_groups[m], owned=owned) if data > 1
          else DataParallel(owned=owned))
    return dp, ModelParallel(m, model, model_groups[d])



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
