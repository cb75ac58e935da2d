"""The collectives of tensor parallelism, for autograd (Megatron's f and g).

The transformer's modules hold their shards of the column- and
row-split projections (parallel/tp.py) and meet the model group through
three functions, each the identity at one process (a model world without
a group):

- `copy_to_model`: identity forward, all-reduce backward. A tensor that
  is whole and alike on every rank (a replicated activation, or a
  replicated weight) entering rank-local work: each rank's gradient of it
  is only the part its own shard produced, and the backward sums them.
- `reduce_from_model`: all-reduce forward, identity backward. The partial
  sums of a row-split projection become the whole output; its gradient is
  alike on every rank already.
- `gather_from_model`: all-gather forward, reduce-scatter backward. A
  column-split output made whole on every rank (the GPM's query) feeds
  products with each rank's own value shard, so each rank's gradient of
  the whole is a partial sum: the backward sums the ranks' gradients and
  then keeps the rank's slice. A backward that only sliced would train
  wrong without an error. The gathered tensor must therefore feed
  rank-local work only (work whose gradient is a partial sum), never a
  path whose gradient is already alike on every rank.

Without grad (inference) each is one plain collective, or nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.parallel.dist import Ranges, World


def _needs_graph(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x: torch.Tensor, world: World) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(out, group=world.group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.world), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        return _all_reduce(x, world)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, ranges, whole, dim):
        ctx.args = (world, ranges, dim)
        return dist.all_gather(x, world, ranges, whole, dim)

    @staticmethod
    def backward(ctx, grad):
        world, ranges, dim = ctx.args
        return dist.reduce_scatter(grad, world, ranges, dim), None, None, \
            None, None


def copy_to_model(x: torch.Tensor, world: World) -> torch.Tensor:
    """x, whose gradient is summed over the model group."""
    if world.group is None or not _needs_graph(x):
        return x
    return _CopyToModel.apply(x, world)


def reduce_from_model(x: torch.Tensor, world: World) -> torch.Tensor:
    """The sum of the ranks' partial x. Without grad the sum is taken in
    x's own storage when x is contiguous (x is a temporary)."""
    if world.group is None:
        return x
    if _needs_graph(x):
        return _ReduceFromModel.apply(x, world)
    x = x.contiguous()
    tdist.all_reduce(x, group=world.group)
    return x


def gather_from_model(x: torch.Tensor, world: World, ranges: Ranges,
                      whole: int, dim: int = -1) -> torch.Tensor:
    """The whole tensor (`whole` wide along `dim`) of which x holds this
    rank's `ranges`."""
    if world.group is None:
        return x
    if _needs_graph(x):
        return _GatherFromModel.apply(x, world, tuple(ranges), whole, dim)
    return dist.all_gather(x, world, ranges, whole, dim)


def scatter_to_model(x: torch.Tensor, world: World, ranges: Ranges,
                     dim: int = -1) -> torch.Tensor:
    """This rank's `ranges` of x, a tensor alike on every rank (its
    gradient is gathered: the sum of the ranks' zero-padded ones)."""
    if world.group is None:
        return x
    return dist.take(copy_to_model(x, world), ranges, dim)
