"""The process group of data-parallel training, and its collectives.

Counterpart of the JAX CLI's `jax.distributed.initialize()` with
`process_index` / `process_count` (rmem_ocu_tpu/tools/train.py:121-146,
222-240). One port process stands for one JAX host with one device: it
trains on `cuda:LOCAL_RANK`, its rank and the world size come from
torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`), and the group talks NCCL on the card and
gloo on the CPU.

Every function takes the `World` explicitly. The default `World()` is one
process with no group, and its collectives do nothing. A world with a
group runs them even at size 1, so that one card exercises the path that N
cards run. The collectives are `all_reduce` and `broadcast` only, which
gloo supports on CUDA tensors too: one code path serves NCCL, gloo on the
CPU and gloo on CUDA tensors. An all-gather is an all-reduce of a
zero-filled buffer into which each rank writes its part (x + 0 is exact,
so every rank ends with the same bits), and a reduce-scatter an
all-reduce followed by the rank's part.

A world of D x M ranks (tensor parallelism, the JAX package's
('data', 'model') mesh) also holds a data group and a model group: rank r
is (data index r // M, model index r % M), so that the M ranks of one
model group are adjacent and share a host's cards. `World.data` and
`World.model` are the two subgroups as worlds of their own.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')


@dataclass(frozen=True)
class World:
    """rank of size processes; `device` is this process's device; `group`
    is None for one process without a process group. `tp` is the size M of
    the model groups (1: data parallelism only), `data_group` and
    `model_group` this rank's subgroups when tp > 1."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device('cpu')
    group: Optional[dist.ProcessGroup] = None
    tp: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data(self) -> 'World':
        """The data-parallel group of this rank: the ranks of the same
        model index (the world itself without tensor parallelism)."""
        if self.tp == 1:
            return self
        return World(rank=self.rank // self.tp, size=self.size // self.tp,
                     device=self.device, group=self.data_group)

    @property
    def model(self) -> 'World':
        """The model group of this rank: the M ranks that hold the shards
        of one model (one process without a group when tp is 1)."""
        if self.tp == 1:
            return World(device=self.device)
        return World(rank=self.rank % self.tp, size=self.tp,
                     device=self.device, group=self.model_group)


def torchrun_line(n: int, module: str, mesh: Optional[str] = None) -> str:
    """The launch line of `module` over n cards of one host, data-parallel
    (`--mesh n`) unless another `mesh` is given."""
    return (f'torchrun --nproc_per_node {n} -m {module} --multihost '
            f'--mesh {mesh or n} ...')


def env_rank_and_size():
    """(RANK, WORLD_SIZE, LOCAL_RANK) from torchrun's environment, or
    (0, 1, 0) outside it."""
    return tuple(int(os.environ.get(k, d)) for k, d in
                 (('RANK', '0'), ('WORLD_SIZE', '1'), ('LOCAL_RANK', '0')))


def init_from_env(device: Optional[str] = None,
                  backend: Optional[str] = None,
                  timeout_s: float = 600.0, tp: int = 1) -> World:
    """Form the process group from torchrun's environment and return this
    process's World. `device=None` takes `cuda:LOCAL_RANK` (and raises
    without a card); 'cpu' trains on the CPU. The backend is NCCL on the
    card and gloo on the CPU unless given. With tp > 1 the world is
    WORLD_SIZE / tp data ranks of tp model ranks, with its subgroups.
    Raises when the environment lacks a variable, tp does not divide the
    world, or the group does not form within `timeout_s`."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f'no process group: {", ".join(missing)} unset; launch with '
            f'torchrun (or set RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR '
            f'and MASTER_PORT)')
    rank, size, local = env_rank_and_size()
    if tp < 1 or size % tp:
        raise ValueError(f'a model group of {tp} does not divide the world '
                         f'of {size} processes')
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'rmem_ocu_tpu_torch runs on a CUDA device by default and '
                'none is available; pass device="cpu" to run on the CPU')
        dev = torch.device('cuda', local)
    else:
        dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    dist.init_process_group(
        backend, init_method='env://', rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s))
    if tp == 1:
        return World(rank=rank, size=size, device=dev,
                     group=dist.group.WORLD)
    # every rank creates every subgroup, in the same order
    groups = {}
    for d in range(size // tp):
        ranks = [d * tp + m for m in range(tp)]
        groups['model', d] = dist.new_group(ranks)
    for m in range(tp):
        ranks = [d * tp + m for d in range(size // tp)]
        groups['data', m] = dist.new_group(ranks)
    return World(rank=rank, size=size, device=dev, group=dist.group.WORLD,
                 tp=tp, data_group=groups['data', rank % tp],
                 model_group=groups['model', rank // tp])


def destroy(world: World) -> None:
    if world.group is not None:
        dist.destroy_process_group()


def _coalesced(tensors: Iterable[torch.Tensor], collective) -> None:
    """Run `collective` in place on a flat buffer per dtype of the
    tensors and copy the result back (a lone contiguous tensor is its own
    buffer)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        if len(ts) == 1 and ts[0].is_contiguous():
            collective(ts[0])
            continue
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_reduce_(tensors: Iterable[torch.Tensor], world: World,
                mean: bool = False) -> None:
    """Sum (or average) each tensor over the ranks, in place, with one
    all-reduce of a flat buffer per dtype."""
    if world.group is None:
        return

    def reduce(flat):
        dist.all_reduce(flat, group=world.group)
        if mean:
            flat /= world.size
    _coalesced(tensors, reduce)


def broadcast_(tensors: Iterable[torch.Tensor], world: World,
               src: int = 0) -> None:
    """Each tensor set to rank src's, in place, one broadcast of a flat
    buffer per dtype."""
    if world.group is None:
        return
    # src is a rank of the world, which may be a subgroup
    src = dist.get_global_rank(world.group, src)
    _coalesced(tensors, lambda flat: dist.broadcast(flat, src,
                                                    group=world.group))


Ranges = Sequence[Tuple[int, int]]


def take(x: torch.Tensor, ranges: Ranges, dim: int = -1) -> torch.Tensor:
    """The (start, length) ranges of x along `dim`, concatenated in order
    (a view for one range)."""
    if len(ranges) == 1:
        return x.narrow(dim, *ranges[0])
    return torch.cat([x.narrow(dim, s, n) for s, n in ranges], dim)


def all_gather(x: torch.Tensor, world: World, ranges: Ranges, whole: int,
               dim: int = -1) -> torch.Tensor:
    """The whole tensor of which x holds this rank's `ranges` along `dim`
    (`whole` wide there), each rank holding its own: one all-reduce of a
    zero-filled buffer into which each rank writes its part."""
    if world.group is None:
        return x
    shape = list(x.shape)
    shape[dim] = whole
    out = x.new_zeros(shape)
    at = 0
    for s, n in ranges:
        out.narrow(dim, s, n).copy_(x.narrow(dim, at, n))
        at += n
    dist.all_reduce(out, group=world.group)
    return out


def reduce_scatter(x: torch.Tensor, world: World, ranges: Ranges,
                   dim: int = -1) -> torch.Tensor:
    """The sum of x over the ranks, of which this rank keeps its `ranges`
    along `dim`: an all-reduce, then the rank's part."""
    if world.group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=world.group)
    return take(out, ranges, dim)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its gradient is the sum over ranks of the
    incoming gradients (each rank's loss depends on every rank's
    input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, world: World) -> torch.Tensor:
    """The sum of x over the ranks, differentiable (x itself at one
    process)."""
    if world.group is None:
        return x
    return _AllReduceSum.apply(x, world.group)


def agree(flag: bool, world: World) -> bool:
    """True on every rank when `flag` is true on some rank (the vote of
    the checkpoint's fallback). A synchronisation point."""
    if world.group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=world.device)
    dist.all_reduce(t, group=world.group)
    return bool(t.item())


def same_on_all_ranks(tensors: List[torch.Tensor], world: World) -> bool:
    """Whether every rank holds bitwise the same tensors (a check for
    tests and the smoke run: rank 0's copy is broadcast and compared)."""
    if world.group is None:
        return True
    mine = [t.detach().clone() for t in tensors]
    theirs = [t.detach().clone() for t in tensors]
    broadcast_(theirs, world)
    return not agree(any(not torch.equal(a, b)
                         for a, b in zip(mine, theirs)), world)
