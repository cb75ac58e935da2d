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
CPU and gloo on CUDA tensors.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')


@dataclass(frozen=True)
class World:
    """rank of size processes; `device` is this process's device; `group`
    is None for one process without a process group."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device('cpu')
    group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def torchrun_line(n: int, module: str) -> str:
    """The launch line of `module` data-parallel over n cards of one
    host."""
    return (f'torchrun --nproc_per_node {n} -m {module} --multihost '
            f'--mesh {n} ...')


def env_rank_and_size():
    """(RANK, WORLD_SIZE, LOCAL_RANK) from torchrun's environment, or
    (0, 1, 0) outside it."""
    return tuple(int(os.environ.get(k, d)) for k, d in
                 (('RANK', '0'), ('WORLD_SIZE', '1'), ('LOCAL_RANK', '0')))


def init_from_env(device: Optional[str] = None,
                  backend: Optional[str] = None,
                  timeout_s: float = 600.0) -> World:
    """Form the process group from torchrun's environment and return this
    process's World. `device=None` takes `cuda:LOCAL_RANK` (and raises
    without a card); 'cpu' trains on the CPU. The backend is NCCL on the
    card and gloo on the CPU unless given. Raises when the environment
    lacks a variable or the group does not form within `timeout_s`."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f'no process group: {", ".join(missing)} unset; launch with '
            f'torchrun (or set RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR '
            f'and MASTER_PORT)')
    rank, size, local = env_rank_and_size()
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
    return World(rank=rank, size=size, device=dev, group=dist.group.WORLD)


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
    _coalesced(tensors, lambda flat: dist.broadcast(flat, src,
                                                    group=world.group))


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
