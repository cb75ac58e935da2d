"""ZeRO stage 1: the optimizer's moments sharded over the data-parallel
ranks.

The ZeRO-1 half of the JAX package's `parallel/tp.py` (:87-139): for each
moment of Adam (`mu`, `nu`) or SGD (`trace`), the largest dimension that
the world size divides is split over the ranks; a moment with no such
dimension stays whole on every rank. Each rank keeps and updates its
slice of the moments (the update is elementwise, so the result is the
unsharded step's) and the slices of the update are gathered back into
every rank's full update. The reference's DDP replicates the optimizer
state on every rank (aot_plus/networks/managers/trainer.py:94-113).

The tensor-parallel half (`tp_param_spec`, `shard_params`: column- and
row-split LSTT and GPM projections) waits for ROADMAP item 15b.

The gather is one all-reduce of a zero-filled flat buffer into which each
rank writes its slices: x + 0 is exact in any order, so every rank ends
with the same bits. Under NCCL an all-reduce moves twice the bytes of an
`all_gather` of the same buffer (a reduce-scatter and an all-gather), but
it needs only the collectives that gloo also runs on CUDA tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.parallel.dist import World

# the optimizer-state fields that hold one moment per parameter: Adam's
# mu / nu and SGD's momentum trace
OPT_MOMENTS = frozenset({'mu', 'nu', 'trace'})


def zero1_dim(shape: Sequence[int], taken_dims: Tuple[int, ...],
              dp: int) -> Optional[int]:
    """The dimension ZeRO-1 splits over dp ranks: the largest one, not
    already taken (by tensor parallelism), that dp divides; the first of
    equal ones; None when none qualifies (the JAX package's `_zero1_spec`
    as a dimension index)."""
    best, best_size = None, 0
    for d, n in enumerate(shape):
        if d not in taken_dims and n % dp == 0 and n > best_size:
            best, best_size = d, n
    return best


class Zero1:
    """The ZeRO-1 layout of named tensors of the given shapes over a
    world: which dimension of each is split, and this rank's slice."""

    def __init__(self, shapes: Dict[str, Sequence[int]], world: World):
        self.world = world
        self.dims = {k: zero1_dim(tuple(s), (), world.size)
                     for k, s in shapes.items()}

    def shard(self, tensors: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's slice of each tensor (a view), the whole tensor
        where nothing splits."""
        out = {}
        for k, t in tensors.items():
            d = self.dims[k]
            if d is None:
                out[k] = t
            else:
                n = t.shape[d] // self.world.size
                out[k] = t.narrow(d, self.world.rank * n, n)
        return out

    def gather(self, shards: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The full tensors from every rank's slices (of one dtype): one
        all-reduce of a zero-filled flat buffer, whose views they are.
        Tensors that do not split are already whole on every rank and pass
        through."""
        world = self.world
        split = [k for k in shards if self.dims[k] is not None]
        if not split:
            return dict(shards)
        sizes = [shards[k].numel() * world.size for k in split]
        flat = shards[split[0]].new_zeros(sum(sizes))
        full = {}
        for k, part in zip(split, flat.split(sizes)):
            s, d = shards[k], self.dims[k]
            shape = list(s.shape)
            shape[d] *= world.size
            full[k] = part.view(shape)
            full[k].narrow(d, world.rank * s.shape[d], s.shape[d]).copy_(s)
        dist.all_reduce_([flat], world)
        return {k: full.get(k, v) for k, v in shards.items()}
