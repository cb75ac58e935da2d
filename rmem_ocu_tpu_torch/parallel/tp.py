"""Tensor parallelism (Megatron-style) of the LSTT and GPM projections
over a model group, and ZeRO stage 1: the optimizer's moments sharded
over the data-parallel ranks.

The counterpart of the JAX package's `parallel/tp.py`. Its spec table is
copied here over the port's names (`tp_param_spec`): under the
transformer (`LSTT.` in a state_dict, EMA or moment key) the input
projections are column-split (`_COL`: in torch's [out, in] layout weight
dimension 0 and the bias) and the output projections row-split (`_ROW`:
weight dimension 1, the bias whole: it adds after the reduce); every
other tensor, and one whose split dimension the group's size does not
divide, stays whole. Where the JAX package lets GSPMD insert the
collectives, the port's modules hold their shards and call the explicit
collectives of parallel/layers.py.

Each block of the transformer states how its split tensors are cut
(`tp_layout`: the dimension and its segments, each segment split evenly
over the ranks). Most are one contiguous segment, GSPMD's own shard. The
GPM's fused `linear_QV` is [q | v] along its output: each segment splits
on its own, so that a rank's rows never straddle the query and the value;
and its gated attentions' value channels are [V | ID_V] (or the two
halves of `_cat_half`), whose rank parts are not adjacent in the whole:
their projections' input and their depthwise convolutions follow the
same two-segment map. These shards hold the bytes per rank of GSPMD's
contiguous ones, in another order. `shard_model` checks the layouts
against the spec table, so the port splits exactly the JAX package's
leaves along the corresponding dimension.

ZeRO-1 (the JAX package's `_zero1_spec` and `state_shardings(zero1=True)`,
:87-139): for each moment of Adam (`mu`, `nu`) or SGD (`trace`), the
largest dimension that the data-parallel size divides and tensor
parallelism leaves unsplit is split over the data ranks; a moment with no
such dimension stays whole on every data rank. Each rank keeps and
updates its slice of the moments (the update is elementwise, so the
result is the unsharded step's) and the slices of the update are
gathered back into every rank's full update. The reference's DDP
replicates the optimizer state on every rank
(aot_plus/networks/managers/trainer.py:94-113).

Gathers are one all-reduce of a zero-filled flat buffer into which each
rank writes its slices: x + 0 is exact in any order, so every rank ends
with the same bits. Under NCCL an all-reduce moves twice the bytes of an
`all_gather` of the same buffer (a reduce-scatter and an all-gather), but
it needs only the collectives that gloo also runs on CUDA tensors.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.parallel.dist import Ranges, World

# output-features-split projections (column-parallel)
_COL = frozenset({
    'linear_Q', 'linear_K', 'linear_V', 'linear_QMem', 'linear_VMem',
    'linear_QK', 'linear_V1', 'linear_V2', 'linear_U1', 'linear_U2',
    'linear_QV', 'linear_U', 'linear_ID_V', 'linear_ID_U', 'linear1',
})
# input-features-split projections (row-parallel)
_ROW = frozenset({'projection', 'linear2'})

# name -> (split dimension, the segments of that dimension)
Layout = Dict[str, Tuple[int, Tuple[int, ...]]]


def tp_param_spec(name: str, shape: Sequence[int], tp: int
                  ) -> Optional[int]:
    """The dimension of the tensor `name` (a parameter, EMA or moment key
    of the port) that tensor parallelism over tp ranks splits, or None
    (the JAX package's `tp_param_spec`, tp.py:57-80, in torch's [out, in]
    layout)."""
    parts = name.split('.')
    if 'lstt.' not in name.lower() or len(parts) < 2:
        return None
    parent, last = parts[-2], parts[-1]
    shape = tuple(shape)
    if parent in _COL:
        if last == 'weight' and len(shape) == 2 and shape[0] % tp == 0:
            return 0
        if last == 'bias' and len(shape) == 1 and shape[0] % tp == 0:
            return 0
    elif parent in _ROW:
        if last == 'weight' and len(shape) == 2 and shape[1] % tp == 0:
            return 1
        # a row-split projection's bias adds after the reduce: whole
    return None


def ranges_of(segments: Sequence[int], rank: int, size: int) -> Ranges:
    """This rank's (start, length) part of each segment of a dimension
    made of `segments` (each split evenly over `size` ranks)."""
    out, start = [], 0
    for n in segments:
        if n % size:
            raise ValueError(f'a segment of {n} does not split over '
                             f'{size} ranks')
        k = n // size
        out.append((start + rank * k, k))
        start += n
    return tuple(out)


def model_layout(model) -> Layout:
    """The split tensors of a whole model, by parameter name: each block
    of its transformer (`model.LSTT.layers`) states its own."""
    out = {}
    for i, block in enumerate(model.LSTT.layers):
        for k, v in block.tp_layout().items():
            out[f'LSTT.layers.{i}.{k}'] = v
    return out


def check_layout(layout: Layout, shapes: Mapping[str, Sequence[int]],
                 tp: int) -> None:
    """Raise unless the layout splits exactly the tensors the spec table
    splits at tp, along the same dimension, and every segment splits
    evenly."""
    for name, shape in shapes.items():
        want = tp_param_spec(name, shape, tp)
        got = layout[name][0] if name in layout else None
        if want != got:
            raise ValueError(
                f'{name} {tuple(shape)}: the spec table splits dimension '
                f'{want} over {tp} ranks, the module dimension {got}: '
                f'this model does not split over a model group of {tp}')
        if name in layout:
            dim, segments = layout[name]
            if sum(segments) != shape[dim]:
                raise ValueError(f'{name}: segments {segments} do not '
                                 f'cover dimension {dim} of {tuple(shape)}')
            ranges_of(segments, 0, tp)


def shard_tensors(tensors: Mapping[str, torch.Tensor], layout: Layout,
                  world: World) -> Dict[str, torch.Tensor]:
    """This rank's shard of each whole tensor of the layout (a copy);
    the others pass through."""
    out = {}
    for k, t in tensors.items():
        if k in layout:
            dim, segments = layout[k]
            t = dist.take(t, ranges_of(segments, world.rank, world.size),
                          dim).clone(memory_format=torch.contiguous_format)
        out[k] = t
    return out


def gather_tensors(shards: Mapping[str, torch.Tensor], layout: Layout,
                   world: World) -> Dict[str, torch.Tensor]:
    """The whole tensors from every rank's shards: one all-reduce of a
    zero-filled flat buffer per dtype. Tensors outside the layout are
    whole already and pass through."""
    out = dict(shards)
    split = [k for k in shards if k in layout]
    if world.group is None or not split:
        return out
    by_dtype = {}
    for k in split:
        by_dtype.setdefault(shards[k].dtype, []).append(k)
    for keys in by_dtype.values():
        shapes = []
        for k in keys:
            dim, segments = layout[k]
            shape = list(shards[k].shape)
            shape[dim] = sum(segments)
            shapes.append(shape)
        sizes = [int(torch.Size(s).numel()) for s in shapes]
        flat = shards[keys[0]].new_zeros(sum(sizes))
        for k, shape, part in zip(keys, shapes, flat.split(sizes)):
            dim, segments = layout[k]
            whole = part.view(shape)
            at = 0
            for s, n in ranges_of(segments, world.rank, world.size):
                whole.narrow(dim, s, n).copy_(shards[k].narrow(dim, at, n))
                at += n
            out[k] = whole
        dist.all_reduce_([flat], world)
    return out


def shard_model(model, world: World) -> Layout:
    """Cut a whole model into this rank's shard of the model group
    `world`, in place: the split parameters become their shards (and so
    do the state_dict and the EMA of a trainer built after), and each
    transformer block learns its group. Returns the layout (empty at one
    rank). Raises, naming the tensor, when the model does not split over
    the group."""
    if world.size == 1:
        return {}
    layout = model_layout(model)
    check_layout(layout, {k: p.shape for k, p in model.named_parameters()},
                 world.size)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k in layout:
                p.data = shard_tensors({k: p.data}, layout, world)[k]
    for block in model.LSTT.layers:
        block.set_tp(world)
    model.tp, model.tp_layout = world, layout
    return layout


def whole_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's state_dict with its split tensors gathered whole (a
    collective over its model group: every rank calls it)."""
    return gather_tensors(model.state_dict(), model.tp_layout, model.tp)


def load_whole_state_dict(model, sd: Mapping[str, torch.Tensor],
                          strict: bool = True):
    """Load a whole state_dict into a (possibly sharded) model."""
    return model.load_state_dict(
        shard_tensors(sd, model.tp_layout, model.tp), strict=strict)


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
    (data-parallel) world: which dimension of each is split, and this
    rank's slice. `taken` names the dimensions tensor parallelism splits
    (the tensors' own shapes may be shards: the other dimensions are the
    whole's)."""

    def __init__(self, shapes: Dict[str, Sequence[int]], world: World,
                 taken: Optional[Mapping[str, Iterable[int]]] = None):
        self.world = world
        taken = taken or {}
        self.dims = {k: zero1_dim(tuple(s), tuple(taken.get(k, ())),
                                  world.size)
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
