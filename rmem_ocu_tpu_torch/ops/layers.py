"""Primitive layers (norms, conv blocks, dropout and drop-path).

Counterpart of the JAX package's `ops/layers.py`. Tokens are [B, HW, C] at
module boundaries, as in the JAX package; convolutions run on NCHW inside
a module. Norm epsilons are torch's 1e-5.

Train-time masks (dropout, drop-path, the channel dropout of DWConv2d) are
drawn only in a module's training mode, from the generator that
`noise_from` installs, or from torch's global generator outside it. The
training engine installs a generator seeded per step inside each
checkpointed function, so that a recompute draws the same masks. Under
data parallelism it also installs the rank's block of the batch: each rank
draws the masks of the whole world's batch, as one process would, and
keeps its own rows, so that W ranks of B samples draw what one process of
W*B samples draws. Under tensor parallelism a draw on a tensor whose
channels are split over the model group draws the whole tensor's mask and
keeps the rank's channels (`cols`), and a draw on a whole tensor is the
same on every rank of the group: the ranks of a model group draw alike.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.dist import (Ranges, World, all_reduce_sum,
                                              take)
from rmem_ocu_tpu_torch.parallel.layers import scatter_to_model

EPS = 1e-5


class _NoiseSource(threading.local):
    generator: Optional[torch.Generator] = None
    rank: int = 0
    world: int = 1


_NOISE = _NoiseSource()


@contextlib.contextmanager
def noise_from(generator: Optional[torch.Generator], rank: int = 0,
               world: int = 1):
    """Draw the train-time masks of the enclosed calls from `generator`
    (on the device of the tensors masked), as rows rank*B:(rank+1)*B of
    the world's batch of world*B (axis 0 of every mask is the batch, or a
    batch-major flattening of it)."""
    prev = _NOISE.generator, _NOISE.rank, _NOISE.world
    _NOISE.generator, _NOISE.rank, _NOISE.world = generator, rank, world
    try:
        yield
    finally:
        _NOISE.generator, _NOISE.rank, _NOISE.world = prev


def keep_mask(shape, keep: float, like: torch.Tensor,
              cols: Optional[Tuple[Ranges, int]] = None) -> torch.Tensor:
    """A {0, 1} mask in like's dtype and device, 1 with probability
    `keep`: this rank's rows of the world's draw. cols = (ranges, whole)
    draws a last axis `whole` wide and keeps this model rank's ranges of
    it."""
    shape = tuple(shape)
    n, rank = shape[0], _NOISE.rank
    last = shape[1:] if cols is None else shape[1:-1] + (cols[1],)
    u = torch.rand((n * _NOISE.world,) + last,
                   generator=_NOISE.generator, device=like.device)
    u = u[rank * n:(rank + 1) * n]
    if cols is not None:
        u = take(u, cols[0], -1)
    return (u < keep).to(like.dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            shape=None, cols: Optional[Tuple[Ranges, int]] = None
            ) -> torch.Tensor:
    """x * mask / keep with mask ~ Bernoulli(1 - rate) of `shape` (x's by
    default, broadcast over x), as the JAX package drops; the identity out
    of training or at rate 0. `cols`: see keep_mask."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    return x * keep_mask(x.shape if shape is None else shape, keep, x,
                         cols) / keep


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Stochastic depth: each sample of the batch (axis 0) is kept with
    probability 1 - rate and scaled by 1 / keep (reference basic.py:98-117,
    whose batch axis is 1)."""
    return dropout(x, rate, training, (x.shape[0],) + (1,) * (x.dim() - 1))


class DropPath(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.rate, self.training)


def scale_in_dtype(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x * scale with the scale first rounded to x.dtype (the JAX package
    multiplies by a scalar of the array's dtype). The scale stays a Python
    number: a device tensor built from it would be a host-to-device copy,
    which synchronises the stream."""
    return x * torch.tensor(scale, dtype=x.dtype).item()


def tokens_to_2d(x: torch.Tensor, size_2d: Tuple[int, int]) -> torch.Tensor:
    """[B, HW, C] tokens -> [B, C, H, W] feature map."""
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, size_2d[0], size_2d[1])


def tokens_from_2d(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] feature map -> [B, HW, C] tokens."""
    return x.flatten(2).transpose(1, 2)


class GroupNorm1D(nn.Module):
    """GroupNorm over token channels (reference basic.py:6-12); the inner
    `.gn` keeps the reference's state_dict key."""

    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.gn = nn.GroupNorm(groups, dim, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(x.transpose(1, 2)).transpose(1, 2)


class ConvGN(nn.Module):
    """Conv2d + GroupNorm(8) (reference basic.py:60-70), NCHW; on a band
    of rows under spatial sharding, normalised by the whole map's
    moments."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 gn_groups: int = 8):
        super().__init__()
        conv = spatial.Conv2d if kernel_size > 1 else nn.Conv2d
        self.conv = conv(in_dim, out_dim, kernel_size,
                         padding=kernel_size // 2)
        self.gn = nn.GroupNorm(gn_groups, out_dim, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bands = spatial.current()
        x = self.conv(x)
        return self.gn(x) if bands is None else spatial.group_norm(
            x, self.gn, bands)


class _ChannelShard:
    """A module over `dim` channels that a model group may split:
    `channels` are this rank's (start, length) ranges of them, all of them
    at one process. Its weights stay whole on every rank; a rank takes its
    channels' at use (`scatter_to_model`, so that their gradients sum over
    the group)."""

    def _all_channels(self, dim: int) -> None:
        self.set_channels(World(), ((0, dim),))

    def set_channels(self, world: World, channels: Ranges) -> None:
        self.tp, self.channels = world, tuple(channels)

    def _mine(self, w: torch.Tensor) -> torch.Tensor:
        return scatter_to_model(w, self.tp, self.channels, 0)


def _depthwise(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x2d, w, None, padding=w.shape[-1] // 2,
                    groups=w.shape[0])


class GNActDWConv2d(_ChannelShard, nn.Module):
    """GroupNorm(32) -> GELU -> depthwise 5x5 conv without bias, on tokens
    (reference basic.py:15-35): the FFN activation of the LSTT blocks. The
    GELU is the exact erf form on f32 and the tanh form on bf16, as in the
    JAX package. On a rank's contiguous channels (between the column-split
    linear1 and the row-split linear2) each group stays local: the rank
    holds whole groups."""

    def __init__(self, dim: int, gn_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(gn_groups, dim, eps=EPS)
        self.conv = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=False)
        self._all_channels(dim)

    def forward(self, x: torch.Tensor, size_2d: Tuple[int, int]
                ) -> torch.Tensor:
        x2d = F.group_norm(tokens_to_2d(x, size_2d),
                           self.gn.num_groups // self.tp.size,
                           self._mine(self.gn.weight),
                           self._mine(self.gn.bias), self.gn.eps)
        x2d = F.gelu(x2d, approximate='tanh' if x2d.dtype == torch.bfloat16
                     else 'none')
        return tokens_from_2d(_depthwise(x2d, self._mine(self.conv.weight)))


class DWConv2d(_ChannelShard, nn.Module):
    """Depthwise 5x5 conv without bias on tokens, then, in training, the
    reference's Dropout2d: whole channels of a sample dropped at `dropout`
    (reference basic.py:38-57, 0.1 in every gated attention). On a rank's
    channels the conv takes their weights and the dropout their draws."""

    def __init__(self, dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.conv = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=False)
        self._all_channels(dim)

    def forward(self, x: torch.Tensor, size_2d: Tuple[int, int]
                ) -> torch.Tensor:
        x = tokens_from_2d(_depthwise(tokens_to_2d(x, size_2d),
                                      self._mine(self.conv.weight)))
        return dropout(x, self.dropout, self.training,
                       (x.shape[0], 1, x.shape[2]),
                       (self.channels, self.conv.weight.shape[0]))


def frozen_bn_scale_bias(weight, bias, running_mean, running_var,
                         epsilon: float = EPS):
    """Fold frozen-BN statistics into (scale, bias) (reference
    networks/layers/normalization.py:6-28)."""
    scale = weight * torch.rsqrt(running_var + epsilon)
    return scale, bias - running_mean * scale


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, all buffers
    (reference normalization.py: running_var starts at 1 - eps)."""

    def __init__(self, dim: int, epsilon: float = EPS):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer('weight', torch.ones(dim))
        self.register_buffer('bias', torch.zeros(dim))
        self.register_buffer('running_mean', torch.zeros(dim))
        self.register_buffer('running_var', torch.full((dim,), 1.0 - epsilon))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, offset = frozen_bn_scale_bias(
            self.weight, self.bias, self.running_mean, self.running_var,
            self.epsilon)
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class BatchNorm2d(nn.Module):
    """Trainable BatchNorm with torch BatchNorm2d semantics (the encoders'
    norm when freeze_bn is off; the JAX package's `BatchNorm`). In
    training the batch is normalised with its biased variance and the
    running statistics move at momentum 0.1 towards the batch mean and
    unbiased variance; statistics are f32 (f64 on f64 inputs). In eval the
    running statistics normalise.

    With `defer_stats` set (the training engine sets it) a training
    forward leaves the buffers alone and puts the new running statistics
    in `pending` (mean, var): a checkpointed encoder runs its forward
    twice, and each run must start from the same statistics.

    With `world` set to a data-parallel World (the training engine sets
    it; under spatial sharding the whole world, whose model ranks hold
    bands of the same samples) the batch moments are those of the world's
    batch, as the JAX package's one program over a data mesh computes
    them (SyncBN): the sum, then the squared deviations from the global
    mean, and the element count, each summed over the ranks by a
    differentiable all-reduce. Every rank runs the same reduces in the
    same order, the recompute of a checkpointed encoder included.

    `banded` False marks a BN whose input is alike on every rank of a
    model group under spatial sharding (ResNeSt's split-attention BN of
    a pooled [B, C, 1, 1] vector): the engine gives it the data group,
    since the whole world would count each sample M times."""

    def __init__(self, dim: int, epsilon: float = EPS,
                 momentum: float = 0.1, banded: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.banded = banded
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer('running_mean', torch.zeros(dim))
        self.register_buffer('running_var', torch.ones(dim))
        self.defer_stats = False
        self.pending: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.world: Optional[World] = None

    def _moments(self, xf: torch.Tensor):
        """(mean, biased var, n / (n - 1)) over the batch's n elements a
        channel: this process's batch, or the world's."""
        world = self.world or World()
        # [sum of each channel, n] in one reduce; n stays on the device
        sums = all_reduce_sum(torch.cat([
            xf.sum(dim=(0, 2, 3)),
            xf.new_full((1,), xf.numel() / xf.shape[1])]), world)
        n = sums[-1]
        mean = sums[:-1] / n
        sq = (xf - mean[:, None, None]).square().sum(dim=(0, 2, 3))
        return (mean, all_reduce_sum(sq, world) / n,
                (n / (n - 1).clamp_min(1)).detach())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean, var, unbias = self._moments(xf)
            m = self.momentum
            with torch.no_grad():
                new = ((1 - m) * self.running_mean.float() + m * mean,
                       (1 - m) * self.running_var.float()
                       + m * var * unbias)
                if self.defer_stats:
                    self.pending = new
                else:
                    self.running_mean.copy_(new[0])
                    self.running_var.copy_(new[1])
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.epsilon)
        offset = self.bias - mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


def make_bn(dim: int, frozen: bool = True, banded: bool = True
            ) -> nn.Module:
    """The encoders' norm: FrozenBatchNorm2d, or the trainable
    BatchNorm2d when freeze_bn is off (reference encoders/__init__.py:10-37
    picks FrozenBatchNorm2d or BatchNorm2d); `banded`, see BatchNorm2d."""
    return FrozenBatchNorm2d(dim) if frozen else BatchNorm2d(dim,
                                                             banded=banded)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """x clipped to [lo, hi], with jnp.clip's gradient at the bounds: half
    the incoming gradient where x equals one (torch.clamp passes all of it,
    hardtanh none). Exact zeros are common at the bounds of a ReLU6 (a
    depthwise conv over clipped zeros), so the convention moves gradients.
    Without grad it is the one-kernel clamp."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.clamp(lo, hi)
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 max pool (reference nn.MaxPool2d(3, 2, 1)),
    on a band of rows under spatial sharding."""
    bands = spatial.current()
    if bands is not None:
        return spatial.max_pool_3x3_s2(x, bands)
    return F.max_pool2d(x, 3, 2, 1)


def avg_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 / pad-1 average pool counting the padding (flax's avg_pool with
    explicit padding), on a band of rows under spatial sharding."""
    bands = spatial.current()
    if bands is not None:
        return spatial.avg_pool_3x3(x, stride, bands)
    return F.avg_pool2d(x, 3, stride, 1)


def mean_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """x [B, C, H, W] averaged over H and W; under spatial sharding, of
    the whole map of which x is a band."""
    bands = spatial.current()
    if bands is not None:
        return spatial.mean_hw(x, bands, keepdim)
    return x.mean(dim=(2, 3), keepdim=keepdim)
