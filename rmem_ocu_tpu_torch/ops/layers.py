"""Primitive layers (norms, conv blocks).

Counterpart of the JAX package's `ops/layers.py`. Tokens are [B, HW, C] at
module boundaries, as in the JAX package; convolutions run on NCHW inside
a module. Norm epsilons are torch's 1e-5.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5


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
    """Conv2d + GroupNorm(8) (reference basic.py:60-70), NCHW."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 gn_groups: int = 8):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, kernel_size,
                              padding=kernel_size // 2)
        self.gn = nn.GroupNorm(gn_groups, out_dim, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(self.conv(x))


class GNActDWConv2d(nn.Module):
    """GroupNorm(32) -> GELU -> depthwise 5x5 conv without bias, on tokens
    (reference basic.py:15-35): the FFN activation of the LSTT blocks. The
    GELU is the exact erf form on f32 and the tanh form on bf16, as in the
    JAX package."""

    def __init__(self, dim: int, gn_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(gn_groups, dim, eps=EPS)
        self.conv = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=False)

    def forward(self, x: torch.Tensor, size_2d: Tuple[int, int]
                ) -> torch.Tensor:
        x2d = self.gn(tokens_to_2d(x, size_2d))
        x2d = F.gelu(x2d, approximate='tanh' if x2d.dtype == torch.bfloat16
                     else 'none')
        return tokens_from_2d(self.conv(x2d))


class DWConv2d(nn.Module):
    """Depthwise 5x5 conv without bias on tokens (reference
    basic.py:38-57; its Dropout2d is a train-time branch, left out)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=False)

    def forward(self, x: torch.Tensor, size_2d: Tuple[int, int]
                ) -> torch.Tensor:
        return tokens_from_2d(self.conv(tokens_to_2d(x, size_2d)))


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


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 max pool (reference nn.MaxPool2d(3, 2, 1))."""
    return F.max_pool2d(x, 3, 2, 1)
