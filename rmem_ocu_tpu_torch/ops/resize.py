"""Resizing.

The JAX package builds explicit interpolation matrices because
`jax.image.resize` lacks torch's align_corners convention; here
`F.interpolate` is the reference operation itself. The numpy matrices are
kept only for the temporal PE, whose interpolation over memory slots is
precomputed as a weight bank (ops/position.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, size, align_corners: bool
                         ) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, size[0], size[1]] (torch bilinear)."""
    if tuple(x.shape[-2:]) == (int(size[0]), int(size[1])):
        return x
    return F.interpolate(x, size=(int(size[0]), int(size[1])),
                         mode='bilinear', align_corners=align_corners)


@functools.lru_cache(maxsize=256)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool):
    """[out_size, in_size] row-stochastic linear interpolation matrix
    (torch mode='linear')."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = dst * (in_size - 1) / (out_size - 1)
    else:
        src = np.clip((dst + 0.5) * in_size / out_size - 0.5, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    m[np.arange(out_size), lo] += (1.0 - w_hi).astype(np.float32)
    m[np.arange(out_size), hi] += w_hi.astype(np.float32)
    return m


@functools.lru_cache(maxsize=256)
def _nearest_matrix(in_size: int, out_size: int):
    """torch mode='nearest': src = floor(dst * in / out)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    src = np.minimum(np.floor(dst * in_size / out_size), in_size - 1)
    m[np.arange(out_size), src.astype(np.int64)] = 1.0
    return m
