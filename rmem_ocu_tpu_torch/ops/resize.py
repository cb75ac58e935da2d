"""Resizing.

The JAX package builds explicit interpolation matrices because
`jax.image.resize` lacks torch's align_corners convention; here
`F.interpolate` is the reference operation itself. The numpy matrices are
kept only for the temporal PE, whose interpolation over memory slots is
precomputed as a weight bank (ops/position.py).

Under spatial sharding (parallel/spatial.py) a band of rows resizes to
its band of the output (align_corners, as every banded model): each output
row reads its two source rows at the whole map's coordinates, torch's (f32
scale, source index and weights), fetching the rows past its band from
its neighbours.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.spatial import Bands


def interpolate_bilinear(x: torch.Tensor, size, align_corners: bool,
                         bands: Optional[Bands] = None) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, size[0], size[1]] (torch bilinear). With
    `bands`, x is a band of its map and size the output's band."""
    if tuple(x.shape[-2:]) == (int(size[0]), int(size[1])):
        return x
    if bands is not None:
        return _banded_bilinear(x, size, align_corners, bands)
    return F.interpolate(x, size=(int(size[0]), int(size[1])),
                         mode='bilinear', align_corners=align_corners)


def _source_rows(in_size: int, out_size: int, first: int, end: int):
    """torch's bilinear source rows (lo, hi) and weight of hi for the
    output rows [first, end) of in_size -> out_size with align_corners,
    in f32 as torch computes them (area_pixel_compute_scale and
    _source_index)."""
    f32 = np.float32
    scale = f32(in_size - 1) / f32(out_size - 1) if out_size > 1 else f32(0)
    src = scale * np.arange(first, end).astype(f32)
    lo = src.astype(np.int64)
    hi = lo + (lo < in_size - 1)
    return lo, hi, (src - lo.astype(f32)).astype(f32)


@functools.lru_cache(maxsize=64)
def _band_plan(bands: Bands, s_in: int, s_out: int, device):
    """(rows of halo above, below, each output row's two indices into the
    band with its halo, their weights [rows, 1]) for this rank, resizing
    the map at stride s_in to the one at s_out; the halo is the most any
    rank needs, so that it is the same on every rank."""
    sizes = bands.whole_rows(s_in), bands.whole_rows(s_out)
    need = []
    for r in range(bands.world.size):
        a0, a1 = bands.rows(s_in, r)
        lo, hi, _ = _source_rows(*sizes, *bands.rows(s_out, r))
        need.append((a0 - int(lo.min()), int(hi.max()) - (a1 - 1)))
    top = max(max(t for t, _ in need), 0)
    bottom = max(max(b for _, b in need), 0)
    lo, hi, w_hi = _source_rows(*sizes, *bands.rows(s_out))
    at = bands.rows(s_in)[0] - top
    idx = lambda i: torch.from_numpy(i - at).to(device)
    w = torch.from_numpy(w_hi)[:, None].to(device)
    return top, bottom, idx(lo), idx(hi), w


def _banded_bilinear(x, size, align_corners: bool, bands: Bands):
    if not align_corners:
        raise NotImplementedError('a banded resize without align_corners '
                                  '(no banded encoder needs one)')
    s_in = bands.level(x.shape[-1])
    s_out = bands.level(int(size[1]))
    first, end = bands.rows(s_out)
    if end - first != int(size[0]):
        raise ValueError(f'{tuple(size)} is not the band of rows '
                         f'[{first}, {end}) at stride {s_out}')
    top, bottom, lo, hi, w_hi = _band_plan(bands, s_in, s_out, x.device)
    if top or bottom:
        bands.check_halo(s_in, top, bottom, 'a bilinear resize')
        x = spatial.halo_rows(x, top, bottom, bands.world)
    # the columns first, as torch's kernel weighs them, then the rows
    if x.shape[-1] != int(size[1]):
        x = F.interpolate(x, size=(x.shape[-2], int(size[1])),
                          mode='bilinear', align_corners=True)
    w_hi = w_hi.to(x.dtype)
    return (x.index_select(-2, lo) * (1 - w_hi)
            + x.index_select(-2, hi) * w_hi)


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
