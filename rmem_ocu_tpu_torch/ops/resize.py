"""Resizing.

The JAX package builds explicit interpolation matrices because
`jax.image.resize` lacks torch's align_corners convention; here
`F.interpolate` is the reference operation itself. The numpy matrices are
kept only for the temporal PE, whose interpolation over memory slots is
precomputed as a weight bank (ops/position.py).

Under spatial sharding (parallel/spatial.py) a band of rows resizes to
its band of the output: each output row reads its two source rows at the
whole map's coordinates, torch's (f32 scale, source index and weights;
f64 for f64 maps), fetching the rows past its band from its neighbours.
With align_corners the source row of output row i is i (in - 1) /
(out - 1); without, torch's half-pixel rows, (i + 0.5) in / out - 0.5
clamped at 0, so a band's first row may read a row of the band above
(the TopDown oracle's mask: at 465 px and M = 2 the 16x row 15 reads
the rows 239 and 240).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.spatial import Bands, Rows


def interpolate_bilinear(x: torch.Tensor, size, align_corners: bool,
                         bands: Optional[Bands] = None,
                         rows: Optional[Tuple[Rows, Rows]] = None
                         ) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, size[0], size[1]] (torch bilinear). With
    `bands`, x is a band of its map and size the output's band; `rows`
    gives the (stride, whole rows) of the two maps where a width names no
    stride (by default the strides their widths name, and ceil(H / s)
    rows)."""
    if bands is not None:
        return _banded_bilinear(x, size, align_corners, bands, rows)
    if tuple(x.shape[-2:]) == (int(size[0]), int(size[1])):
        return x
    return F.interpolate(x, size=(int(size[0]), int(size[1])),
                         mode='bilinear', align_corners=align_corners)


def _source_rows(in_size: int, out_size: int, first: int, end: int,
                 align_corners: bool, wide: bool):
    """torch's bilinear source rows (lo, hi) and weight of hi for the
    output rows [first, end) of in_size -> out_size, in f32 (f64 when
    `wide`) as torch computes them (area_pixel_compute_scale,
    area_pixel_compute_source_index, guard_index_and_lambda)."""
    f = np.float64 if wide else np.float32
    dst = np.arange(first, end).astype(f)
    if align_corners:
        scale = (f(in_size - 1) / f(out_size - 1) if out_size > 1
                 else f(0))
        src = scale * dst
    else:
        scale = f(in_size) / f(out_size)
        src = np.maximum(scale * (dst + f(0.5)) - f(0.5), f(0))
    lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    hi = lo + (lo < in_size - 1)
    w_hi = np.clip(src - lo.astype(f), f(0), f(1)).astype(f)
    return lo, hi, w_hi


@functools.lru_cache(maxsize=64)
def _band_plan(bands: Bands, src: Rows, dst: Rows, align_corners: bool,
               wide: bool, device):
    """(rows of halo above, below, each output row's two indices into the
    band with its halo, their weights [rows, 1]) for this rank, resizing
    the map `src` to the map `dst`, each (stride, whole rows); the halo
    is the most any rank needs, so that it is the same on every rank."""
    sizes = src[1], dst[1]
    need = []
    for r in range(bands.world.size):
        a0, a1 = bands.rows(src[0], r, src[1])
        lo, hi, _ = _source_rows(*sizes, *bands.rows(dst[0], r, dst[1]),
                                 align_corners, wide)
        need.append((a0 - int(lo.min()), int(hi.max()) - (a1 - 1)))
    top = max(max(t for t, _ in need), 0)
    bottom = max(max(b for _, b in need), 0)
    lo, hi, w_hi = _source_rows(*sizes, *bands.rows(dst[0], None, dst[1]),
                                align_corners, wide)
    at = bands.rows(src[0], None, src[1])[0] - top
    idx = lambda i: torch.from_numpy(i - at).to(device)
    w = torch.from_numpy(w_hi)[:, None].to(device)
    return top, bottom, idx(lo), idx(hi), w


def _banded_bilinear(x, size, align_corners: bool, bands: Bands,
                     rows: Optional[Tuple[Rows, Rows]]):
    size = (int(size[0]), int(size[1]))
    if rows is None:
        rows = tuple((s, bands.whole_rows(s)) for s in (
            bands.level(x.shape[-1]), bands.level(size[1])))
    src, dst = rows
    if src[1] == dst[1] and x.shape[-1] == size[1]:
        return x
    first, end = bands.rows(dst[0], None, dst[1])
    if end - first != size[0]:
        raise ValueError(f'{size} is not the band of rows [{first}, {end}) '
                         f'of the map {dst}')
    top, bottom, lo, hi, w_hi = _band_plan(
        bands, src, dst, align_corners, x.dtype == torch.float64, x.device)
    if top or bottom:
        bands.check_halo(src[0], top, bottom, 'a bilinear resize', src[1])
        x = spatial.halo_rows(x, top, bottom, bands.world)
    # the columns first, as torch's kernel weighs them, then the rows
    if x.shape[-1] != size[1]:
        x = F.interpolate(x, size=(x.shape[-2], size[1]), mode='bilinear',
                          align_corners=align_corners)
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
