"""Positional encodings.

- 2D sine position embedding (reference networks/layers/position.py:35-77).
- RMem's learnable temporal PE over memory slots, interpolated to the live
  memory length (reference networks/layers/transformer.py:594-629). The
  interpolation is linear in the embedding, so it is one constant
  [T_cap+1, T_cap, S] weight bank indexed by the live length.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rmem_ocu_tpu_torch.ops.resize import _linear_matrix, _nearest_matrix


def sine_position_embedding(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float = 2 * math.pi) -> torch.Tensor:
    """Returns [1, H, W, 2*num_pos_feats] (y features then x features)."""
    grid_y, grid_x = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32),
                                 indexing='ij')
    y_embed = grid_y[None]
    x_embed = grid_x[None]
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * np.trunc(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = np.stack((np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])),
                     axis=4).reshape(1, h, w, -1)
    pos_y = np.stack((np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])),
                     axis=4).reshape(1, h, w, -1)
    return torch.from_numpy(np.concatenate((pos_y, pos_x), axis=3))


@functools.lru_cache(maxsize=64)
def _temporal_pe_weight_bank(capacity: int, num_slots: int) -> np.ndarray:
    """W[T] is the [capacity, num_slots] matrix such that
    (W[T] @ mem_pos_emb)[:T] equals the reference's interpolated memory PE
    for live length T and rows >= T are zero. Index 0 = empty memory.

    Reference semantics (transformer.py:596-623), max_T = 4:
      T == 1          -> mem_pos_emb[0]
      1 < T <= slots  -> mem_pos_emb[:T]
      slots < T <= 4  -> linear interp slots -> T (align_corners=True)
      T > 4           -> linear interp slots -> 4, then flip, nearest -> T,
                         flip back.
    """
    max_t = 4
    bank = np.zeros((capacity + 1, capacity, num_slots), dtype=np.float32)
    flip = lambda m: m[::-1].copy()
    for t in range(1, capacity + 1):
        if t == 1:
            w = np.zeros((1, num_slots), np.float32)
            w[0, 0] = 1.0
        elif t <= num_slots:
            w = np.eye(num_slots, dtype=np.float32)[:t]
        elif t <= max_t:
            w = _linear_matrix(num_slots, t, True)
        else:
            w = _linear_matrix(num_slots, max_t, True)
            w = flip(_nearest_matrix(max_t, t) @ flip(w))
        bank[t, :t] = w
    return bank


@functools.lru_cache(maxsize=16)
def _weight_bank_on(device: torch.device, capacity: int, num_slots: int
                    ) -> torch.Tensor:
    """The weight bank, copied to `device` once: a copy per frame would
    synchronise the stream."""
    return torch.from_numpy(_temporal_pe_weight_bank(capacity,
                                                     num_slots)).to(device)


def interpolated_memory_pe(mem_pos_emb: torch.Tensor, live_len: torch.Tensor,
                           capacity: int) -> torch.Tensor:
    """mem_pos_emb: [S, C]; live_len: [B] int in [0, capacity].
    Returns [B, capacity, C] (f32 arithmetic, mem_pos_emb's dtype) with rows
    >= live_len zero."""
    bank = _weight_bank_on(mem_pos_emb.device, capacity, mem_pos_emb.shape[0])
    w = bank[live_len.long()]                           # [B, capacity, S]
    return torch.einsum('bts,sc->btc', w, mem_pos_emb.float()).to(
        mem_pos_emb.dtype)
