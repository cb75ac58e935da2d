"""Swin Transformer (Swin-B) backbone: windows of 7, out strides 4/8/16.

Counterpart of the JAX package's `models/encoders/swin.py` (reference
aot_plus/networks/encoders/swin/swin_transformer.py, embed 128, depths
[2, 2, 18, 2], heads [4, 8, 16, 32]). Only stages 0-2 are built: the
reference computes stage 3 and discards it. Inside, tokens are [B, HW, C]
(channels last) as in both references, so the window partition and the
patch-merging concatenation keep their order; the outputs are NCHW.

The window attention is plain torch ops in the JAX order: q scaled in its
dtype, Q.K^T, the relative bias plus the shifted-window mask (additive
-100, not -inf), an f32 softmax, P.V. On bf16 inputs the logits and the
probabilities are stored in bf16 around the f32 softmax, as in the JAX
package. The MLP's GELU is the exact erf form on f32 and the tanh form on
bf16. nn.LayerNorm reduces bf16 input in f32 and rounds once, as flax's
LayerNorm does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.attention import _compact
from rmem_ocu_tpu_torch.ops.layers import EPS, scale_in_dtype


def relative_position_index(ws: int) -> np.ndarray:
    """[N, N] index into the (2ws-1)^2 bias table for the N = ws^2 tokens
    of a window (reference swin_transformer.py:101-110)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij'))        # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int64)


def shifted_window_mask(hp: int, wp: int, ws: int, shift: int
                        ) -> np.ndarray:
    """[nW, N, N] additive mask of the shifted windows: -100 between tokens
    of different regions of the rolled grid (reference
    swin_transformer.py:262-283)."""
    img = np.zeros((hp, wp))
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.dim, self.ws, self.num_heads = dim, window_size, num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        # not in the state_dict: the JAX package computes it, and a
        # reference checkpoint's copy is the same table of indices
        self.register_buffer('relative_position_index', torch.from_numpy(
            relative_position_index(window_size)).reshape(-1),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x: [B_, N, C] windows; mask: [nW, N, N] f32 or None."""
        b, n, c = x.shape
        heads, hd = self.num_heads, self.dim // self.num_heads
        q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        # a bf16 matmul accumulates in f32 and rounds once on write
        logits = scale_in_dtype(q, hd ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, heads)
        extra = bias.permute(2, 0, 1)[None]                  # [1, H, N, N]
        if mask is not None:
            extra = extra + mask[:, None]                    # [nW, H, N, N]
        n_w = extra.shape[0]
        logits = (logits.reshape(b // n_w, n_w, heads, n, n)
                  + extra[None].to(logits.dtype)).reshape(b, heads, n, n)
        probs = _compact(torch.softmax(logits.float(), dim=-1), x.dtype)
        out = probs.to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        x = F.gelu(x, approximate='tanh' if x.dtype == torch.bfloat16
                   else 'none')
        return self.fc2(x)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws, self.shift = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        """The shifted-window mask on the device, made once per grid."""
        key = (hp, wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shifted_window_mask(
                hp, wp, self.ws, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """x: [B, H*W, C]."""
        ws, shift = self.ws, self.shift
        b, _, c = x.shape
        shortcut = x
        # the grid is padded to whole windows AFTER norm1; the pad tokens
        # are not masked in unshifted windows (they act as the qkv bias)
        x = self.norm1(x).reshape(b, h, w, c)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, x.device)
        x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).transpose(2, 3)
        x = self.attn(x.reshape(-1, ws * ws, c), mask)
        x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).transpose(2, 3)
        x = x.reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        # rows-then-columns order of the reference: (0,0), (1,0), (0,1),
        # (1,1)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinStage(nn.Module):
    """The reference's BasicLayer: blocks, then (except in the last kept
    stage) the patch merging."""

    def __init__(self, dim: int, depth: int, heads: int, window_size: int,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window_size,
                      0 if i % 2 == 0 else window_size // 2)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=EPS)


class SwinEncoder(nn.Module):
    """[4x (128), 8x (256), 16x (512), 16x] for Swin-B."""

    def __init__(self, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18),
                 num_heads: Sequence[int] = (4, 8, 16),
                 window_size: int = 7, patch_size: int = 4):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.layers = nn.ModuleList([
            SwinStage(dim, depth, heads, window_size,
                      downsample=i < len(depths) - 1)
            for i, (dim, depth, heads) in enumerate(zip(dims, depths,
                                                        num_heads))])
        for i, dim in enumerate(dims):
            setattr(self, f'norm{i}', nn.LayerNorm(dim, eps=EPS))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, 3, H, W], padded at the bottom and right to whole
        patches."""
        p = self.patch_size
        x = F.pad(x, (0, (p - x.shape[3] % p) % p, 0, (p - x.shape[2] % p)
                      % p))
        x = self.patch_embed.proj(x)
        b, c, h, w = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = []
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x, h, w)
            out = getattr(self, f'norm{i}')(x)
            outs.append(out.transpose(1, 2).reshape(b, -1, h, w))
            if stage.downsample is not None:
                x = stage.downsample(x, h, w)
                h, w = (h + 1) // 2, (w + 1) // 2
        outs.append(outs[-1])
        return outs
