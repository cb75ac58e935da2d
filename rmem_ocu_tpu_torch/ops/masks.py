"""Id masks: one-hot encoding, the training's id shuffle, palette PNG I/O.

Counterpart of the JAX package's `ops/masks.py` (reference
aot_plus/utils/image.py:58-105, utils/math.py:4-14): the one-hot mask with
its ignore channel and the identity shuffle that training applies, the VOS
palette, the palette PNG writer and reader the evaluator and scorer use,
and the VOC-style colormap.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# DAVIS/VOS palette: the first 22 entries are the canonical VOS colours,
# the rest grey, the reference's layout, so that written PNGs decode to the
# same palette the scorer expects
_BASE_COLORS = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (191, 0, 0),
    (64, 128, 0), (191, 128, 0), (64, 0, 128), (191, 0, 128), (64, 128, 128),
    (191, 128, 128), (0, 64, 0), (128, 64, 0), (0, 191, 0), (128, 191, 0),
    (0, 64, 128), (128, 64, 128),
]
VOS_PALETTE = []
for _c in _BASE_COLORS:
    VOS_PALETTE.extend(_c)
for _g in range(22, 256):
    VOS_PALETTE.extend((_g, _g, _g))


def save_mask_png(mask: np.ndarray, path: str, squeeze_idx=None):
    """Save an id mask as a palette PNG (reference utils/image.py:90-100).
    `squeeze_idx` maps the evaluator's contiguous ids back to the
    dataset's object ids: id i is written as squeeze_idx[i]."""
    from PIL import Image
    mask = np.asarray(mask).astype(np.uint8)
    if squeeze_idx is not None:
        unsqueezed = np.zeros_like(mask)
        for idx in range(1, len(squeeze_idx)):
            unsqueezed[mask == idx] = squeeze_idx[idx]
        mask = unsqueezed
    im = Image.fromarray(mask).convert('P')
    im.putpalette(VOS_PALETTE)
    im.save(path)


def read_mask_png(path: str) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(path))


def label2colormap(label: np.ndarray) -> np.ndarray:
    """Id mask [H, W] -> RGB uint8 colormap (reference utils/image.py:58-66,
    the bit-shuffled VOC-style map)."""
    m = np.asarray(label).astype(np.uint8)
    cmap = np.zeros(m.shape + (3,), dtype=np.uint8)
    cmap[..., 0] = (m & 1) << 7 | (m & 8) << 3 | (m & 64) >> 1
    cmap[..., 1] = (m & 2) << 6 | (m & 16) << 2 | (m & 128) >> 2
    cmap[..., 2] = (m & 4) << 5 | (m & 32) << 1
    return cmap


def one_hot_mask(mask: torch.Tensor, cls_num: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask: int [B, H, W] or [B, H, W, 1] -> (one_hot [B, H, W,
    cls_num + 1] f32, ignore [B, H, W, 1] f32). Label 255 marks ignored
    pixels; labels above cls_num get an all-zero one-hot (reference
    utils/image.py:69-74)."""
    if mask.dim() == 4:
        mask = mask[..., 0]
    mask = mask.long()
    ids = torch.arange(cls_num + 1, device=mask.device)
    one_hot = (mask[..., None] == ids).float()
    ignore = (mask == 255).float()[..., None]
    return one_hot, ignore


def generate_permute_matrix(dim: int, batch: int,
                            generator: torch.Generator,
                            device=None) -> torch.Tensor:
    """A random permutation of the foreground ids per sample (id 0 stays):
    [B, dim, dim] f32 with matrix[b, i, j] = 1 where id i maps to slot j,
    the identity's rows permuted (reference utils/math.py:4-14). The
    permutations are drawn from `generator`, on its device."""
    eye = torch.eye(dim)
    mats = []
    for _ in range(batch):
        fg = torch.randperm(dim - 1, generator=generator) + 1
        mats.append(eye[torch.cat([torch.zeros(1, dtype=torch.long), fg])])
    return torch.stack(mats).to(device)


def shuffle_one_hot(one_hot: torch.Tensor, perm: torch.Tensor
                    ) -> torch.Tensor:
    """The identity shuffle: [B, H, W, O] x [B, O, T] -> [B, H, W, T]
    (reference engines/aot_engine.py:219-222), in one_hot's dtype."""
    return torch.einsum('bhwo,bot->bhwt', one_hot, perm.to(one_hot.dtype))


def unshuffle_logits(logits: torch.Tensor, perm: torch.Tensor
                     ) -> torch.Tensor:
    """The reverse shuffle on logits [B, H, W, T] (reference
    engines/aot_engine.py:445-448), in the logits' dtype."""
    return torch.einsum('bhwo,bto->bhwt', logits, perm.to(logits.dtype))
