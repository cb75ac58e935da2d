"""Palette PNG I/O of id masks.

The framework-free half of the JAX package's `ops/masks.py` (reference
aot_plus/utils/image.py:58-105): the VOS palette, the palette PNG writer
and reader the evaluator and scorer use, and the VOC-style colormap.
"""
from __future__ import annotations

import numpy as np

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
