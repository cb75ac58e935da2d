"""The one traffic generator: synthetic video clips from a traffic file.

A traffic file (`rmembench/traffic/<name>.json`) gives the streams, the
source resolution and the eval protocol's resize (so that the input size
follows each model's corner convention, as the eval protocol resizes VOST
and DAVIS), the number of objects, the long-term write gap, the frames of
set-up that fill the bank, the size of each stream's frame pool, the
streams the reference checks and the steps a traced run profiles.

Each stream is one clip made on the device from the seed: `objects`
textured blobs that move, turn and deform over a textured background,
the first frame's label map holding each of them apart. The pool of
`pool_frames` frames is normalised as the eval protocol normalises images
and staged in pinned host memory as [frame, stream, H, W, 3] float32, so
that one step copies one contiguous batch; streams play it forward and
back (frame t shows pool frame `ping_pong(t)`).
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TEXTURE = 32            # texels a side of each object's texture


def load(root: Path, name: str) -> dict:
    return json.loads((root / 'rmembench' / 'traffic' / f'{name}.json')
                      .read_text())


def restrict_size(h: int, w: int, max_size: float, align_corners: bool,
                  stride: int = 16) -> Tuple[int, int]:
    """The eval protocol's input size for an (h, w) frame: the long side
    cut to max_size, then each side rounded to a multiple of the stride
    (plus one with align_corners)."""
    long = max(h, w)
    sc = max_size / long if long > max_size else 1.0
    nh, nw = int(sc * h), int(sc * w)
    off = 1 if align_corners else 0
    if (nh - off) % stride:
        nh = int(np.around((nh - off) / stride) * stride + off)
    if (nw - off) % stride:
        nw = int(np.around((nw - off) / stride) * stride + off)
    return nh, nw


def input_size(traffic: dict, align_corners: bool) -> Tuple[int, int]:
    return restrict_size(traffic['source_height'], traffic['source_width'],
                         traffic['max_size'], align_corners)


def ping_pong(t: int, n: int) -> int:
    """The pool frame shown at frame t: 0, 1, ..., n-1, n-2, ..., 1, 0, ..."""
    p = t % (2 * n - 2)
    return p if p < n else 2 * n - 2 - p


class Clips:
    """The pool of every stream ([F, B, H, W, 3] pinned float32 on a card,
    plain host memory on the CPU) and the reference frame's labels [B, H, W]
    (int64, on the device)."""

    def __init__(self, traffic: dict, size: Tuple[int, int], seed: int,
                 device: torch.device):
        b, n_obj = traffic['streams'], traffic['objects']
        h, w = size
        self.size, self.n_frames = size, traffic['pool_frames']
        g = torch.Generator(device=device).manual_seed(seed)
        dev = dict(device=device)

        def rnd(*shape):
            return torch.rand(shape, generator=g, **dev)
        # the background: a smooth colour field and a fine texture
        self._bg = (0.2 + 0.6 * F.interpolate(rnd(b, 3, 6, 10), size=size,
                                              mode='bicubic',
                                              align_corners=False)
                    + 0.3 * (F.interpolate(rnd(b, 1, max(h // 6, 2),
                                               max(w // 6, 2)), size=size,
                                           mode='bilinear',
                                           align_corners=False) - 0.5))
        # objects: spread across the frame at the start, each with its own
        # radius, path, turn, deformation and texture
        k = torch.arange(n_obj, **dev).float()
        slot = (k + 0.5) / n_obj
        self._c0 = torch.stack([
            (0.5 + 0.4 * (rnd(b, n_obj) - 0.5)) * h,
            (slot + 0.06 * (rnd(b, n_obj) - 0.5)) * w], dim=-1)
        self._r0 = torch.minimum(
            (0.06 + 0.03 * rnd(b, n_obj)) * w, torch.full((), 0.3 * h, **dev))
        self._path = torch.stack([0.08 * h * (0.5 + rnd(b, n_obj)),
                                  0.08 * w * (0.5 + rnd(b, n_obj))], -1)
        self._freq = 2 * math.pi / self.n_frames * (0.5 + rnd(b, n_obj, 2))
        self._phase = 2 * math.pi * rnd(b, n_obj, 4)
        self._turn = 0.1 * (rnd(b, n_obj) - 0.5)
        self._wobble = 0.05 + 0.1 * rnd(b, n_obj, 2)
        self._tex = (0.15 + 0.7 * rnd(b * n_obj, 3, 1, 1)
                     + 0.25 * (rnd(b * n_obj, 3, TEXTURE, TEXTURE) - 0.5))
        cuda = torch.device(device).type == 'cuda'
        self.pool = torch.empty((self.n_frames, b, h, w, 3),
                                pin_memory=cuda)
        for t in range(self.n_frames):
            img, label = self.frame(t)
            self.pool[t].copy_(img)
            if t == 0:
                self.label0 = label
        del self._bg, self._tex

    def frame(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pool frame t: (normalised image [B, H, W, 3], label [B, H, W])."""
        b, n_obj = self._r0.shape
        h, w = self.size
        dev = self._r0.device
        yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, h, 1)
        xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, w)
        ph = self._phase
        cy = (self._c0[..., 0] + self._path[..., 0]
              * torch.sin(self._freq[..., 0] * t + ph[..., 0]))
        cx = (self._c0[..., 1] + self._path[..., 1]
              * torch.sin(self._freq[..., 1] * t + ph[..., 1]))
        dy = yy - cy[..., None, None]                      # [B, K, H, W]
        dx = xx - cx[..., None, None]
        turn = (self._turn * t)[..., None, None]
        theta = torch.atan2(dy, dx) - turn
        r0 = self._r0[..., None, None]
        wob = self._wobble[..., None, None]
        # the outline: a circle bent by a second and a third harmonic
        # whose phases drift with time
        rho = r0 * (1 + wob[..., 0, :, :] * torch.sin(
            2 * theta + ph[..., 2:3, None] + 0.3 * t)
            + wob[..., 1, :, :] * torch.cos(
                3 * theta + ph[..., 3:4, None] - 0.2 * t))
        inside = dx * dx + dy * dy < rho * rho
        # the texture turns with its object
        cos, sin = torch.cos(turn), torch.sin(turn)
        u = (dx * cos + dy * sin) / (1.5 * r0)
        v = (-dx * sin + dy * cos) / (1.5 * r0)
        grid = torch.stack([u, v], -1).reshape(b * n_obj, h, w, 2)
        tex = F.grid_sample(self._tex, grid, mode='bilinear',
                            padding_mode='reflection', align_corners=False)
        tex = tex.reshape(b, n_obj, 3, h, w)
        img = self._bg.clone()
        label = torch.zeros((b, h, w), dtype=torch.long, device=dev)
        for k in range(n_obj):
            m = inside[:, k]
            img = torch.where(m[:, None], tex[:, k], img)
            label = torch.where(m, k + 1, label)
        mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
        img = (img.clamp(0.0, 1.0) - mean) / std
        return img.permute(0, 2, 3, 1).contiguous(), label
