"""MobileNetV3-Large backbone with frozen BN, output stride 16.

Counterpart of the JAX package's `models/encoders/mobilenetv3.py`
(reference aot_plus/networks/encoders/mobilenetv3.py:1-239). NCHW. The
module tree is the reference's: `features.0` the stem, `features.1-15` the
blocks, each a `.conv` Sequential whose indices depend on whether the
block expands (with: pw, bn, act, dw, bn, SE, act, pw-linear, bn; without:
dw, bn, act, SE, pw-linear, bn), and `conv` the last 1x1 conv.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.models.encoders.mobilenetv2 import make_divisible
from rmem_ocu_tpu_torch.ops.layers import FrozenBatchNorm2d


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * h_sigmoid(x)


class HSigmoid(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return h_sigmoid(x)


class SELayer(nn.Module):
    """Squeeze-excite: global mean -> fc, ReLU, fc, h_sigmoid -> scale."""

    def __init__(self, channel: int, reduction: int = 4):
        super().__init__()
        mid = make_divisible(channel // reduction)
        self.fc = nn.Sequential(nn.Linear(channel, mid), nn.ReLU(),
                                nn.Linear(mid, channel), HSigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class MBV3Block(nn.Module):
    def __init__(self, inp: int, hidden: int, oup: int, kernel: int,
                 stride: int, dilation: int, use_se: bool, use_hs: bool):
        super().__init__()
        self.act = h_swish if use_hs else F.relu
        self.identity = stride == 1 and inp == oup
        self.expand = inp != hidden
        pad = (kernel - 1) // 2 * dilation
        dw = nn.Conv2d(hidden, hidden, kernel, stride=stride, padding=pad,
                       dilation=dilation, groups=hidden, bias=False)
        se = SELayer(hidden) if use_se else nn.Identity()
        tail = [nn.Conv2d(hidden, oup, 1, bias=False), FrozenBatchNorm2d(oup)]
        # nn.Identity stands where the reference has an activation module
        if self.expand:
            layers = [nn.Conv2d(inp, hidden, 1, bias=False),
                      FrozenBatchNorm2d(hidden), nn.Identity(), dw,
                      FrozenBatchNorm2d(hidden), se, nn.Identity()] + tail
        else:
            layers = [dw, FrozenBatchNorm2d(hidden), nn.Identity(), se] + tail
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if self.expand:
            out = self.act(c[1](c[0](x)))
            out = self.act(c[5](c[4](c[3](out))))
        else:
            # the JAX package's order: SE before the activation (no block
            # without expansion has SE, so the reference's order agrees)
            out = self.act(c[3](c[1](c[0](x))))
        out = c[-1](c[-2](out))
        return x + out if self.identity else out


# k, t (expansion), c, SE, HS, s  (MobileNetV3-Large)
_CFGS = (
    (3, 1, 16, 0, 0, 1),
    (3, 4, 24, 0, 0, 2),
    (3, 3, 24, 0, 0, 1),
    (5, 3, 40, 1, 0, 2),
    (5, 3, 40, 1, 0, 1),
    (5, 3, 40, 1, 0, 1),
    (3, 6, 80, 0, 1, 2),
    (3, 2.5, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (5, 6, 160, 1, 1, 2),
    (5, 6, 160, 1, 1, 1),
    (5, 6, 160, 1, 1, 1),
)


class MobileNetV3Encoder(nn.Module):
    """[4x (24), 8x (40), 16x (112), 16x (960)]."""

    def __init__(self, output_stride: int = 16, width_mult: float = 1.0):
        super().__init__()
        input_channel = make_divisible(16 * width_mult)
        features = [nn.Sequential(
            nn.Conv2d(3, input_channel, 3, stride=2, padding=1, bias=False),
            FrozenBatchNorm2d(input_channel))]
        current_stride, rate = 2, 1
        for k, t, c, use_se, use_hs, s in _CFGS:
            if current_stride == output_stride:
                stride, dilation = 1, rate
                rate *= s
            else:
                stride, dilation = s, 1
                current_stride *= s
            out_ch = make_divisible(c * width_mult)
            features.append(MBV3Block(
                input_channel, make_divisible(input_channel * t), out_ch, k,
                stride, dilation, bool(use_se), bool(use_hs)))
            input_channel = out_ch
        self.features = nn.Sequential(*features)
        last = make_divisible(input_channel * 6)
        self.conv = nn.Sequential(nn.Conv2d(input_channel, last, 1,
                                            bias=False),
                                  FrozenBatchNorm2d(last))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, 3, H, W]; 4x after block 2, 8x after block 5, 16x after
        block 11, and the last conv."""
        x = h_swish(self.features[0](x))
        feats = []
        for block in self.features[1:]:
            x = block(x)
            feats.append(x)
        return [feats[2], feats[5], feats[11], h_swish(self.conv(x))]
