"""MobileNetV2 backbone with frozen BN, output stride 16 by dilation.

Counterpart of the JAX package's `models/encoders/mobilenetv2.py`
(reference aot_plus/networks/encoders/mobilenetv2.py:63-247). NCHW. The
module tree is the reference's (`features.N`, each inverted residual's
`.conv` Sequential), so its state_dict keys are the reference torch keys.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from rmem_ocu_tpu_torch.ops.layers import FrozenBatchNorm2d


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ReLU6(nn.Module):
    """clip(x, 0, 6), as the JAX package writes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(0.0, 6.0)


def conv_bn_relu(inp: int, out: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, dilation: int = 1) -> nn.Sequential:
    """Conv (no bias) -> frozen BN -> ReLU6 (reference ConvBNReLU)."""
    pad = (kernel - 1) // 2 * dilation
    return nn.Sequential(
        nn.Conv2d(inp, out, kernel, stride=stride, padding=pad,
                  dilation=dilation, groups=groups, bias=False),
        FrozenBatchNorm2d(out), ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, dilation: int,
                 expand_ratio: int):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(conv_bn_relu(inp, hidden, kernel=1))
        layers += [conv_bn_relu(hidden, hidden, stride=stride,
                                dilation=dilation, groups=hidden),
                   nn.Conv2d(hidden, oup, 1, bias=False),
                   FrozenBatchNorm2d(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return x + out if self.use_res else out


# t (expand), c (channels), n (repeats), s (stride)
_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2Encoder(nn.Module):
    """[4x (24), 8x (32), 16x (96), 16x (1280)]; past stride 16 the
    strides become dilations."""

    def __init__(self, output_stride: int = 16, width_mult: float = 1.0):
        super().__init__()
        input_channel = make_divisible(32 * width_mult)
        last_channel = make_divisible(1280 * max(1.0, width_mult))
        features = [conv_bn_relu(3, input_channel, stride=2)]
        current_stride, rate = 2, 1
        for t, c, n, s in _SETTING:
            if current_stride == output_stride:
                stride, dilation = 1, rate
                rate *= s
            else:
                stride, dilation = s, 1
                current_stride *= s
            out_ch = make_divisible(c * width_mult)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_ch, stride if i == 0 else 1,
                    dilation if i == 0 else rate, t))
                input_channel = out_ch
        features.append(conv_bn_relu(input_channel, last_channel, kernel=1))
        self.features = nn.Sequential(*features)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, 3, H, W]. The stage split is the reference's
        (mobilenetv2.py:210-215): features 0-3, 4-6, 7-13, 14-18."""
        feats = []
        for layer in self.features:
            x = layer(x)
            feats.append(x)
        return [feats[3], feats[6], feats[13], feats[-1]]
