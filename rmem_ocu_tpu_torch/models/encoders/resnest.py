"""ResNeSt-50/101 backbone (split attention) with frozen BN, output stride
16, stage 4 dropped.

Counterpart of the JAX package's `models/encoders/resnest.py` (reference
aot_plus/networks/encoders/resnest/{resnest,resnet,splat}.py): deep stem,
radix-2 split-attention 3x3 convs, the avd 3x3 average pool in the
strided blocks and the avg-down shortcut. The reference's `dilation=2`
dilates only the dropped stage 4, so every kept stage is undilated, as in
the JAX package. NCHW; the module tree gives the reference torch keys
(`conv1.0/1/3/4/6` for the stem, `downsample.1/2` behind the pool).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.layers import FrozenBatchNorm2d, max_pool_3x3_s2


class SplAtConv2d(nn.Module):
    """Split-attention conv (reference splat.py:15-132) with one cardinal
    group: a conv to radix x channels, the radix splits summed and pooled,
    fc1 -> BN -> ReLU -> fc2, a softmax over the radix, and the splits
    weighted by it."""

    def __init__(self, inp: int, channels: int, stride: int = 1,
                 radix: int = 2, reduction_factor: int = 4):
        super().__init__()
        self.radix, self.channels = radix, channels
        inter = max(channels * radix // reduction_factor, 32)
        self.conv = nn.Conv2d(inp, channels * radix, 3, stride=stride,
                              padding=1, groups=radix, bias=False)
        self.bn0 = FrozenBatchNorm2d(channels * radix)
        self.fc1 = nn.Conv2d(channels, inter, 1)
        self.bn1 = FrozenBatchNorm2d(inter)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.conv(x)))
        splits = torch.split(x, self.channels, dim=1)
        gap = sum(splits).mean(dim=(2, 3), keepdim=True)
        gap = F.relu(self.bn1(self.fc1(gap)))
        b = x.shape[0]
        atten = torch.softmax(self.fc2(gap).reshape(b, self.radix, -1), 1)
        attens = atten.reshape(b, -1, 1, 1).split(self.channels, dim=1)
        return sum(a * s for a, s in zip(attens, splits))


class ResNeStBottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 avd: bool = False, downsample: bool = False):
        super().__init__()
        self.stride, self.avd = stride, avd
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = SplAtConv2d(planes, planes, 1 if avd else stride)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        # avg-down (reference resnest/resnet.py:330-352): odd sizes end in
        # a partial window, averaged over its valid elements
        pool = (nn.AvgPool2d(stride, stride, ceil_mode=True,
                             count_include_pad=False) if stride > 1
                else nn.Identity())
        self.downsample = nn.Sequential(
            pool, nn.Conv2d(inplanes, planes * 4, 1, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.conv2(out)
        if self.avd:
            # count_include_pad, as flax's avg_pool with explicit padding
            out = F.avg_pool2d(out, 3, self.stride, 1)
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNeStEncoder(nn.Module):
    """[4x (256), 8x (512), 16x (1024), 16x]; stem width 32 for ResNeSt-50,
    64 for ResNeSt-101."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6)):
        super().__init__()
        sw = 32 if layers[2] == 6 else 64
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, sw, 3, stride=2, padding=1, bias=False),
            FrozenBatchNorm2d(sw), nn.ReLU(),
            nn.Conv2d(sw, sw, 3, padding=1, bias=False),
            FrozenBatchNorm2d(sw), nn.ReLU(),
            nn.Conv2d(sw, sw * 2, 3, padding=1, bias=False))
        self.bn1 = FrozenBatchNorm2d(sw * 2)
        inplanes = sw * 2
        for stage, (planes, blocks, stride) in enumerate(zip(
                (64, 128, 256), layers, (1, 2, 2))):
            mods = []
            for idx in range(blocks):
                first = idx == 0
                mods.append(ResNeStBottleneck(
                    inplanes, planes, stride=stride if first else 1,
                    avd=first and (stride > 1 or stage > 0),
                    downsample=first and (stride != 1
                                          or inplanes != planes * 4)))
                inplanes = planes * 4
            setattr(self, f'layer{stage + 1}', nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        xs = []
        for layer in (self.layer1, self.layer2, self.layer3):
            x = layer(x)
            xs.append(x)
        xs.append(xs[-1])
        return xs
