"""ResNet-50/101 backbone, output stride 16, stage 5 dropped; frozen BN
unless freeze_bn is off.

Counterpart of the JAX package's `models/encoders/resnet.py` (reference
aot_plus/networks/encoders/resnet.py:10-213). NCHW. The stem is a plain
7x7/s2 conv (the JAX package's space-to-depth form exists only for the
TPU's matrix unit). Its 3x3 and 7x7 convolutions and its max pool run
on a band of rows under spatial sharding (parallel/spatial.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.layers import make_bn, max_pool_3x3_s2
from rmem_ocu_tpu_torch.parallel.spatial import Conv2d


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 frozen_bn: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = make_bn(planes, frozen_bn)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = make_bn(planes, frozen_bn)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = make_bn(planes * 4, frozen_bn)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetEncoder(nn.Module):
    """Stages 1-3 at strides 4, 8, 16 (output stride 16, no dilation)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6),
                 frozen_bn: bool = True):
        """layers: blocks per stage, (3, 4, 6) for ResNet-50, (3, 4, 23)
        for ResNet-101."""
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = make_bn(64, frozen_bn)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(zip(
                (64, 128, 256), layers, (1, 2, 2))):
            mods = []
            for idx in range(blocks):
                downsample = None
                if idx == 0 and (stride != 1 or inplanes != planes * 4):
                    downsample = nn.Sequential(
                        nn.Conv2d(inplanes, planes * 4, 1, stride=stride,
                                  bias=False),
                        make_bn(planes * 4, frozen_bn))
                mods.append(Bottleneck(inplanes, planes,
                                       stride=stride if idx == 0 else 1,
                                       downsample=downsample,
                                       frozen_bn=frozen_bn))
                inplanes = planes * 4
            setattr(self, f'layer{stage + 1}', nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, 3, H, W] -> [4x (256), 8x (512), 16x (1024), 16x]."""
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        xs = []
        for layer in (self.layer1, self.layer2, self.layer3):
            x = layer(x)
            xs.append(x)
        xs.append(xs[-1])     # stage 5 dropped, 16x duplicated
        return xs
