"""Encoder factory (reference aot_plus/networks/encoders/__init__.py:10-37).

Encoders take NCHW images and return the multi-scale list
[4x, 8x, 16x, 16x] (the last stage dropped, 16x twice). The names are the
JAX package's; only the TopDown encoder takes `use_mask`. `frozen_bn=False`
builds the trainable BatchNorm2d in place of the frozen one (Swin has
LayerNorms only).
"""
from __future__ import annotations

from torch import nn


def build_encoder(name: str, use_mask: bool = False,
                  frozen_bn: bool = True) -> nn.Module:
    if name == 'mobilenetv2':
        from rmem_ocu_tpu_torch.models.encoders.mobilenetv2 import (
            MobileNetV2Encoder)
        return MobileNetV2Encoder(frozen_bn=frozen_bn)
    if name == 'mobilenetv3':
        from rmem_ocu_tpu_torch.models.encoders.mobilenetv3 import (
            MobileNetV3Encoder)
        return MobileNetV3Encoder(frozen_bn=frozen_bn)
    if 'resnet50_topdown' in name:
        from rmem_ocu_tpu_torch.models.encoders.resnet_topdown import (
            ResNetTopDownEncoder)
        return ResNetTopDownEncoder((3, 4, 6), use_mask=use_mask,
                                    frozen_bn=frozen_bn)
    if name in ('resnet50', 'resnet101'):
        from rmem_ocu_tpu_torch.models.encoders.resnet import ResNetEncoder
        return ResNetEncoder((3, 4, 6) if name == 'resnet50'
                             else (3, 4, 23), frozen_bn)
    if name == 'swin_base':
        from rmem_ocu_tpu_torch.models.encoders.swin import SwinEncoder
        return SwinEncoder()
    if name.startswith('resnest'):
        from rmem_ocu_tpu_torch.models.encoders.resnest import ResNeStEncoder
        return ResNeStEncoder((3, 4, 23) if '101' in name else (3, 4, 6),
                              frozen_bn)
    raise NotImplementedError(f'unknown encoder {name}')
