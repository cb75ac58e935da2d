"""Encoder factory (reference aot_plus/networks/encoders/__init__.py).

Encoders take NCHW images and return the multi-scale list
[4x, 8x, 16x, 16x]. Only ResNet-50 is ported so far.
"""
from __future__ import annotations

from torch import nn


def build_encoder(name: str) -> nn.Module:
    from rmem_ocu_tpu_torch.models.encoders.resnet import ResNetEncoder
    if name == 'resnet50':
        return ResNetEncoder(layers=(3, 4, 6))
    raise NotImplementedError(f'encoder {name!r} is not ported yet')
