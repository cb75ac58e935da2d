"""ResNet-50 TopDown: a two-pass encoder with transposed-conv feedback.

Counterpart of the JAX package's `models/encoders/resnet_topdown.py`
(reference aot_plus/networks/encoders/resnet.py:216-356, the
`r50_topdown_aotl` model). The first pass computes the 16x feature; a mask
modulates it (the similarity to a learned `prompt`, clipped to [0, 1], or,
mask-conditioned, the given mask resized to the 16x grid); it is mapped by
`top_down_transform`, and four feedback decoders turn it into one
top-down signal per stage, which the second pass adds to each stage's
input (resized where the shapes differ). NCHW.

The per-stage reconstruction loss ("var loss", reference :345-356) is a
training output: `forward(..., var_loss=True)` returns it beside the maps;
inference does not compute it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.models.encoders.resnet import ResNetEncoder
from rmem_ocu_tpu_torch.ops.layers import clip, max_pool_3x3_s2
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear


class DecodeBlock(nn.Module):
    """ConvTranspose2d(k, s, p) without bias, then a 1x1 conv (reference
    resnet.py:216-238); returns both."""

    def __init__(self, in_chans: int, out_chans: int, kernel_size: int,
                 stride: int, padding: int = 0):
        super().__init__()
        self.linear = nn.ConvTranspose2d(in_chans, out_chans, kernel_size,
                                         stride, padding, bias=False)
        self.linear2 = nn.Conv2d(out_chans, out_chans, 1, bias=False)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.linear(x)
        return x, self.linear2(x)


class ResNetTopDownEncoder(ResNetEncoder):
    """[4x (256), 8x (512), 16x (1024), 16x] of the second pass."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6),
                 use_mask: bool = False, frozen_bn: bool = True):
        super().__init__(layers, frozen_bn)
        self.use_mask = use_mask
        # decoders[d] inverts stage d (the stem for d = 0: its max pool,
        # then its conv) (reference :271-284)
        self.decoders = nn.ModuleList([
            nn.Sequential(nn.ConvTranspose2d(64, 64, 3, 2, 1),
                          DecodeBlock(64, 3, 7, 2, 3)),
            DecodeBlock(256, 64, 3, 1, 1),
            DecodeBlock(512, 256, 3, 2, 1),
            DecodeBlock(1024, 512, 3, 2, 1)])
        self.prompt = nn.Parameter(torch.zeros(1024))
        self.top_down_transform = nn.Parameter(torch.eye(1024))

    def _stages(self):
        return (lambda x: max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x)))),
                self.layer1, self.layer2, self.layer3)

    def _forward_features(self, x: torch.Tensor,
                          td: Optional[List[torch.Tensor]] = None):
        """Returns (each stage's input, each stage's output); with `td`
        each stage's input has its top-down signal added first (in_var
        keeps the input before it)."""
        in_var, out_var = [], []
        for i, stage in enumerate(self._stages()):
            in_var.append(x)
            if td is not None:
                x = x + interpolate_bilinear(td[i], x.shape[-2:], False)
            x = stage(x)
            out_var.append(x)
        return in_var, out_var

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                var_loss: bool = False):
        """x: [B, 3, H, W]; mask: [B, 1, H, W] float in [0, 1], used when
        the encoder is mask-conditioned. Returns the maps, and with
        `var_loss` (maps, reconstruction loss)."""
        _, out_var = self._forward_features(x)
        feat = out_var[-1]
        if self.use_mask and mask is not None:
            m = interpolate_bilinear(mask.to(feat.dtype), feat.shape[-2:],
                                     False)
        else:
            xn = feat / (torch.linalg.vector_norm(feat, dim=1, keepdim=True)
                         + 1e-12)
            pn = self.prompt / (torch.linalg.vector_norm(self.prompt)
                                + 1e-12)
            m = clip(torch.einsum('bchw,c->bhw', xn, pn)[:, None], 0.0, 1.0)
        y = torch.einsum('bchw,cd->bdhw', feat * m, self.top_down_transform)
        td = []
        for depth in (3, 2, 1, 0):
            y, out = self.decoders[depth](y)
            td.insert(0, out)
        in_var, out_var = self._forward_features(x, td)
        maps = out_var[1:] + [out_var[-1]]
        if not var_loss:
            return maps
        loss = 0.0
        for depth in (3, 2, 1, 0):
            recon, _ = self.decoders[depth](out_var[depth].detach())
            target = in_var[depth].detach()
            recon = recon[:, :, :target.shape[2], :target.shape[3]]
            loss = loss + ((recon - target.to(recon.dtype)) ** 2).mean()
        return maps, loss
