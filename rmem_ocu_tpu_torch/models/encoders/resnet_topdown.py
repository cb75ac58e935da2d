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

Under spatial sharding (parallel/spatial.py) both passes run on a band of
rows as ResNet's do; the transposed convolutions are banded, and their
maps, whose s (n - 1) - 2p + k rows need not be a stride's ceil(H / s)
(only at H = 1 mod 16 they are), carry their stride and whole rows into
the resizes that follow. The mask and the prompt's similarity are
per pixel. The reconstruction loss sums each band's squares over the
whole map's count and the bands' parts over the model group.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.models.encoders.resnet import ResNetEncoder
from rmem_ocu_tpu_torch.ops.layers import clip, max_pool_3x3_s2
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.layers import reduce_from_model
from rmem_ocu_tpu_torch.parallel.spatial import ConvTranspose2d, Rows


class DecodeBlock(nn.Module):
    """ConvTranspose2d(k, s, p) without bias, then a 1x1 conv (reference
    resnet.py:216-238); returns both."""

    def __init__(self, in_chans: int, out_chans: int, kernel_size: int,
                 stride: int, padding: int = 0):
        super().__init__()
        self.linear = ConvTranspose2d(in_chans, out_chans, kernel_size,
                                      stride, padding, bias=False)
        self.linear2 = nn.Conv2d(out_chans, out_chans, 1, bias=False)

    def forward(self, x: torch.Tensor, at: Optional[Rows] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`at`: the (stride, whole rows) of x's map, of which x is a band
        under spatial sharding."""
        x = self.linear(x, at)
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
            nn.Sequential(ConvTranspose2d(64, 64, 3, 2, 1),
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
                          td: Optional[List[Tuple]] = None):
        """Returns (each stage's input, each stage's output); with `td`
        (each stage's signal and the (stride, whole rows) of its map, None
        without bands) each stage's input has its signal added first
        (in_var keeps the input before it)."""
        in_var, out_var = [], []
        for i, stage in enumerate(self._stages()):
            in_var.append(x)
            if td is not None:
                x = x + _resized(td[i], x)
            x = stage(x)
            out_var.append(x)
        return in_var, out_var

    def _decode(self, depth: int, x: torch.Tensor, at: Optional[Rows]):
        """decoders[depth] on x, a band of the map `at` under spatial
        sharding (else None): (its transposed conv's output, its signal,
        the (stride, whole rows) of their map)."""
        dec = self.decoders[depth]
        if depth == 0:
            up, dec = dec
            x, at = up(x, at), spatial.transposed_rows(up, at)
        y, out = dec(x, at)
        return y, out, spatial.transposed_rows(dec.linear, at)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                var_loss: bool = False):
        """x: [B, 3, H, W]; mask: [B, 1, H, W] float in [0, 1], used when
        the encoder is mask-conditioned. Returns the maps, and with
        `var_loss` (maps, reconstruction loss)."""
        bands = spatial.current()
        # a stage's map (stride, whole rows) under spatial sharding
        rows_of = (lambda t: None if bands is None else
                   (bands.level(t.shape[-1]),
                    bands.whole_rows(bands.level(t.shape[-1]))))
        _, out_var = self._forward_features(x)
        feat = out_var[-1]
        if self.use_mask and mask is not None:
            m = interpolate_bilinear(mask.to(feat.dtype), feat.shape[-2:],
                                     False, bands)
        else:
            xn = feat / (torch.linalg.vector_norm(feat, dim=1, keepdim=True)
                         + 1e-12)
            pn = self.prompt / (torch.linalg.vector_norm(self.prompt)
                                + 1e-12)
            m = clip(torch.einsum('bchw,c->bhw', xn, pn)[:, None], 0.0, 1.0)
        y = torch.einsum('bchw,cd->bdhw', feat * m, self.top_down_transform)
        at = rows_of(y)
        td = []
        for depth in (3, 2, 1, 0):
            y, out, at = self._decode(depth, y, at)
            td.insert(0, (out, at))
        in_var, out_var = self._forward_features(x, td)
        maps = out_var[1:] + [out_var[-1]]
        if not var_loss:
            return maps
        losses = []
        for depth in (3, 2, 1, 0):
            src = out_var[depth].detach()
            recon, _, _ = self._decode(depth, src, rows_of(src))
            target = in_var[depth].detach()
            recon = recon[:, :, :target.shape[2], :target.shape[3]]
            sq = (recon - target.to(recon.dtype)) ** 2
            if bands is None:
                losses.append(sq.mean())
            else:
                # the band's part of the whole map's mean
                count = sq.numel() // sq.shape[2] * rows_of(target)[1]
                losses.append(sq.sum(dtype=torch.promote_types(
                    sq.dtype, torch.float32)) / count)
        if bands is not None:
            losses = reduce_from_model(torch.stack(losses),
                                       bands.world).to(sq.dtype)
        loss = 0.0
        for part in losses:
            loss = loss + part
        return maps, loss


def _resized(td: Tuple, x: torch.Tensor) -> torch.Tensor:
    """A top-down signal (tensor, (stride, whole rows) of its map or None)
    at the size of x, the stage's input (a band under spatial sharding)."""
    sig, at = td
    bands = spatial.current()
    if bands is None:
        return interpolate_bilinear(sig, x.shape[-2:], False)
    s = bands.level(x.shape[-1])
    return interpolate_bilinear(sig, x.shape[-2:], False, bands,
                                (at, (s, bands.whole_rows(s))))
