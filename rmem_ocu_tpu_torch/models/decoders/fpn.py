"""FPN segmentation head (reference aot_plus/networks/decoders/fpn.py:7-73).

NCHW. With decode_intermediate_input (the AOT family) the head takes the
16x encoder map and every LSTT layer's output, concatenated; without it
(DeAOT) only the last map. Under spatial sharding (parallel/spatial.py)
its inputs and shortcuts are bands of rows: the 3x3 convolutions take
halos, the GroupNorms the whole map's moments and the upsamples their
band's rows.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.layers import ConvGN
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
from rmem_ocu_tpu_torch.parallel import spatial


class FPNSegmentationHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 shortcut_dims: Sequence[int], hidden_dim: int = 256,
                 decode_intermediate_input: bool = True,
                 align_corners: bool = True):
        super().__init__()
        self.decode_intermediate_input = decode_intermediate_input
        self.align_corners = align_corners
        self.conv_in = ConvGN(in_dim, hidden_dim, 1)
        self.conv_16x = ConvGN(hidden_dim, hidden_dim, 3)
        self.conv_8x = ConvGN(hidden_dim, hidden_dim // 2, 3)
        self.conv_4x = ConvGN(hidden_dim // 2, hidden_dim // 2, 3)
        self.adapter_16x = nn.Conv2d(shortcut_dims[-2], hidden_dim, 1)
        self.adapter_8x = nn.Conv2d(shortcut_dims[-3], hidden_dim, 1)
        self.adapter_4x = nn.Conv2d(shortcut_dims[-4], hidden_dim // 2, 1)
        self.conv_out = nn.Conv2d(hidden_dim // 2, out_dim, 1)

    def forward(self, inputs: Sequence[torch.Tensor],
                shortcuts: Sequence[torch.Tensor]) -> torch.Tensor:
        """inputs: [B, C_i, H16, W16] decoder inputs (the 16x encoder map
        and the per-layer LSTT outputs), in_dim channels together or in the
        last one; shortcuts: encoder maps [4x, 8x, 16x, 16x]. Returns
        logits [B, out_dim, H4, W4]."""
        bands = spatial.current()
        x = (torch.cat(list(inputs), dim=1) if self.decode_intermediate_input
             else inputs[-1])
        x = F.relu(self.conv_in(x))
        x = F.relu(self.conv_16x(self.adapter_16x(shortcuts[-2]) + x))
        x = interpolate_bilinear(x, shortcuts[-3].shape[-2:],
                                 self.align_corners, bands)
        x = F.relu(self.conv_8x(self.adapter_8x(shortcuts[-3]) + x))
        x = interpolate_bilinear(x, shortcuts[-4].shape[-2:],
                                 self.align_corners, bands)
        x = F.relu(self.conv_4x(self.adapter_4x(shortcuts[-4]) + x))
        return self.conv_out(x)
