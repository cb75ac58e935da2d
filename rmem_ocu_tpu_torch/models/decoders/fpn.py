"""FPN segmentation head (reference aot_plus/networks/decoders/fpn.py:7-73).

NCHW. DeAOT decodes only the last GPM output (decode_intermediate_input is
False), so the head takes that one map.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.layers import ConvGN
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear


class FPNSegmentationHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 shortcut_dims: Sequence[int], hidden_dim: int = 256,
                 align_corners: bool = True):
        super().__init__()
        self.align_corners = align_corners
        self.conv_in = ConvGN(in_dim, hidden_dim, 1)
        self.conv_16x = ConvGN(hidden_dim, hidden_dim, 3)
        self.conv_8x = ConvGN(hidden_dim, hidden_dim // 2, 3)
        self.conv_4x = ConvGN(hidden_dim // 2, hidden_dim // 2, 3)
        self.adapter_16x = nn.Conv2d(shortcut_dims[-2], hidden_dim, 1)
        self.adapter_8x = nn.Conv2d(shortcut_dims[-3], hidden_dim, 1)
        self.adapter_4x = nn.Conv2d(shortcut_dims[-4], hidden_dim // 2, 1)
        self.conv_out = nn.Conv2d(hidden_dim // 2, out_dim, 1)

    def forward(self, x: torch.Tensor, shortcuts: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        """x: [B, C, H16, W16]; shortcuts: encoder maps [4x, 8x, 16x, 16x].
        Returns logits [B, out_dim, H4, W4]."""
        x = F.relu(self.conv_in(x))
        x = F.relu(self.conv_16x(self.adapter_16x(shortcuts[-2]) + x))
        x = interpolate_bilinear(x, shortcuts[-3].shape[-2:],
                                 self.align_corners)
        x = F.relu(self.conv_8x(self.adapter_8x(shortcuts[-3]) + x))
        x = interpolate_bilinear(x, shortcuts[-4].shape[-2:],
                                 self.align_corners)
        x = F.relu(self.conv_4x(self.adapter_4x(shortcuts[-4]) + x))
        return self.conv_out(x)
