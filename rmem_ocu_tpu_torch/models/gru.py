"""ConvGRU memory compression (the optional RMem `gru_memory` path of the
AOT family).

Counterpart of the JAX package's `models/gru.py` (reference
aot_plus/networks/layers/transformer.py:35-118). An evicted memory slot is
folded into logical slot 1 through a small convolutional GRU; the hidden
state is part of the engine state.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.layers import tokens_from_2d, tokens_to_2d


def _same_pad(x: torch.Tensor, kernel_size: Tuple[int, int]) -> torch.Tensor:
    """Zero padding that keeps the map's size under a stride-1 conv, with
    the odd cell after: an even kernel pads (k-1)//2 before and k//2 after
    (2x2: none before, one after), as the JAX package's 'SAME' does."""
    kh, kw = kernel_size
    return F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))


class ConvGRUCell(nn.Module):
    def __init__(self, hidden_dim: int,
                 kernel_size: Tuple[int, int] = (2, 2)):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_gates = nn.Conv2d(2 * hidden_dim, 2 * hidden_dim,
                                    kernel_size)
        self.conv_can = nn.Conv2d(2 * hidden_dim, hidden_dim, kernel_size)

    def forward(self, x2d: torch.Tensor, h2d: torch.Tensor) -> torch.Tensor:
        """x2d, h2d: [B, C, H, W] -> next hidden [B, C, H, W]."""
        gates = self.conv_gates(_same_pad(torch.cat([x2d, h2d], dim=1),
                                          self.kernel_size))
        gamma, beta = gates.chunk(2, dim=1)
        reset, update = torch.sigmoid(gamma), torch.sigmoid(beta)
        cand = torch.tanh(self.conv_can(_same_pad(
            torch.cat([x2d, reset * h2d], dim=1), self.kernel_size)))
        return (1.0 - update) * h2d + update * cand


class ConvGRUCellOutput(nn.Module):
    def __init__(self, dim: int, kernel_size: Tuple[int, int] = (2, 2)):
        super().__init__()
        self.conv_gru_cell = ConvGRUCell(dim, kernel_size)
        self.output_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x_tokens, h_tokens, size_2d: Tuple[int, int]):
        """x, h: [B, HW, C] -> (next hidden tokens, output tokens)."""
        h_next = self.conv_gru_cell(tokens_to_2d(x_tokens, size_2d),
                                    tokens_to_2d(h_tokens, size_2d))
        return tokens_from_2d(h_next), tokens_from_2d(self.output_conv(h_next))
