"""Bank-masking and eviction-mass helpers of the JAX package's
`models/lstt.py` (the LSTT blocks of the AOT family are not ported yet)."""
from __future__ import annotations

import torch

SLOT_NEG = -1e9


def bank_key_bias(valid: torch.Tensor, hw: int) -> torch.Tensor:
    """[B, 1, 1, T_cap*HW] additive bias masking free physical slots.
    valid: [B, T_cap] bool per physical slot."""
    bias = torch.where(valid, 0.0, SLOT_NEG)
    return bias.repeat_interleave(hw, dim=-1)[:, None, None, :]


def frame_mass_from_probs(probs: torch.Tensor, capacity: int
                          ) -> torch.Tensor:
    """probs: [B, h, HWq, T_cap*HWk] -> mass [B, HWq, T_cap] (mean over
    heads, summed over each slot's keys; reference transformer.py:636-643).
    """
    b, h, q, tk = probs.shape
    m = probs.reshape(b, h, q, capacity, tk // capacity).float()
    return m.mean(dim=1).sum(dim=-1)
