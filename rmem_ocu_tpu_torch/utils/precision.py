"""Precision helpers (the JAX package's `utils/precision.py`)."""
from __future__ import annotations

from typing import Dict

import torch


def cast_floating(tensors: Dict[str, torch.Tensor], dtype: torch.dtype
                  ) -> Dict[str, torch.Tensor]:
    """Cast every floating tensor of a name -> tensor dict to `dtype`
    (integer tensors stay). The cast is differentiable: gradients reach
    the originals in their own dtype."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tensors.items()}


def compute_dtype_of(exp_cfg) -> torch.dtype:
    return (torch.bfloat16 if exp_cfg.compute_dtype == 'bfloat16'
            else torch.float32)
