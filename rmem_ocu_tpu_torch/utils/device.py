"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The card by default. `device=None` means CUDA and raises when no GPU
    is present; the CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'rmem_ocu_tpu_torch runs on a CUDA device by default and '
                'none is available; pass device="cpu" to run on the CPU')
        return torch.device('cuda')
    return torch.device(device)
