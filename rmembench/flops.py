"""The operations of one steady step, counted on the reference.

Each family's `step_flops` (`reference/<family>.py`) runs its reference's
step at the cell's shapes, the propagation of a frame against a full bank
and the write of its entries, on the `meta` device (shapes only, no
arithmetic), and `torch.utils.flop_counter.FlopCounterMode` counts every
matrix product and convolution of it. A family whose reference computes
more than a read needs (a windowed read as a masked dense block) counts
that read apart by its own work. The count is of one stream; a step of B
streams does B times as much.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def meta_weights(shapes: Dict[str, Tuple[int, ...]]
                 ) -> Dict[str, torch.Tensor]:
    """Weights of the state_dict's shapes on the `meta` device."""
    meta = torch.device('meta')
    return {k: torch.empty(s, device=meta) for k, s in shapes.items()}


def count(step: Callable[[], object]) -> int:
    """FLOPs of the matrix products and convolutions `step()` runs."""
    counter = FlopCounterMode(display=False)
    with counter:
        step()
    return counter.get_total_flops()
