"""Metric meters (reference aot_plus/utils/meters.py:4-31)."""
from __future__ import annotations


class AverageMeter:
    """Running average with an optional momentum moving average."""

    def __init__(self, momentum: float = 0.0):
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.moving_avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        if self.momentum > 0:
            if self.count == n:
                self.moving_avg = val
            else:
                self.moving_avg = (self.momentum * self.moving_avg
                                   + (1 - self.momentum) * val)
