"""The least time a kernel call could take on the card, from the operations
and bytes its shapes need, and the published peaks.

Copied from the roofline arithmetic of the measured package's smoke
script (`chip_smoke.py`: `bound_ms` and the operations and bytes of its
B1 and B2 rows), so that the yardstick cannot move with the program.
Each input byte is counted read once and each output byte written once.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# one NVIDIA H100 SXM, dense rates (data sheet), at a 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
BYTES = {'bfloat16': 2, 'float32': 4}


def bound_s(n_bytes: float, n_flops: float, dtype: str) -> Tuple[float, str]:
    """(least seconds, what bounds it: 'bytes' or 'operations')."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def b1_work(batch: int, hw: int, n_live: int, t_cap: int, d: int,
            cvs: Sequence[int], heads: int = 1, dtype: str = 'bfloat16'
            ) -> Tuple[float, float]:
    """(bytes, operations) of one bank read (kernel B1): hw queries of
    width heads*d against n_live live frames of hw keys, the values of
    widths cvs (V and ID_V), the temporal PE, and the slot mask and
    per-slot mass of t_cap slots."""
    e = BYTES[dtype]
    cv = sum(cvs)
    n_bytes = batch * (e * heads * (hw * d + n_live * hw * d + n_live * d
                                    + n_live * hw * cv + hw * cv)
                       + 4 * t_cap + 4 * hw * t_cap)
    n_flops = 2 * batch * heads * hw * n_live * (hw * (d + cv) + d)
    return n_bytes, n_flops


def b2_work(batch: int, grid: Tuple[int, int], d: int, e_dim: int,
            max_dis: int = 7, dtype: str = 'bfloat16'
            ) -> Tuple[float, float]:
    """(bytes, operations) of one short-term read (kernel B2): each query
    of the grid against the keys of its (2*max_dis+1)^2 window inside the
    image, value width e_dim, with the f32 relative bias."""
    h, w = grid
    hw, ws2 = h * w, (2 * max_dis + 1) ** 2
    qy, qx = np.divmod(np.arange(hw), w)
    rows = np.minimum(qy + max_dis, h - 1) - np.maximum(qy - max_dis, 0) + 1
    cols = np.minimum(qx + max_dis, w - 1) - np.maximum(qx - max_dis, 0) + 1
    n_pairs = int((rows * cols).sum())
    e = BYTES[dtype]
    n_bytes = batch * (e * (2 * hw * d + 2 * hw * e_dim) + 4 * hw * ws2)
    n_flops = 2 * batch * n_pairs * (d + e_dim)
    return n_bytes, n_flops


def share(run, group: str):
    """A kernel group's share of its roofline in a traced step, %: the
    least time of its calls (the family's `kernel_work`: bytes, operations
    and calls a step at the cell's shapes, against the published peaks)
    over the group's device time in the census. None where the census
    holds no time for the group or the family launches no such group."""
    if run.census is None or not run.census['groups'].get(group):
        return None
    work = run.kernel_work().get(group)
    if work is None:
        return None
    n_bytes, n_flops, calls = work
    least_s = bound_s(n_bytes, n_flops, run.config['compute_dtype'])[0]
    return 100.0 * least_s * calls / (run.census['groups'][group] / 1e3)
