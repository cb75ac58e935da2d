"""The operations of one steady step, counted on the reference.

`torch.utils.flop_counter.FlopCounterMode` counts every matrix product
and convolution of the reference's step at the cell's shapes, on the
`meta` device (shapes only, no arithmetic): the propagation of a frame
against a full bank, the id tokens of its mask and the id values it
writes. The reference reads the short-term memory a block of rows at a
time, which multiplies more than the window needs; that read is counted
instead by the operations of its 15x15 windows inside the image
(`roofline.b2_work`, the work of kernel B2), so that the count is the
work the step needs, whatever implements it. The count is of one stream;
a step of B streams does B times as much.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from rmembench.reference.model import DeAOTReference
from rmembench.roofline import b2_work


def step_flops(shapes: Dict[str, Tuple[int, ...]], model: dict,
               size: Tuple[int, int], bank_frames: int) -> int:
    """FLOPs of one frame of one stream against `bank_frames` frames."""
    meta = torch.device('meta')
    weights = {k: torch.empty(s, device=meta) for k, s in shapes.items()}
    ref = DeAOTReference(weights, model)
    # the short-term reads, counted apart
    ref.local_read = lambda q, k, v, rel, size_2d, scale: torch.zeros(
        (q.shape[0], q.shape[1], v.shape[-1]), device=meta)
    h, w = size
    ac = model['align_corners']
    grid = ((h - 1) // 16 + 1, (w - 1) // 16 + 1) if ac else (h // 16,
                                                               w // 16)
    hw = grid[0] * grid[1]
    d = model['encoder_embedding_dim']
    e = 2 * d

    def mem(n, c):
        return torch.empty((1, n, hw, c), device=meta)
    bank = [(mem(bank_frames, d // 2), mem(bank_frames, e),
             mem(bank_frames, e)) for _ in range(model['lstt_num'])]
    short = [tuple(x[:, 0] for x in layer) for layer in bank]
    img = torch.empty((1, h, w, 3), device=meta)
    label = torch.zeros((1, h, w), dtype=torch.long, device=meta)
    counter = FlopCounterMode(display=False)
    with counter:
        _, mems, _, _ = ref.propagate(img, bank, short)
        id_emb = ref.id_tokens(label)
        for i, m in enumerate(mems):
            ref.fuse_id(i, m['id_v'], id_emb)
    local = b2_work(1, grid, d // 2, 4 * d)[1]
    return counter.get_total_flops() + model['lstt_num'] * local
