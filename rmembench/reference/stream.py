"""The reference's streaming state: the long-term bank in logical order,
the short-term memory of the last frame, and RMem's eviction by attention
usage with a UCB bonus (Zhou et al. 2024, sec. 3.2), for a batch of
streams.

The bank is a list of live frames, oldest first (the reference frame
stays at position 0); a write appends the newest frame and, once the bank
holds more than `former + latter` frames, drops one. The stream is driven
by the labels it is given (the judged program's masks) and, where a
caller passes them, by the program's eviction choices, so that it stays
on the judged program's trajectory; it reports its own scores beside each
choice.

The stream holds whatever entries its family's reference writes (a tuple
of tensors a layer, the same for every frame): the model's `propagate`
returns the reference frame's entries and `write` a later frame's, each
per layer (bank entry, short-term entry). The family's
`scores_every_write` says whether the usage and visit counts move at every
bank write (RMem's GPM) or only at the writes that put the bank over its
budget (RMem's LSTT).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rmembench.reference.model import mask_unused

MOVING_MEAN = 0.8
UCB_ADD = 8.0
UCB_MUL = 1.5


class ReferenceStream:
    def __init__(self, model, obj_num: int, gap: int,
                 former: int = 1, latter: int = 8):
        self.model = model
        self.obj_num = obj_num
        self.gap = gap
        self.budget = former + latter
        self.step = 0

    def start(self, img: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """The reference frame: img [B, H, W, 3], label [B, H, W]. Returns
        its 4x logits [B, C, H4, W4] with unused ids masked."""
        logits, entries, _, self.grid = self.model.propagate(
            img, None, None, id_label=label)
        b = img.shape[0]
        self.bank = [tuple(x[:, None] for x in long)
                     for long, _ in entries]
        self.short = [short for _, short in entries]
        self.frame_ids = torch.zeros((b, 1), dtype=torch.long)
        dev = img.device
        self.ema = torch.zeros((b, 1), device=dev)
        self.present = torch.zeros((b, 1), dtype=torch.bool, device=dev)
        self.visits = torch.zeros((b, 1), device=dev)
        self.step = self.last_write = 0
        self.logits = mask_unused(logits, self.obj_num)
        return self.logits

    def propagate(self, img: torch.Tensor) -> torch.Tensor:
        self.step += 1
        logits, self.pending, self.mass, self.grid = self.model.propagate(
            img, self.bank, self.short)
        self.logits = mask_unused(logits, self.obj_num)
        return self.logits

    def update(self, label: torch.Tensor) -> Optional[dict]:
        """Write the last frame with its label [B, H, W]: the short-term
        memory always, the bank every `gap` frames. Returns None without a
        bank write, else {'frame_ids' [B, L] of the bank after the append,
        'score' [B, L] with inf where a frame may not be dropped, 'over':
        a frame has to go}; the caller then calls `evict`."""
        entries = self.model.write(self.pending, label)
        self.short = [short for _, short in entries]
        if self.step - self.last_write < self.gap:
            return None
        self.last_write = self.step
        self.bank = [tuple(torch.cat([x, y[:, None]], dim=1)
                           for x, y in zip(layer, long))
                     for layer, (long, _) in zip(self.bank, entries)]
        b = label.shape[0]
        self.frame_ids = torch.cat(
            [self.frame_ids, torch.full((b, 1), self.step)], dim=1)
        n_old = self.frame_ids.shape[1] - 1
        over = n_old + 1 > self.budget
        dev = self.ema.device
        zeros = torch.zeros((b, 1), device=dev)
        absent = torch.zeros((b, 1), dtype=torch.bool, device=dev)
        if self.model.scores_every_write or over:
            # the usage of each old frame at the last propagation, weighted
            # by the foreground probability on the 16x grid
            fg = 1.0 - torch.softmax(F.interpolate(
                self.logits, size=self.grid, mode='bilinear',
                align_corners=True), dim=1)[:, 0].reshape(b, -1)
            usage = (self.mass * fg[..., None]).sum(1)
            usage = usage / usage.sum(-1, keepdim=True).clamp_min(1e-20)
            ema = torch.where(self.present, (1 - MOVING_MEAN) * self.ema
                              + MOVING_MEAN * usage, usage)
            self.ema = torch.cat([ema, zeros], dim=1)
            self.present = torch.cat([torch.ones_like(self.present), absent],
                                     dim=1)
            self.visits = torch.cat([self.visits, zeros], dim=1) + 1.0
        else:
            self.ema = torch.cat([self.ema, zeros], dim=1)
            self.present = torch.cat([self.present, absent], dim=1)
            self.visits = torch.cat([self.visits, zeros], dim=1)
        # the reference frame's count is pinned to the number scored
        n = self.visits.clone()
        n[:, 0] = n_old
        n_sum = n[:, :n_old].sum(-1, keepdim=True)
        bonus = UCB_MUL * torch.sqrt(torch.log(n_sum.clamp_min(1.0))
                                     / (n + UCB_ADD))
        score = self.ema + bonus
        # the reference frame is protected, the newest has no usage yet
        score[:, 0] = float('inf')
        score[:, n_old] = float('inf')
        return {'frame_ids': self.frame_ids.clone(), 'score': score,
                'over': over}

    def evict(self, drop: torch.Tensor) -> None:
        """Drop the frame at logical position drop[b] of each stream."""
        b, n = self.frame_ids.shape
        keep = torch.stack([torch.cat([torch.arange(int(j)),
                                       torch.arange(int(j) + 1, n)])
                            for j in drop.tolist()])             # [B, n-1]
        dev = self.ema.device
        kd = keep.to(dev)

        def take(x):
            idx = kd.view(b, n - 1, *([1] * (x.dim() - 2))).expand(
                b, n - 1, *x.shape[2:])
            return torch.gather(x, 1, idx)
        self.bank = [tuple(take(x) for x in layer) for layer in self.bank]
        self.frame_ids = torch.gather(self.frame_ids, 1, keep)
        self.ema, self.present, self.visits = (
            take(self.ema), take(self.present), take(self.visits))
