"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, the plain
float32 reference of the configuration's family
(`reference/<family>.py`, TF32 off) follows the checked streams
from their reference frame through every frame the program propagated,
set-up and traced steps included: it reads the same frames, writes its
memory with the program's masks and, where the program evicted, drops the
frame the program dropped, so that it stays on the program's trajectory
(as a served model's reference reads the served tokens). At every frame
it judges what the program produced:

- `mask_gap`: the widest gap, over every pixel of every frame, by which
  the reference's logit of the label the program put there lies below the
  reference's best logit (0 where they agree; a near tie costs little);
- `bank_mismatch`: the (stream, frame) pairs at which the program's bank
  does not hold the frames the reference's does: a missed or extra write,
  a protected frame dropped, more or less than one frame evicted, or a
  frame evicted other than the one the reference's usage-plus-UCB score
  puts lowest; exact. (`evict_margin`, the smallest lead of the lowest
  score over the next at the program's evictions, is reported beside it,
  not compared: it says how far the choices lie from a tie.)

With `control`, the reference computed with float8 operands rides along
on the same frames, masks and evictions, and its own choices are judged
the same way (`control_mask_gap`, `control_bank_mismatch`): the control
of the benchmark's limits.
"""
from __future__ import annotations

import time
from types import ModuleType
from typing import Dict, List

import torch

from rmembench.reference.model import upsample
from rmembench.reference.stream import ReferenceStream
from rmembench.traffic import ping_pong

NUMBERS = ('mask_gap', 'bank_mismatch')


def _held(ids_row) -> set:
    return {int(i) for i in ids_row.tolist() if i >= 0}


def judge(family: ModuleType, weights: Dict[str, torch.Tensor],
          config: dict, traffic: dict, clips, streams: List[int],
          masks: torch.Tensor, bank_ids: torch.Tensor, device,
          control: bool = False, log=None) -> Dict[str, float]:
    """masks [n, S, H, W] uint8 and bank_ids [n, S, T] (-1 free): the
    program's masks and bank frame ids of the checked streams after each
    frame t < n (masks[0] is unused: the reference frame has no
    prediction). `family` is the configuration's reference module."""
    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = _judge(family, weights, config, traffic, clips, streams,
                     masks, bank_ids, device, control)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if log is not None:
        log(f'reference: {len(masks) - 1} frames of streams {streams} in '
            f'{time.perf_counter() - t0:.1f} s')
    return out


def _judge(family, weights, config, traffic, clips, streams, masks,
           bank_ids, device, control):
    mc = config['model']
    w32 = {k: v.float() for k, v in weights.items()}

    def stream(operands):
        return ReferenceStream(family.Reference(w32, mc, operands),
                               traffic['objects'], traffic['gap'],
                               mc['former_mem_len'], mc['latter_mem_len'])
    sides = {'': stream('float32')}
    if control:
        sides['control_'] = stream('float8')
    ref = sides['']
    size, ac = clips.size, mc['align_corners']
    sel = torch.tensor(streams)
    out = {k: 0.0 for k in NUMBERS}
    out['evict_margin'] = float('inf')
    c_mismatch = 0
    # the widest gaps, kept on the device (no wait on every frame)
    gaps = torch.zeros(2, device=device)
    # the checked streams' frames and the program's masks, on the device
    # once: a copy from pageable memory on every frame would wait
    pool = clips.pool[:, sel].to(device)
    labels = masks[1:].to(device)
    img = pool[0]
    label = clips.label0[sel.to(clips.label0.device)].to(device)
    for side in sides.values():
        side.start(img, label)
    mismatch = sum(_held(row) != {0} for row in bank_ids[0])
    for t in range(1, len(masks)):
        img = pool[ping_pong(t, clips.n_frames)]
        label = labels[t - 1].long()
        logits = {k: s.propagate(img) for k, s in sides.items()}
        up = upsample(logits[''], size, ac)
        best = up.amax(1)

        def gap_of(lab):
            return (best - up.gather(1, lab[:, None])[:, 0]).amax()
        gaps[0] = torch.maximum(gaps[0], gap_of(label))
        if control:
            c_lab = upsample(logits['control_'], size, ac).argmax(1)
            gaps[1] = torch.maximum(gaps[1], gap_of(c_lab))
        del up, best
        writes = {k: s.update(label) for k, s in sides.items()}
        held = [_held(row) for row in bank_ids[t]]
        write = writes['']
        if write is None:
            mismatch += sum(h != _held(r) for h, r in
                            zip(held, ref.frame_ids))
            continue
        ids, score = write['frame_ids'], write['score']
        if not write['over']:
            mismatch += sum(h != _held(r) for h, r in zip(held, ids))
            continue
        drops = []
        for s, h in enumerate(held):
            row = ids[s].tolist()
            gone = set(row) - h
            j = row.index(gone.pop()) if (len(gone) == 1
                                          and h <= set(row)) else None
            lowest = int(score[s].argmin())
            if j is None or not torch.isfinite(score[s, j]):
                j = lowest
                mismatch += 1
            elif j != lowest:
                mismatch += 1
            drops.append(j)
            finite = score[s][torch.isfinite(score[s])].sort().values
            if len(finite) > 1:
                out['evict_margin'] = min(out['evict_margin'],
                                          float(finite[1] - finite[0]))
            if control:
                jc = int(writes['control_']['score'][s].argmin())
                c_mismatch += jc != lowest
        drop = torch.tensor(drops)
        for side in sides.values():
            side.evict(drop)
    out['bank_mismatch'] = float(mismatch)
    out['mask_gap'] = float(gaps[0])
    if control:
        out['control_mask_gap'] = float(gaps[1])
        out['control_bank_mismatch'] = float(c_mismatch)
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, dict]) -> bool:
    return all(readings[k] <= limits[k]['limit'] for k in NUMBERS)


def control_verdict(readings: Dict[str, float],
                    limits: Dict[str, dict]) -> bool:
    """`verdict` of the control's readings (`control_<number>`) under the
    same limits: a sound limit makes it False."""
    return verdict({k: readings[f'control_{k}'] for k in NUMBERS}, limits)


def lines(readings: Dict[str, float], limits: Dict[str, dict]) -> List[str]:
    return [f'check {k}: {readings[k]!r} (limit {limits[k]["limit"]!r})'
            for k in NUMBERS]
