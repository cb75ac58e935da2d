#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rmem_ocu_tpu_torch) on one GPU.

    python3 chip_smoke.py

Nine paths of the port are driven, each at the full width of its model,
and the eval protocol on the first of them. The ResNet-50 paths of the
earlier slices: `r50_deaotl` (DeAOT, one attention head: kernels B1 and
B2), `r50_deaotl` with `no_memory_gap` (two heads: kernel B3; its temporal
PE is off, because the model's PE is d/2 wide and a two-head query d wide,
which the reference package cannot add either) and `r50_aotl` (AOT, LSTT
with 8 heads: kernel B1 in its multi-head, one-bank mode). This slice's
main path, `swinb_deaotl` (Swin-B, align_corners=False: 352x624 inputs, a
22x39 grid; B1 and B2), and one model for each other encoder:
`swinb_aotl` (B1 with 8 heads), `deaotl` (MobileNetV2), `r101_aotl`,
`rs101_aotl` (ResNeSt-101), `aotl` with `encoder='mobilenetv3'` (no
registered model uses MobileNetV3), and `r50_topdown_aotl` with the VOST
oracle through the Evaluator.

Phases, each fatal on failure:
1. environment: card name and power limit, torch and CUDA versions;
2. build: compiles every CUDA kernel with nvcc (sm_90a), all at once, and
   prints each kernel's registers, shared memory and spills;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it (B1 and B2 also at the eval protocol's
   grids, 37x66 and 48x85, and at Swin's 22x39), with its time, the plain
   version's time, one library call's time as a yardstick, the least time
   the card could take (bound) and the share of it reached (bound / time),
   the kernel's time the median of 11 bursts, the plain version's and the
   library call's of 5;
4. engine, fp32, card against CPU, per path: seeded random weights, one
   reference frame and 10 frames at write gap 1 (eviction fires; at
   353x625 for the ResNet-50 paths, at 128x224 or 129x225 for the
   others), holding eviction ids, masks and exact kernel launch counts;
5. main path, bf16, per path: 353x625 (352x624 for Swin), 3 objects, at 1
   and 8 streams (the ResNet-50 paths and swinb_deaotl) or 1: frames/s,
   p50 frame latency, peak memory; after every path's timed run (a profile
   slows the frames timed after it in its process), the census of 3 more
   frames of each, on the timed run's engine
   (rmem_ocu_tpu_torch/tools/census.py: device time by component, kernel
   group and part of the model, in Swin its window attention, the
   attention's qkv and proj linears and the MLPs; launches by op);
6. eval protocol, fp32, card against CPU: the port's Evaluator with flip
   and scales (1.0, 1.3) on 241x433 frames, 3 objects, and 10 objects
   growing to 12 (re-reference, two groups), holding eviction ids at every
   update, written masks and exact launch counts, and scoring the card's
   masks against the CPU's (J&F);
7. eval protocol, bf16, 1080x1920 frames at the default test_max_size
   (577x1041 and 753x1345), flip: eval frames/s, p50 frame latency, peak
   memory, launches and the census of a window of 5 frames per sequence;
   then the eval CLI on the synthetic test set, on its default device;
8. the VOST oracle, `r50_topdown_aotl`: the Evaluator fp32 on the card
   against the CPU (129x225, flip: eviction ids at every update, masks,
   launches, no re-reference), then bf16 on 1080x1920 frames.
9. training, `r50_deaotl`: (a) one fp32 episode (129x129, T=5, gap 1,
   evictions) on the card against the CPU, loss, per-frame losses and
   every trainable gradient, and an AdamW update from the same gradients;
   no kernel launched across the step (training reads densely: the
   kernels have no backward); (b) bf16 AMP steps at the recipe shape
   (465x465 crops, T=17, gap 4, remat 'full', batch 2 (3 timed steps
   after 2) and 4 (2 after 1), and batch 2 without remat (1 step)): step
   time, episodes/s, frames/s, peak memory and the
   census of one step by component (forward, backward, recompute); (c) the trained model in eval mode: the
   inference engine launches B1 and B2 again, as many as expected.
10. the pipeline, `r50_deaotl`: `tools.pipeline.main()` in-process on a
   synthetic VOST tree written from a seed (3 train and 2 val sequences of
   24 JPEG frames at 480x854, 2-3 moving objects): 4 training steps at the
   recipe shape (465x465 crops, T=17, batch 2) with 0 kernel launches,
   step_2 and step_4 checkpoints, the eval leg on the newest checkpoint's
   EMA with exact B1 and B2 launches and a mask for every val frame, the
   scorer's CSV, and the train state's EMA restored on the card equal to
   the bare EMA checkpoint; the CLI's step time, the loader's time per
   batch, the checkpoints' size and save time, and eval frames/s.
11. data parallelism, `r50_deaotl`: (a) two ranks on the card in child
   processes (`--dp-worker`), a gloo group over CUDA tensors (NCCL takes
   one rank a card), one sample each, against this process on both, two
   fp32 steps at 129x129, T=5, gap 1 in four settings (AdamW, AdamW with
   ZeRO-1 and remat, trainable BN with SGD, the same with ZeRO-1): loss
   and metrics, weights and EMA, the ranks alike, no kernel launched; (b)
   `tools.train.main(['--multihost', '--mesh', '1', '--zero1', ...])` in
   this process over NCCL on phase 10's tree at the recipe shape (4 steps,
   saves at 2 and 4), step_4 restored bitwise: the CLI's step beside phase
   10's, each all-reduce's bytes and CUDA-event time, the moment bytes a
   rank holds; (c) the eval CLI of that EMA in two processes on the card
   (`--cli-worker eval`, RANK 0 and 1): their masks together equal one
   process's file for file, and their launches sum to its and phase 10's.
12. tensor parallelism over a model group of two: (a) each kernel at the
   shard shapes a rank reads (B1 one head with V and ID_V 512/M wide, B1
   with 8/M AOT heads, B3 two heads of 512/M, B2 1024/M; M = 2 and 4; B=1
   and 8 on 23x40) against its plain version, with its share of the bound
   beside the whole shape's; (b) two ranks on the card in child processes
   (`--tp-worker`, gloo over CUDA tensors) serving `r50_deaotl`,
   `r50_aotl` and Path A: fp32 at write gap 1 against this process
   (eviction ids at every update, masks, launches a rank), then bf16 at 1
   and 8 streams (the bank bytes a rank holds, the all-reduces a frame
   and their bytes, the frame time); (c) `tools.eval --mesh 2` of 11b's
   EMA in two processes, its masks against 11c's one process; (d) the
   trainer 1 x 2 against 11a's one process (losses, weights, the first
   step's gradients, the ranks alike, 0 launches), then `tools.train
   --multihost --mesh 1x2 --zero1` for 11b's 4 steps against 11b, with
   its step_2 restored at world 1.
13. spatial sharding (`train_spatial_sharding`) over a model group of two
   on the card (`--sp-worker`, gloo over CUDA tensors), each rank
   training on its band of the image's rows, (a) and (c) on one pair of
   ranks and (b) and (d) on another at the same time, while this process
   takes (c)'s and (d)'s float64 steps in one process: (a) 12d's fp32
   steps with the knob against 11a's one process (12d's gates) and
   against 12d's world without it; (b) bf16 AMP at the recipe shape (465x465, T=17,
   B=2, remat 'full'), 1 step with the knob, without it (tensor
   parallelism alone) and in one process: the peak memory a rank, the
   halo exchanges and gathers a step and their MB, the step time, no
   kernel launched; (c) the encoders banded since: the full-depth
   `rs101_aotl`, `r50_topdown_aotl` (its reconstruction loss), the same
   with `oracle=True` and `aotl` on MobileNetV3, float64 with the knob
   against one process on the card (12d's gates; in float32 rounding at
   the ReLUs behind ResNeSt's split-attention pool moves its gradients
   past them), and `rs101_aotl` and
   `r50_topdown_aotl` in bf16 at the recipe shape, 1 step with the knob
   and with tensor parallelism alone (13b's lines; the peak a rank lower
   with the knob); (d) Swin-B, its window halos and the shifted windows'
   wrap round the image: the full-width `swinb_deaotl` and `swinb_aotl`
   in float64 at 128x128 with the knob against one process (12d's
   gates), and `swinb_deaotl` in bf16 at 464x464, T=17, B=2, 1 step
   with the knob and with TP alone (13b's lines and gates).
14. the census tool: `stages` of r50_deaotl at 1 and 8 streams beside
   phase 5's p50; `frames --stage_by_stage` of deaot_1head and
   deaot_2heads (B1, B2, B3 launches equal to the expected counts, each
   kernel's ms a call beside phase 3's row); `train` at 465x465, B=2,
   T=5 (9b profiles a step of the recipe's 17)
   (components sum to the step's device busy time within 1%, matched
   share at least 0.5, no kernel launched); `trace` of phase 5's exported
   trace (its device total equal to that profile's busy time within 1%).
   A profile of the card that sees no kernel fails the run.
15. `RMEM_BF16_PROBS=0` (f32 storage of the attention logits and
   probabilities of bf16 inputs at the plain attention sites; the kernels
   ignore it): (a) `deaot_2heads` and `swinb_deaotl` at 1 stream, 10
   frames, the same weights and frames at the default, with the switch
   and in fp32: B1, B2 and B3 launched as often with the switch as at the
   default, finite logits, the switch's masks against the default's and
   fp32's (more than 99.9% of pixels, a differing pixel excused only
   where the other run's two best logits lie within twice the largest
   logit difference), each bf16 mode's largest logit difference to fp32,
   p50 and device-busy ms a frame, peak memory; (b) one r50_deaotl step at
   the recipe shape after one warm-up, at the default and with the
   switch, beside 9b's default step: step ms, peak memory, no kernel
   launched, finite losses and gradients; and the 129x129, T=5 episode in
   bf16 AMP at the default and with the switch, each leaf's gradient
   cosine to the fp32 episode's.

When a phase ends it prints the seconds since the start and its own
(phase 3's with the build, phase 7's with phase 6's).

The last lines are one JSON object listing the kernels, the card's
`nvidia-smi` name and power limit, and `{"ok": true, "device": ...}`. With
no CUDA device, or without the package beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}

H, W = 353, 625                 # DAVIS 480p long edge 624 -> 16k+1 grid
GRID = ((H - 1) // 16 + 1, (W - 1) // 16 + 1)        # 23 x 40
# align_corners=False models (Swin) snap to 16k instead: 352x624, 22 x 39
SWIN_SIZE = (352, 624)
SWIN_GRID = (SWIN_SIZE[0] // 16, SWIN_SIZE[1] // 16)
N_OBJ = 3
# the eval protocol's grids at the default test_max_size of 1040: a 720p
# or 1080p frame becomes 577x1041 (37x66) and, at scale 1.3, 753x1345
# (48x85); more than 10 objects make batch 2
EVAL_GRIDS = (((37, 66), 1), ((37, 66), 2), ((48, 85), 1))


# cycles of the sleep kernel a timed burst waits behind: ~30 ms, longer
# than the host takes to enqueue a burst of ten wrapper calls, so that the
# device runs the burst back to back
SLEEP_CYCLES = 50_000_000


def time_ms(torch, fn, burst: int = 10, samples: int = 11) -> float:
    """Median device time of one call, from CUDA events around bursts of
    `burst` calls queued behind a sleep kernel (so host overhead between
    calls does not count)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- kernels
def b1_case(torch, batch: int, dtype, precise: bool, seed: int,
            heads: int = 1, d: int = 128, cvs=(512, 512), grid=GRID):
    """B1 inputs: T=10 with a dead slot in the middle, HWq = HWk = the
    tokens of `grid` (920 on the main path), temporal PE. Defaults: the
    DeAOT one-head read (D=128, the two 512-wide banks V and ID_V); the AOT
    read is heads=8, d=32, cvs=(32,)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    hw, t_cap = grid[0] * grid[1], 10
    rnd = lambda *s: torch.randn(*s, generator=g, device='cuda').to(dtype)
    q, k = rnd(batch, hw, heads * d), rnd(batch, t_cap, hw, heads * d)
    vs = tuple(rnd(batch, t_cap, hw, heads * cv) for cv in cvs)
    pe = rnd(1, t_cap, heads * d) * 0.05
    valid = torch.ones(batch, t_cap, dtype=torch.bool, device='cuda')
    valid[:, 5] = False
    n_live = int(valid[0].sum())
    e = torch.finfo(dtype).bits // 8
    cv = sum(cvs)
    n_bytes = batch * (e * heads * (hw * d + n_live * hw * d + n_live * d
                                    + n_live * hw * cv + hw * cv)
                       + 4 * t_cap + 4 * hw * t_cap)
    n_flops = 2 * batch * heads * hw * n_live * (hw * (d + cv) + d)
    args = (q, k, vs, valid, heads, d ** -0.5)
    kw = dict(mem_pe=pe, precise=precise)
    return args, kw, n_bytes, n_flops


def sdpa_over_bank(q, k, v, valid, heads: int, scale: float):
    """One SDPA call over the flattened bank with the slot mask: q [B, HW,
    H*D], k [B, T, HW, H*D], v [B, T, HW, H*Dv] (no mass output)."""
    import torch.nn.functional as F
    b, t_cap, hw, _ = k.shape
    split = lambda x: x.reshape(b, -1, heads, x.shape[-1] // heads).transpose(
        1, 2).contiguous()
    qq, kk, vv = split(q), split(k), split(v)
    mask = valid.repeat_interleave(hw, dim=1)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                  scale=scale)


def b1_library(torch, args, kw):
    """SDPA over the concatenated banks with the slot mask and the PE added
    to the keys."""
    q, k, vs, valid, heads, scale = args
    return sdpa_over_bank(q, k + kw['mem_pe'][:, :, None, :],
                          torch.cat(vs, -1), valid, heads, scale)


def b3_case(torch, batch: int, dtype, seed: int, e_dim: int = 512):
    """B3 inputs as the two-head DeAOT read gives them: D=128 per head, V
    and ID_V e_dim wide each (512; head 0 is V, head 1 ID_V), T=10 with a
    dead slot in the middle, HWq = HWk = 920, the PE already on the
    keys."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    hw, t_cap, heads, d = GRID[0] * GRID[1], 10, 2, 128
    rnd = lambda *s: torch.randn(*s, generator=g, device='cuda').to(dtype)
    q, k = rnd(batch, hw, heads * d), rnd(batch, t_cap, hw, heads * d)
    v, id_v = rnd(batch, t_cap, hw, e_dim), rnd(batch, t_cap, hw, e_dim)
    valid = torch.ones(batch, t_cap, dtype=torch.bool, device='cuda')
    valid[:, 5] = False
    n_live = int(valid[0].sum())
    e = torch.finfo(dtype).bits // 8
    dv = 2 * e_dim // heads
    n_bytes = batch * (e * heads * (hw * d + n_live * hw * d
                                    + n_live * hw * dv)
                       + 4 * heads * hw * dv + 4 * t_cap + 4 * hw * t_cap)
    n_flops = 2 * batch * heads * hw * n_live * hw * (d + dv)
    return (q, k, (v, id_v), valid, heads, d ** -0.5), n_bytes, n_flops


def b2_case(torch, batch: int, dtype, seed: int, grid=GRID,
            e_dim: int = 1024):
    """B2 inputs of the DeAOT path: D=128, E=e_dim (1024, V||ID_V), on
    `grid` (23x40 on the main path)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    (h, w), d, md = grid, 128, 7
    hw, ws2 = h * w, (2 * md + 1) ** 2
    rnd = lambda *s: torch.randn(*s, generator=g, device='cuda')
    q = (rnd(batch, hw, d) * d ** -0.5).to(dtype)
    k, v = rnd(batch, hw, d).to(dtype), rnd(batch, hw, e_dim).to(dtype)
    rel = rnd(batch, hw, ws2)
    qy, qx = np.divmod(np.arange(hw), w)
    rows = np.minimum(qy + md, h - 1) - np.maximum(qy - md, 0) + 1
    cols = np.minimum(qx + md, w - 1) - np.maximum(qx - md, 0) + 1
    n_pairs = int((rows * cols).sum())
    e = torch.finfo(dtype).bits // 8
    n_bytes = batch * (e * (2 * hw * d + 2 * hw * e_dim) + 4 * hw * ws2)
    n_flops = 2 * batch * n_pairs * (d + e_dim)
    args = (q, k, v, rel, (h, w), md, dtype == torch.float32)
    return args, n_bytes, n_flops


def b2_library(torch, args):
    """SDPA with a dense [HW, HW] float mask holding the bias and -inf."""
    import torch.nn.functional as F
    from rmem_ocu_tpu_torch.ops.kernels.local_attn import _local_window_maps
    q, k, v, rel, (h, w), md, _ = args
    md_mask, idx = _local_window_maps(h, w, md)
    # columns of the padded grid that are image pixels, in row-major order
    hp, wp = h + 2 * md, w + 2 * md
    ky, kx = np.divmod(np.arange(hp * wp), wp)
    img_cols = np.flatnonzero((ky >= md) & (ky < h + md)
                              & (kx >= md) & (kx < w + md))
    idx = torch.from_numpy(idx[:, img_cols]).cuda()
    inside = torch.from_numpy(md_mask[:, img_cols]).cuda()
    bias = torch.gather(torch.nn.functional.pad(rel, (0, 1)), 2,
                        idx.expand(q.shape[0], -1, -1))
    mask = torch.where(inside, bias, float('-inf')).to(q.dtype)[:, None]
    qq, kk, vv = q[:, None], k[:, None], v[:, None]
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                  scale=1.0)


def print_split(torch, name, batch, heads, hwq, d, cph, t_cap) -> None:
    """How a bank read is split over slots, and the f32 partials it writes
    and the combine reads back (not counted in the bound)."""
    from rmem_ocu_tpu_torch.ops.kernels.memory_read import read_plan
    n_split, hpb, scratch, _ = read_plan(batch, heads, hwq, d, cph, t_cap,
                                         hwq, torch.device('cuda'))
    n_bytes = 2 * sum(x.numel() * 4 for x in scratch if x is not None)
    kernel = (f'memory_read_heads, {hpb} heads a block' if hpb
              else 'memory_read_ws')
    print(f'kernel {name}: {n_split} splits of the key tiles, {kernel}, '
          f'partials {n_bytes / 1e6:.2f} MB written and read back')


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# Kernel against plain: every element must satisfy
#     |got - want| <= atol + rtol * |want|,   atol = ATOL_RMS * rms(want).
# bf16 outputs differ by one bf16 ulp where the final rounding flips (B1
# also rounds p at different running maxima), so rtol is two bf16 ulps
# (2^-7) and atol 2% of the output's RMS, for the elements near zero. Each
# row also shows that the check rejects the plain output with one live
# slot (B1) or one window key (B2) dropped. f32 outputs differ only in the
# order of f32 sums: an absolute 1e-5.
BF16_TOL = dict(rtol=2 ** -7, atol_rms=0.02, atol=0.0)
F32_TOL = dict(rtol=0.0, atol_rms=0.0, atol=1e-5)


def compare(outs, wants, rtol, atol_rms, atol):
    """(max abs err, rms of the plain output, passes the tolerance)."""
    err, rms, ok = 0.0, 0.0, True
    for got, want in zip(outs, wants):
        g, w = got.float(), want.float()
        r = float(w.square().mean().sqrt())
        diff = (g - w).abs()
        lim = max(atol, atol_rms * r) + rtol * w.abs()
        ok = ok and bool((diff <= lim).all())
        err, rms = max(err, float(diff.max())), max(rms, r)
    return err, rms, ok


# bursts of the plain version's and the library call's times (the kernel's
# own time takes time_ms's 11)
YARDSTICK_SAMPLES = 5


def kernel_row(torch, name, run, plain, library, n_bytes, n_flops, operands,
               err, plain_burst: int = 2):
    """`operands` names the type the kernel multiplies ('bfloat16' or
    'float32'), which sets the peak rate of the bound; the storage type is
    already in `n_bytes`."""
    b_ms, b_by = bound_ms(n_bytes, n_flops, operands)
    row = dict(max_abs_err=err, ms=time_ms(torch, run),
               plain_ms=time_ms(torch, plain, burst=plain_burst,
                                samples=YARDSTICK_SAMPLES),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(torch, library,
                                  samples=YARDSTICK_SAMPLES))
    row['bound_share'] = b_ms / row['ms']
    print(f'kernel {name}: ok, {json.dumps(row)}')
    return row


def b1_row(torch, name, batch, dtype, precise, tol, shape):
    """One row of B1 against its plain version (the check, a sensitivity
    check and the times); `shape` holds b1_case's keywords."""
    from rmem_ocu_tpu_torch.ops.kernels.memory_read import (
        memory_read_fused, memory_read_fused_plain)
    args, kw, n_bytes, n_flops = b1_case(torch, batch, dtype, precise, 1,
                                         **shape)
    outs, mass = memory_read_fused(*args, **kw)
    wants, pmass = memory_read_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    err, rms, ok = compare(outs, wants, **tol)
    err_mass = max_err(mass, pmass)
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs),
          f'{name}: not finite')
    check(ok and err_mass <= 1e-4,
          f'{name}: max abs err {err} (rms {rms}, tol {tol}), mass '
          f'{err_mass}')
    # sensitivity: the plain output with live slot 3 dropped must fail
    q, k, vs, valid, heads, scale = args
    dropped = valid.clone()
    dropped[:, 3] = False
    drops, _ = memory_read_fused_plain(q, k, vs, dropped, heads, scale,
                                       **kw)
    d_err, _, d_ok = compare(drops, wants, **tol)
    check(not d_ok, f'{name}: tolerance accepts a dropped slot '
                    f'(max abs err {d_err})')
    print(f'kernel {name}: max abs err {err:.3e} = {err / rms:.4f} x '
          f'output rms {rms:.4e}, tol {tol}; one live slot dropped gives '
          f'{d_err:.3e} and is rejected')
    if not precise:
        print_split(torch, name, batch, heads, q.shape[1],
                    q.shape[2] // heads,
                    sum(v.shape[3] for v in vs) // heads, k.shape[1])
    return kernel_row(
        torch, name, lambda: memory_read_fused(*args, **kw),
        lambda: memory_read_fused_plain(*args, **kw),
        b1_library(torch, args, kw), n_bytes, n_flops,
        'float32' if precise else 'bfloat16', max(err, err_mass))


def b3_row(torch, name, batch, dtype, e_dim=512):
    """One row of B3 against its plain version. f32 storage still
    multiplies bf16 operands (the path never asks for precise), so every
    row has the bf16 bar."""
    from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import (
        memory_read_multihead, memory_read_multihead_plain)
    args, n_bytes, n_flops = b3_case(torch, batch, dtype, 3, e_dim)
    out, mass = memory_read_multihead(*args)
    want, pmass = memory_read_multihead_plain(*args)
    torch.cuda.synchronize()
    err, rms, ok = compare((out,), (want,), **BF16_TOL)
    err_mass = max_err(mass, pmass)
    check(out.dtype == torch.float32
          and bool(torch.isfinite(out).all()), f'{name}: not finite f32')
    check(ok and err_mass <= 1e-4,
          f'{name}: max abs err {err} (rms {rms}, tol {BF16_TOL}), mass '
          f'{err_mass}')
    q, k, vs, valid, heads, scale = args
    dropped = valid.clone()
    dropped[:, 3] = False
    drop, _ = memory_read_multihead_plain(q, k, vs, dropped, heads, scale)
    d_err, _, d_ok = compare((drop,), (want,), **BF16_TOL)
    check(not d_ok, f'{name}: tolerance accepts a dropped slot '
                    f'(max abs err {d_err})')
    print(f'kernel {name}: max abs err {err:.3e} = {err / rms:.4f} x '
          f'output rms {rms:.4e}, tol {BF16_TOL}; one live slot dropped '
          f'gives {d_err:.3e} and is rejected')
    print_split(torch, name, batch, heads, q.shape[1],
                q.shape[2] // heads, 2 * vs[0].shape[3] // heads,
                k.shape[1])
    row = kernel_row(
        torch, name, lambda: memory_read_multihead(*args),
        lambda: memory_read_multihead_plain(*args),
        sdpa_over_bank(q, k, torch.cat(vs, -1), valid, heads, scale),
        n_bytes, n_flops, 'bfloat16', max(err, err_mass))
    if batch == 1 and dtype == torch.bfloat16 and e_dim == 512:
        # what the kernel's two-bank form saves: the reference
        # concatenates V||ID_V before the read
        print(f'kernel {name}: concatenating V||ID_V '
              f'{tuple(vs[0].shape)} x2 would take '
              f'{time_ms(torch, lambda: torch.cat(vs, -1)):.4f} ms')
    return row


def b2_row(torch, name, batch, dtype, tol, grid, e_dim=1024):
    """One row of B2 against its plain version."""
    from rmem_ocu_tpu_torch.ops.kernels.local_attn import (
        local_window_attention, local_window_attention_plain)
    args, n_bytes, n_flops = b2_case(torch, batch, dtype, 2, grid, e_dim)
    out = local_window_attention(*args)
    want = local_window_attention_plain(*args)
    torch.cuda.synchronize()
    err, rms, ok = compare((out,), (want,), **tol)
    check(bool(torch.isfinite(out.float()).all()), f'{name}: not finite')
    check(ok, f'{name}: max abs err {err} (rms {rms}, tol {tol})')
    # sensitivity: the plain output without the key at offset (0, +1)
    # (bias -1e9, so its weight is 0) must fail
    q, k, v, rel, size_2d, md, precise = args
    rel_drop = rel.clone()
    rel_drop[..., md * (2 * md + 1) + md + 1] = -1e9
    d_err, _, d_ok = compare(
        (local_window_attention_plain(q, k, v, rel_drop, size_2d, md,
                                      precise),), (want,), **tol)
    check(not d_ok, f'{name}: tolerance accepts a dropped key '
                    f'(max abs err {d_err})')
    print(f'kernel {name}: max abs err {err:.3e} = {err / rms:.4f} x '
          f'output rms {rms:.4e}, tol {tol}; one window key dropped '
          f'gives {d_err:.3e} and is rejected')
    return kernel_row(
        torch, name, lambda: local_window_attention(*args),
        lambda: local_window_attention_plain(*args),
        b2_library(torch, args), n_bytes, n_flops,
        'float32' if args[-1] else 'bfloat16', err)


def phase_kernels(torch):
    rows = {}
    aot = dict(heads=8, d=32, cvs=(32,))
    eval_rows = tuple(
        (f'b1_bf16_B{batch}_{grid[0]}x{grid[1]}', batch, torch.bfloat16,
         False, BF16_TOL, dict(grid=grid)) for grid, batch in EVAL_GRIDS)
    g = f'{SWIN_GRID[0]}x{SWIN_GRID[1]}'
    swin_rows = tuple(
        (f'{kind}_bf16_B{batch}_{g}', batch, torch.bfloat16, False,
         BF16_TOL, dict(grid=SWIN_GRID, **shape))
        for kind, shape in (('b1', {}), ('b1mh', aot)) for batch in (1, 8))
    for name, batch, dtype, precise, tol, shape in (
            ('b1_bf16_B1', 1, torch.bfloat16, False, BF16_TOL, {}),
            ('b1_f32_precise_B1', 1, torch.float32, True, F32_TOL, {}),
            ('b1_bf16_B8', 8, torch.bfloat16, False, BF16_TOL, {}),
            ('b1mh_bf16_B1', 1, torch.bfloat16, False, BF16_TOL, aot),
            ('b1mh_bf16_B8', 8, torch.bfloat16, False, BF16_TOL, aot)
    ) + eval_rows + swin_rows:
        rows[name] = b1_row(torch, name, batch, dtype, precise, tol, shape)
    for name, batch, dtype in (('b3_bf16_B1', 1, torch.bfloat16),
                               ('b3_f32_B1', 1, torch.float32),
                               ('b3_bf16_B8', 8, torch.bfloat16)):
        rows[name] = b3_row(torch, name, batch, dtype)
    for name, batch, dtype, tol, grid in (
            ('b2_bf16_B1', 1, torch.bfloat16, BF16_TOL, GRID),
            ('b2_f32_B1', 1, torch.float32, F32_TOL, GRID),
            ('b2_bf16_B8', 8, torch.bfloat16, BF16_TOL, GRID)) + tuple(
                (f'b2_bf16_B{batch}_{grid[0]}x{grid[1]}', batch,
                 torch.bfloat16, BF16_TOL, grid)
                for grid, batch in EVAL_GRIDS + ((SWIN_GRID, 1),
                                                 (SWIN_GRID, 8))):
        rows[name] = b2_row(torch, name, batch, dtype, tol, grid)
    return rows


# ---------------------------------------------------------------- engine
def make_inputs(batch: int, n_frames: int, seed: int, size=(H, W),
                independent: bool = False):
    """A clip of frames near the reference frame, or, `independent`, of
    unrelated frames: then the memory slots differ enough for the
    attention-usage scores to separate them (a near-static clip makes the
    LSTT's eviction choice a tie that rounding breaks)."""
    rng = np.random.RandomState(seed)
    img0 = rng.randn(batch, *size, 3).astype(np.float32)
    mask0 = (rng.rand(batch, *size) * (N_OBJ + 1)).astype(np.int64)
    base = 0.0 if independent else img0
    frames = [(base + (1.0 if independent else 0.5)
               * rng.randn(batch, *size, 3)).astype(np.float32)
              for _ in range(n_frames)]
    return img0, mask0, frames


# The paths: config overrides, the write gap of the bf16 run, the kernel
# launches (B1, B2, B3) per propagated frame and per reference frame, and
# (where not the defaults below) the bf16 run's input size, its stream
# counts and frame counts, and the fp32 check's input size and frame
# count. A bank read (B1 or B3) counts two launches, the split read and
# its combine; `expected_counts` halves that where the read's blocks fill
# the card unsplit and the wide-head kernel finishes it in one. The first
# three paths are the ResNet-50 ones of the earlier slices; `swinb_deaotl`
# is this slice's main path, and one model stands for each other encoder
# (MobileNetV3 in AOT-L, the only way a registered configuration reaches
# it).
DEFAULTS = dict(size=(H, W), streams=(1, 8), warm=5, timed=30,
                check_size=(H, W), check_frames=10, feed_cpu_mask=False)
NEW = dict(feed_cpu_mask=True)
ONE_STREAM = dict(NEW, streams=(1,), warm=3, timed=10)
SMALL = (129, 225)              # 9 x 15 grid
PATHS = {
    'deaot_1head': dict(
        overrides=dict(model='r50_deaotl'), gap=5,
        per_frame=(6, 3, 0), per_reference=(0, 3, 0)),
    'deaot_2heads': dict(
        overrides=dict(model='r50_deaotl', no_memory_gap=True,
                       use_temporal_pe=False), gap=1,
        per_frame=(0, 0, 6), per_reference=(0, 0, 0)),
    'aot': dict(
        overrides=dict(model='r50_aotl'), gap=5,
        per_frame=(6, 0, 0), per_reference=(0, 0, 0)),
    # the paths below write the CPU engine's mask into both engines'
    # memories in the fp32 check (`feed_cpu_mask`): with random weights
    # DeAOT-L on MobileNetV2 has logits so near a tie that summation order
    # flips 5 of 29025 pixels at frame 1, and when each engine writes its
    # own mask the flips compound through the memory (42 pixels at frame
    # 2); fed one mask, each frame holds only the arithmetic of that step
    'swinb_deaotl': dict(
        overrides=dict(model='swinb_deaotl'), gap=5,
        per_frame=(6, 3, 0), per_reference=(0, 3, 0), size=SWIN_SIZE,
        check_size=(128, 224), **NEW),
    'swinb_aotl': dict(
        overrides=dict(model='swinb_aotl'), gap=5,
        per_frame=(6, 0, 0), per_reference=(0, 0, 0), size=SWIN_SIZE,
        **ONE_STREAM, check_size=(128, 224)),
    'deaotl_mobilenetv2': dict(
        overrides=dict(model='deaotl'), gap=5,
        per_frame=(6, 3, 0), per_reference=(0, 3, 0), **ONE_STREAM,
        check_size=SMALL),
    'r101_aotl': dict(
        overrides=dict(model='r101_aotl'), gap=5,
        per_frame=(6, 0, 0), per_reference=(0, 0, 0), **ONE_STREAM,
        check_size=SMALL),
    'rs101_aotl': dict(
        overrides=dict(model='rs101_aotl'), gap=5,
        per_frame=(6, 0, 0), per_reference=(0, 0, 0), **ONE_STREAM,
        check_size=SMALL),
    'aotl_mobilenetv3': dict(
        overrides=dict(model='aotl', encoder='mobilenetv3',
                       encoder_dim=(24, 40, 112, 960)), gap=5,
        per_frame=(6, 0, 0), per_reference=(0, 0, 0), **ONE_STREAM,
        check_size=SMALL),
}


def spec_of(path: str) -> dict:
    return {**DEFAULTS, **PATHS[path]}


def grid_of(size, align_corners: bool):
    """The encoder grid of an input size: (s - 1) // 16 + 1 with
    align_corners, else s // 16."""
    return tuple((s - 1) // 16 + 1 if align_corners else s // 16
                 for s in size)


def read_launches(path: str, batch: int, grid, shards: int = 1) -> int:
    """Launches of one bank read of `path` at `batch` streams on `grid`,
    on a rank's shard of a model group of `shards`: 1 where the wide-head
    kernel's blocks fill the card unsplit, else 2 (the split read and its
    combine; always 2 where the small-head kernel reads AOT's heads)."""
    import torch
    from rmem_ocu_tpu_torch.ops.kernels.memory_read import (
        heads_per_block, split_count)
    per_frame = spec_of(path)['per_frame']
    if per_frame[2]:        # B3: two heads over V||ID_V
        heads, d, cph = 2, 128, 512 // shards
    elif per_frame[1]:      # B1: DeAOT's one head over V||ID_V
        heads, d, cph = 1, 128, 1024 // shards
    else:                   # B1: AOT's 8 heads of 32
        heads, d, cph = 8 // shards, 32, 32
    hw = grid[0] * grid[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = (not heads_per_block(heads, d, cph)
           and split_count(batch, heads, hw, d, cph, hw, sms) == 1)
    return 1 if one else 2


def expected_counts(path: str, n_frames: int, n_reference: int = 1,
                    batch: int = 1, grid=None, shards: int = 1):
    """Launches of (B1, B2, B3) of n_frames propagated frames and
    n_reference reference frames; `per_frame` counts two launches a bank
    read, which a read that `read_launches` makes one halves."""
    spec = spec_of(path)
    per_frame = list(spec['per_frame'])
    if grid is not None and read_launches(path, batch, grid, shards) == 1:
        per_frame = [per_frame[0] // 2, per_frame[1], per_frame[2] // 2]
    return tuple(f * n_frames + r * n_reference for f, r
                 in zip(per_frame, spec['per_reference']))


def reset_counts():
    """Empties the program's counters (and spans)."""
    from rmem_ocu_tpu_torch.utils import tracing
    tracing.clear()


def read_counts():
    """Launches of (B1, B2, B3) since reset_counts()."""
    from rmem_ocu_tpu_torch.utils import tracing
    counts = tracing.counters()
    return tuple(counts.get(f'kernels.{k}.launches', 0)
                 for k in ('b1', 'b2', 'b3'))


def phase_engine_fp32(torch, path: str):
    """fp32 card against CPU, same weights, same inputs, in lock-step, the
    bank written every frame."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = spec_of(path)
    exp = get_config('pre_vost_2', **spec['overrides'])
    cpu_model = build_vos_model(exp.model, device='cpu', seed=0)
    gpu_model = build_vos_model(exp.model, seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    n_frames, size = spec['check_frames'], spec['check_size']
    img0, mask0, frames = make_inputs(1, n_frames, seed=3, size=size,
                                      independent=exp.model.vos == 'aot')
    engines = [InferEngine(m, exp, long_term_mem_gap=1)
               for m in (cpu_model, gpu_model)]
    states = [e.init_state(1, grid_of(size, exp.model.align_corners))
              for e in engines]
    t0 = time.time()
    reset_counts()
    for i, e in enumerate(engines):
        states[i] = e.add_reference_frame(
            states[i], torch.from_numpy(img0), torch.from_numpy(mask0),
            torch.tensor([N_OBJ]))
    budget = exp.model.former_mem_len + exp.model.latter_mem_len
    worst_logit, worst_agree, worst_mass = 0.0, 1.0, 0.0
    for t, f in enumerate(frames):
        preds, logits_all, masses = [], [], []
        for i, e in enumerate(engines):
            logits, states[i] = e.propagate(states[i], torch.from_numpy(f))
            masses.append(states[i].pending_mass.float().cpu())
            pred = e.predict_mask(logits, size)
            preds.append(pred.cpu())
            logits_all.append(logits.float().cpu())
        for i, e in enumerate(engines):
            states[i] = e.update_memory(
                states[i], preds[0] if spec['feed_cpu_mask'] else preds[i])
        ids = [s.bank.frame_ids.cpu() for s in states]
        ordered = [s.bank.ordered_frame_ids.cpu() for s in states]
        agree = float((preds[0] == preds[1]).float().mean())
        diff = float((logits_all[0][..., :N_OBJ + 1]
                      - logits_all[1][..., :N_OBJ + 1]).abs().max())
        worst_logit, worst_agree = max(worst_logit, diff), min(worst_agree,
                                                               agree)
        worst_mass = max(worst_mass, max_err(masses[0], masses[1]))
        # a pixel may differ only where the CPU's two best upsampled logits
        # are within twice the largest logit difference (bilinear
        # upsampling mixes logits convexly)
        up = interpolate_bilinear(logits_all[0].permute(0, 3, 1, 2), size,
                                  exp.model.align_corners)
        top2 = up.topk(2, dim=1).values
        gaps = (top2[:, 0] - top2[:, 1])[preds[0] != preds[1]]
        gap = float(gaps.max()) if gaps.numel() else 0.0
        print(f'engine fp32 {path} frame {t}: ordered ids '
              f'{ordered[1][0].tolist()} mask agreement {agree:.6f} max '
              f'|logit diff| {diff:.3e}, largest top-two gap at a differing '
              f'pixel {gap:.3e}')
        check(torch.equal(ids[0], ids[1]) and torch.equal(*ordered),
              f'{path} frame {t}: eviction ids differ {ordered}')
        check(agree > 0.999, f'{path} frame {t}: mask agreement {agree}')
        check(gap <= 2 * diff + 1e-6, f'{path} frame {t}: a pixel whose '
                                      f'top-two logits differ by {gap} '
                                      f'flipped')
        check(int(ordered[1][0, 0]) == 0, 'reference frame left slot 0')
        check(int(states[1].bank.length[0]) == min(t + 2, budget),
              f'{path} frame {t}: bank length '
              f'{states[1].bank.length.tolist()}')
        check(bool(torch.isfinite(logits_all[1]).all()), 'non-finite logits')
    counts = read_counts()
    # the CPU engine runs the plain versions, which count nothing
    check(counts == expected_counts(path, n_frames),
          f'{path}: kernel launches (B1, B2, B3) {counts} for {n_frames} '
          f'frames, expected {expected_counts(path, n_frames)}')
    print(f'engine fp32 {path} card vs CPU {size[0]}x{size[1]}'
          f'{", the CPU mask written into both" if spec["feed_cpu_mask"] else ""}'
          f': ok in {time.time() - t0:.1f} s, {n_frames} frames, eviction ids '
          f'identical, worst mask agreement {worst_agree:.6f}, worst |logit '
          f'diff| {worst_logit:.3e}, worst |mass diff| {worst_mass:.3e}, '
          f'launches (B1, B2, B3) {counts}')


def main_path_setup(torch, path: str, batch: int):
    """The bf16 engine of `path` at `batch` streams with its reference
    frame added: (exp, engine, state, frames on the card)."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    spec = spec_of(path)
    exp = get_config('pre_vost_2', compute_dtype='bfloat16',
                     **spec['overrides'])
    model = build_vos_model(exp.model, seed=0).to(torch.bfloat16)
    eng = InferEngine(model, exp, long_term_mem_gap=spec['gap'])
    img0, mask0, frames = make_inputs(batch, 8, seed=5, size=spec['size'])
    frames = [torch.from_numpy(f).cuda() for f in frames]
    state = eng.init_state(batch, grid_of(spec['size'],
                                          exp.model.align_corners))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = eng.add_reference_frame(state, torch.from_numpy(img0),
                                    torch.from_numpy(mask0),
                                    torch.full((batch,), N_OBJ))
    return exp, eng, state, frames


def phase_main_path(torch, path: str, batch: int):
    """The bf16 main path of `path` at `batch` streams; returns the kernel
    launch counts (B1, B2, B3) of the timed run, its p50 frame latency and
    (engine, state, frames) after it, for main_path_census. No profile
    runs in its process before it (main_path_census follows every path's
    timed run): the profiler slows later frames."""
    spec = spec_of(path)
    size, n_warm, n_timed = spec['size'], spec['warm'], spec['timed']
    # the engines of the paths timed before stay held for their census
    base = torch.cuda.memory_allocated()
    exp, eng, state, frames = main_path_setup(torch, path, batch)
    grid = grid_of(size, exp.model.align_corners)
    events = []
    for i in range(n_warm + n_timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, state = eng.propagate(state, frames[i % len(frames)])
        pred = eng.predict_mask(logits, size)
        state = eng.update_memory(state, pred)
        end.record()
        if i >= n_warm:
            events.append((start, end))
    torch.cuda.synchronize()
    counts = read_counts()
    n_prop = n_warm + n_timed
    want = expected_counts(path, n_prop, batch=batch,
                           grid=grid_of(size, exp.model.align_corners))
    check(counts == want,
          f'{path}: kernel launches (B1, B2, B3) {counts} for {n_prop} '
          f'frames, expected {want}')
    cut = 3 if exp.model.align_corners else 0
    check(tuple(logits.shape) == (batch, 4 * grid[0] - cut,
                                  4 * grid[1] - cut,
                                  exp.model.max_obj_num + 1),
          f'logits shape {tuple(logits.shape)}')
    check(bool(torch.isfinite(logits[..., :N_OBJ + 1].float()).all()),
          'non-finite logits')
    budget = exp.model.former_mem_len + exp.model.latter_mem_len
    lengths = state.bank.length
    check(bool(((lengths >= 1) & (lengths <= budget)).all()),
          f'bank length {lengths.tolist()}')
    check(bool((state.bank.ordered_frame_ids[:, 0] == 0).all()),
          'reference frame left slot 0')
    per_frame = [s.elapsed_time(e) for s, e in events]
    total_ms = events[0][0].elapsed_time(events[-1][1])
    fps = batch * n_timed / (total_ms / 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    tag = f'{path} streams={batch}'
    p50 = statistics.median(per_frame)
    print(f'main path bf16 {size[0]}x{size[1]} {N_OBJ} objects gap '
          f'{spec["gap"]} {tag}: {fps:.2f} frames/s aggregate, p50 frame '
          f'latency {p50:.3f} ms, peak memory '
          f'{peak:.3f} GiB, {n_timed} timed frames after {n_warm} warm-up, '
          f'launches (B1, B2, B3) {counts}')
    return counts, p50, (eng, state, frames)


# frames in the census of each main-path run (phase 5; phase 14 reads the
# trace of one)
MAIN_CENSUS_FRAMES = 3


def main_path_census(torch, path: str, batch: int, trace_dir=None,
                     live=None) -> dict:
    """The census of MAIN_CENSUS_FRAMES frames of `path` at `batch`
    streams after the timed run's frames (its chrome trace under
    `trace_dir` if given): on the timed run's (engine, state, frames)
    (`live`, phase_main_path's), or on an engine built again as
    phase_main_path builds it and run through as many frames."""
    from rmem_ocu_tpu_torch.tools import census
    from rmem_ocu_tpu_torch.utils.profiling import format_census
    spec = spec_of(path)
    if live is None:
        _, eng, state, frames = main_path_setup(torch, path, batch)
        for i in range(spec['warm'] + spec['timed']):
            state = census.frame_step(eng, state, frames[i % len(frames)],
                                      spec['size'])
    else:
        eng, state, frames = live
    c, _ = census.profile_frames(eng, state, frames, spec['size'],
                                 MAIN_CENSUS_FRAMES, trace_dir)
    for line in format_census(c, f'{path} streams={batch}'):
        print(line)
    return c


# ---------------------------------------------------------------- eval
def array_sequence(name: str, size, n_frames: int, labels: dict, seed: int,
                   **seq_kw):
    """A sequence of the port's eval data whose frames and labels are made
    here from `seed` instead of read from files: smooth random images that
    drift a little from frame to frame, and `labels`, {frame index: uint8
    label map at `size`}."""
    import cv2
    from rmem_ocu_tpu_torch.data.eval_datasets import VOSSequence
    h, w = size
    base = np.random.RandomState(seed).rand(h // 32 + 2, w // 32 + 2, 3)

    class ArraySequence(VOSSequence):
        def _raw_image(self, img_name):
            idx = int(img_name[:5])
            jitter = np.random.RandomState(seed * 1000 + idx).rand(
                *base.shape)
            small = (0.8 * base + 0.2 * jitter).astype(np.float32) * 255
            return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)

        def _raw_label(self, label_name):
            return labels[int(label_name[:5])]

    return ArraySequence('', '', name, [f'{i:05d}.jpg' for i in range(
        n_frames)], [f'{i:05d}.png' for i in labels], **seq_kw)


def object_labels(size, ids, rows: int, cols: int) -> np.ndarray:
    """A label map with one rectangle per object id on a rows x cols
    layout."""
    lbl = np.zeros(size, np.uint8)
    bh, bw = size[0] // rows, size[1] // cols
    for n, obj in enumerate(ids):
        r, c = divmod(n, cols)
        lbl[r * bh + bh // 8:(r + 1) * bh - bh // 8,
            c * bw + bw // 8:(c + 1) * bw - bw // 8] = obj
    return lbl


def eval_sequences(size, frames: tuple, new_at: int, **seq_kw):
    """The two sequences of an eval phase: 3 objects, and 10 objects with
    an 11th and 12th labelled at frame `new_at` (the evaluator then
    re-references and regroups its states from one group to two)."""
    grown = object_labels(size, range(1, 13), 3, 4)
    grown[grown < 11] = 0
    return {
        'objects3': array_sequence(
            'objects3', size, frames[0],
            {0: object_labels(size, (1, 2, 3), 1, 3)}, seed=1, **seq_kw),
        'objects10to12': array_sequence(
            'objects10to12', size, frames[1],
            {0: object_labels(size, range(1, 11), 2, 5), new_at: grown},
            seed=2, **seq_kw)}


def eval_counts(seq, shards: int = 1):
    """Launches of (B1, B2, B3) the evaluator makes on a sequence with
    `r50_deaotl` (on a rank's shard of a model group of `shards`): per
    augmentation and propagated frame, 3 bank reads of `read_launches` B1
    launches each (at the augmentation's grid and the frame's groups of 10
    objects, the engine's batch) and 3 B2; and 3 B2 per reference added
    (frame 0 and every labelled frame after it)."""
    grids = [grid_of(s.image.shape[:2], True) for s in seq.frame(0)]
    props = len(seq) - 1
    b1 = sum(3 * read_launches('deaot_1head', -(-seq.obj_nums[f] // 10), g,
                               shards)
             for g in grids for f in range(1, len(seq)))
    return (b1, 3 * (props + len(seq.labels)) * len(grids), 0)


def record_evictions(engine) -> list:
    """Wraps engine.update_memory; the list gets every state's ordered
    bank frame ids after each update."""
    ids = []
    inner = engine.update_memory

    def update_memory(state, mask):
        state = inner(state, mask)
        ids.append(state.bank.ordered_frame_ids.cpu())
        return state
    engine.update_memory = update_memory
    return ids


def read_masks(root: str, seq: str) -> dict:
    from rmem_ocu_tpu_torch.ops.masks import read_mask_png
    d = os.path.join(root, seq)
    return {n: read_mask_png(os.path.join(d, n))
            for n in sorted(os.listdir(d))}


EVAL_FP32_SIZE = (241, 433)     # grids 16x28 and, at 1.3, 21x36


def phase_eval_fp32(torch, out_root: str):
    """The port's Evaluator in fp32 on the card and on the CPU, same
    weights, same sequences, flip and scales (1.0, 1.3), the bank written
    every frame (--gap 1). Holds eviction ids at every update of every
    augmentation state, the written masks, the kernel launches, and scores
    the card's masks against the CPU's with the port's scorer."""
    import shutil
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.eval.evaluator import Evaluator
    from rmem_ocu_tpu_torch.eval.scorer import (
        GTDataset, evaluate_semisupervised, summarize)
    from rmem_ocu_tpu_torch.data.eval_datasets import EvalDataset
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exp = replace(get_config('pre_vost_2', model='r50_deaotl'),
                  test_long_term_mem_gap=1, test_fixed_mem_gap=True)
    cpu_model = build_vos_model(exp.model, device='cpu', seed=0)
    gpu_model = build_vos_model(exp.model, seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    seqs = eval_sequences(EVAL_FP32_SIZE, (12, 5), 3, max_size=1040,
                          multi_scale=(1.0, 1.3), flip=True)
    evs = {dev: Evaluator(m, exp, os.path.join(out_root, dev))
           for dev, m in (('cpu', cpu_model), ('cuda', gpu_model))}
    t0 = time.time()
    for name, seq in seqs.items():
        ids = {dev: record_evictions(ev.engine) for dev, ev in evs.items()}
        evs['cpu'].evaluate(EvalDataset({name: seq}), verbose=False)
        reset_counts()
        evs['cuda'].evaluate(EvalDataset({name: seq}), verbose=False)
        counts = read_counts()
        for ev in evs.values():
            del ev.engine.update_memory
        check(counts == eval_counts(seq),
              f'eval fp32 {name}: launches (B1, B2, B3) {counts}, expected '
              f'{eval_counts(seq)}')
        check(len(ids['cuda']) == len(ids['cpu']) > 0
              and all(torch.equal(a, b) for a, b in zip(ids['cuda'],
                                                        ids['cpu'])),
              f'eval fp32 {name}: eviction ids differ: '
              f'{[a.tolist() for a in ids["cuda"]][-4:]} vs '
              f'{[a.tolist() for a in ids["cpu"]][-4:]}')
        got = read_masks(os.path.join(out_root, 'cuda'), name)
        want = read_masks(os.path.join(out_root, 'cpu'), name)
        check(list(got) == list(want) and len(got) == len(seq) - 1,
              f'eval fp32 {name}: files {list(got)} vs {list(want)}')
        agree = {n: float((got[n] == want[n]).mean()) for n in got}
        print(f'eval fp32 {name} card vs CPU: {len(seq)} frames, '
              f'{len(ids["cuda"])} state updates with identical eviction '
              f'ids (last {ids["cuda"][-1].tolist()}), mask agreement per '
              f'frame {[round(a, 6) for a in agree.values()]}, differing '
              f'pixels {[int((got[n] != want[n]).sum()) for n in got]}, '
              f'launches (B1, B2, B3) {counts}')
        check(min(agree.values()) > 0.999,
              f'eval fp32 {name}: mask agreement {agree}')
    # the scorer on the card's masks, the CPU's as ground truth
    gt = os.path.join(out_root, 'gt')
    os.makedirs(os.path.join(gt, 'ImageSets'))
    with open(os.path.join(gt, 'ImageSets', 'val.txt'), 'w') as f:
        f.write('\n'.join(seqs) + '\n')
    shutil.copytree(os.path.join(out_root, 'cpu'),
                    os.path.join(gt, 'Annotations'))
    res = evaluate_semisupervised(GTDataset(gt), os.path.join(out_root,
                                                              'cuda'),
                                  with_boundary=True)
    summary = summarize(res)
    print(f'eval fp32 scorer, card masks against CPU masks: {summary}')
    check(summary['J&F'] >= 0.999, f'eval fp32: J&F {summary["J&F"]}')
    print(f'eval fp32 card vs CPU: ok in {time.time() - t0:.1f} s')


EVAL_BF16_SIZE = (1080, 1920)   # 577x1041 (37x66) and 753x1345 (48x85)


def phase_eval_bf16(torch, out_root: str):
    """The port's Evaluator in bf16 at full resolution: 1080x1920 frames at
    the default test_max_size, flip and scales (1.0, 1.3), the adaptive
    write gap. Returns the launches (B1, B2, B3) of the timed runs."""
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.eval.evaluator import EvalStats, Evaluator
    from rmem_ocu_tpu_torch.data.eval_datasets import EvalDataset
    from rmem_ocu_tpu_torch.tools import census
    from rmem_ocu_tpu_torch.utils.profiling import format_census
    exp = get_config('pre_vost_2', model='r50_deaotl',
                     compute_dtype='bfloat16')
    model = build_vos_model(exp.model, seed=0).to(torch.bfloat16)
    seq_kw = dict(max_size=exp.test_max_size, multi_scale=(1.0, 1.3),
                  flip=True)
    seqs = eval_sequences(EVAL_BF16_SIZE, (40, 20), 10, **seq_kw)
    sizes = [s.image.shape[:2] for s in seqs['objects3'].frame(0)]
    check(sizes == [(577, 1041)] * 2 + [(753, 1345)] * 2,
          f'eval bf16 input sizes {sizes}')
    ev = Evaluator(model, exp, out_root)
    total = EvalStats()
    all_counts = (0, 0, 0)
    peak_all = 0.0
    for name, seq in seqs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stats = ev.evaluate(EvalDataset({name: seq}), verbose=False)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(counts == eval_counts(seq),
              f'eval bf16 {name}: launches (B1, B2, B3) {counts}, expected '
              f'{eval_counts(seq)}')
        n_files = len(os.listdir(os.path.join(out_root, name)))
        check(n_files == len(seq) - 1, f'eval bf16 {name}: {n_files} masks')
        print(f'eval bf16 {name} {EVAL_BF16_SIZE[0]}x{EVAL_BF16_SIZE[1]} '
              f'flip, scales (1.0, 1.3), {len(seq)} frames: '
              f'{stats.total_frames / stats.total_time:.3f} eval frames/s, '
              f'p50 frame latency {stats.p50_latency_ms:.3f} ms (4 '
              f'augmentations a frame), peak memory {peak:.3f} GiB, '
              f'launches (B1, B2, B3) {counts}, {n_files} masks written')
        total.total_time += stats.total_time
        total.total_frames += stats.total_frames
        total.frame_times.extend(stats.frame_times)
        all_counts = tuple(a + b for a, b in zip(all_counts, counts))
        peak_all = max(peak_all, peak)
    print(f'eval bf16 whole run: {total.total_frames} timed frames, '
          f'{total.total_frames / total.total_time:.3f} eval frames/s, p50 '
          f'frame latency {total.p50_latency_ms:.3f} ms, peak memory '
          f'{peak_all:.3f} GiB, launches (B1, B2, B3) {all_counts}')

    # one profiled window of 5 frames per sequence, in a second run of its
    # first frames; on objects10to12 the window follows the regroup
    device_ms = {}
    for name, n_frames, first in (('objects3', 10, 4),
                                  ('objects10to12', 17, 11)):
        seq = eval_sequences(EVAL_BF16_SIZE, (n_frames, n_frames), 10,
                             **seq_kw)[name]
        c = census.profile_eval(ev, name, seq, first, 5)
        for line in format_census(c, f'eval bf16 {name}',
                                  stage_by_stage=True):
            print(line)
        device_ms[name] = c['busy_ms']
    frames = {name: len(seq) - 1 for name, seq in seqs.items()}
    busy = sum(device_ms[n] * frames[n] for n in frames) / sum(
        frames.values())
    print(f'eval bf16 whole run: device busy {busy:.3f} ms/frame (the '
          f'windows weighted by the timed frames)')
    return all_counts


def oracle_sequence(size, n_frames: int, **seq_kw):
    """A VOST-oracle sequence: 3 objects, each frame labelled, the objects
    drifting a little from frame to frame."""
    labels = {}
    for t in range(n_frames):
        lbl = object_labels(size, (1, 2, 3), 1, 3)
        labels[t] = np.roll(lbl, (t * size[0] // 100, t * size[1] // 100),
                            axis=(0, 1))
    return array_sequence('oracle', size, n_frames, labels, seed=4, **seq_kw)


def phase_oracle(torch, out_root: str):
    """`r50_topdown_aotl` with the VOST oracle through the port's
    Evaluator (every frame's ground truth conditions the TopDown encoder
    and none re-references): fp32 on the card against the CPU on 129x225
    frames with flip, the bank written every frame, holding eviction ids
    at every update, masks, launches and the count of updates; then bf16
    on 1080x1920 frames (577x1041, one augmentation). Returns the launches
    (B1, B2, B3) of the bf16 run."""
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.data.eval_datasets import EvalDataset
    from rmem_ocu_tpu_torch.eval.evaluator import Evaluator
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    exp = replace(get_config('pre_vost_2', model='r50_topdown_aotl',
                             oracle=True),
                  test_long_term_mem_gap=1, test_fixed_mem_gap=True)
    cpu_model = build_vos_model(exp.model, device='cpu', seed=0)
    gpu_model = build_vos_model(exp.model, seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    n_frames, n_aug = 12, 2
    seq = oracle_sequence(SMALL, n_frames, max_size=1040, flip=True)
    evs = {dev: Evaluator(m, exp, os.path.join(out_root, dev))
           for dev, m in (('cpu', cpu_model), ('cuda', gpu_model))}
    ids = {dev: record_evictions(ev.engine) for dev, ev in evs.items()}
    evs['cpu'].evaluate(EvalDataset({'oracle': seq}), verbose=False)
    reset_counts()
    evs['cuda'].evaluate(EvalDataset({'oracle': seq}), verbose=False)
    counts = read_counts()
    want = (6 * (n_frames - 1) * n_aug, 0, 0)
    check(counts == want, f'oracle fp32: launches {counts}, expected {want}')
    # a labelled frame that re-referenced would not update the memory
    check(len(ids['cuda']) == len(ids['cpu']) == (n_frames - 1) * n_aug
          and all(torch.equal(a, b) for a, b in zip(ids['cuda'],
                                                    ids['cpu'])),
          f'oracle fp32: eviction ids differ or a frame re-referenced: '
          f'{len(ids["cuda"])} and {len(ids["cpu"])} updates')
    check(int((ids['cuda'][-1][0] >= 0).sum()) == 9,
          f'oracle fp32: bank {ids["cuda"][-1].tolist()}')
    got = read_masks(os.path.join(out_root, 'cuda'), 'oracle')
    want_m = read_masks(os.path.join(out_root, 'cpu'), 'oracle')
    check(list(got) == list(want_m) and len(got) == n_frames - 1,
          f'oracle fp32: files {list(got)} vs {list(want_m)}')
    agree = [float((got[n] == want_m[n]).mean()) for n in got]
    check(min(agree) > 0.999, f'oracle fp32: mask agreement {agree}')
    print(f'oracle fp32 r50_topdown_aotl card vs CPU {SMALL[0]}x{SMALL[1]} '
          f'flip: ok in {time.time() - t0:.1f} s, {len(ids["cuda"])} state '
          f'updates with identical eviction ids (last '
          f'{ids["cuda"][-1].tolist()}), no re-reference, worst mask '
          f'agreement {min(agree):.6f}, launches (B1, B2, B3) {counts}')

    exp = get_config('pre_vost_2', model='r50_topdown_aotl', oracle=True,
                     compute_dtype='bfloat16')
    model = build_vos_model(exp.model, seed=0).to(torch.bfloat16)
    n_frames = 12
    seq = oracle_sequence(EVAL_BF16_SIZE, n_frames,
                          max_size=exp.test_max_size)
    check(seq.frame(0)[0].image.shape[:2] == (577, 1041),
          f'oracle bf16 input {seq.frame(0)[0].image.shape}')
    ev = Evaluator(model, exp, os.path.join(out_root, 'bf16'))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = ev.evaluate(EvalDataset({'oracle': seq}), verbose=False)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = (6 * (n_frames - 1), 0, 0)
    check(counts == want, f'oracle bf16: launches {counts}, expected {want}')
    print(f'oracle bf16 r50_topdown_aotl {EVAL_BF16_SIZE[0]}x'
          f'{EVAL_BF16_SIZE[1]} (577x1041), {n_frames} frames: '
          f'{stats.total_frames / stats.total_time:.3f} eval frames/s, p50 '
          f'frame latency {stats.p50_latency_ms:.3f} ms, peak memory '
          f'{peak:.3f} GiB, launches (B1, B2, B3) {counts}')
    return counts


def phase_eval_cli(out_root: str) -> None:
    """`python -m rmem_ocu_tpu_torch.tools.eval --dataset test` on its
    default device, the card: two synthetic 129x129 sequences of 10
    frames, masks and print.log under out_root."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, '-m', 'rmem_ocu_tpu_torch.tools.eval', '--dataset',
         'test', '--output', out_root],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    check(out.returncode == 0,
          f'eval CLI: exit {out.returncode}: {out.stderr[-2000:]}')
    n_masks = sum(len(os.listdir(os.path.join(out_root, s)))
                  for s in ('test_0', 'test_1'))
    check(n_masks == 18 and os.path.isfile(os.path.join(out_root,
                                                        'print.log')),
          f'eval CLI: {n_masks} masks')
    print(f'eval CLI on the card: ok in {time.time() - t0:.1f} s, '
          f'{n_masks} masks; {out.stdout.strip().splitlines()[-1]}')


# ---------------------------------------------------------------- training
def train_clip(batch: int, n_frames: int, size, seed: int, n_obj: int = N_OBJ):
    """A clip of smooth random frames and blob labels of n_obj objects
    (numpy, [B, T, H, W, 3] f32 and [B, T, H, W] int64)."""
    rng = np.random.RandomState(seed)
    h, w = size
    frames = rng.randn(batch, n_frames, h, w, 3).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((batch, n_frames, h, w), np.int64)
    for b in range(batch):
        for t in range(n_frames):
            for obj in range(1, n_obj + 1):
                cy, cx = rng.rand(2) * (h, w)
                r = (0.15 + 0.15 * rng.rand()) * min(h, w)
                masks[b, t][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = obj
    return frames, masks


def nudged(frames, seed: int):
    """The frames moved by 1e-5 of their value."""
    return (frames * (1 + 1e-5 * np.random.RandomState(seed).randn(
        *frames.shape))).astype(np.float32)


def grad_pairs_pass(pairs, names):
    """Each leaf's cosine >= 0.9999 and norm ratio in [0.999, 1.001] on one
    of the (card, CPU) gradient pairs of nudged clips (with random weights
    a ReLU input within rounding of 0 makes the gradient jump; the nudges
    move which do), a leaf zero in exact arithmetic below 1e-6 of the
    global norm on both. Returns the worst (1 - cosine, |ratio - 1|)."""
    total = float(sum(float(pairs[0][1][n].double().square().sum())
                      for n in names)) ** 0.5
    worst = (0.0, 0.0)
    for n in names:
        best = None
        for card, cpu in pairs:
            a, b = card[n].double().cpu(), cpu[n].double()
            na, nb = float(a.norm()), float(b.norm())
            if max(na, nb) < 1e-6 * total:
                best = (0.0, 0.0)
                break
            dev = (1.0 - float((a * b).sum()) / (na * nb), abs(na / nb - 1))
            if best is None or max(dev) < max(best):
                best = dev
        check(best[0] <= 1e-4 and best[1] <= 1e-3,
              f'training gradient {n}: (1 - cosine, |ratio - 1|) {best} on '
              f'every nudged clip')
        worst = (max(worst[0], best[0]), max(worst[1], best[1]))
    return worst


def phase_training_fp32(torch):
    """9a: one training episode of r50_deaotl (pre_vost_2, 129x129, T=5,
    write gap 1 and a latter budget of 2, so that writes and evictions
    fire; 3 objects; seeded random weights, every train-time rate 0, no id
    shuffle) on the card against the CPU: loss, per-frame losses and every
    trainable gradient; no kernel launched across the step; then one AdamW
    update on the card against the CPU from the same gradients."""
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
    from rmem_ocu_tpu_torch.models.vos_model import zero_dropout
    from rmem_ocu_tpu_torch.train import optim
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exp = replace(get_config('pre_vost_2', model='r50_deaotl',
                             latter_mem_len=2, data_seq_len=5,
                             train_lstt_droppath=0.0),
                  train_long_term_mem_gap=1)
    t0 = time.time()
    models = [zero_dropout(build_vos_model(exp.model, device=d, seed=0,
                                           exp=exp)).train()
              for d in ('cpu', None)]
    models[1].load_state_dict(models[0].state_dict(), strict=True)
    engines = [TrainEngine(m, exp) for m in models]
    frames, masks = train_clip(1, 5, (129, 129), seed=21)
    step = 1000                         # inside the hard-mining ramp
    obj = torch.tensor([N_OBJ])

    def episode(i, clip):
        for p in models[i].parameters():
            p.grad = None
        loss, aux = engines[i].episode_loss(
            torch.from_numpy(clip), torch.from_numpy(masks), obj, step, None,
            enable_id_shuffle=False)
        loss.backward()
        return loss.detach().cpu(), aux['frame_losses'].detach().cpu(), {
            n: p.grad.detach().clone() for n, p in
            models[i].named_parameters()}

    reset_counts()
    card = episode(1, frames)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == (0, 0, 0), f'training launched kernels {counts}')
    cpu = episode(0, frames)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    frame_err = float(((card[1] - cpu[1]).abs() / cpu[1].abs()).max())
    check(loss_err <= 1e-5 and frame_err <= 1e-5,
          f'training loss {float(card[0])} vs CPU {float(cpu[0])}, frame '
          f'losses {card[1].tolist()} vs {cpu[1].tolist()}')
    masks_fz = optim.make_masks(dict(models[0].named_parameters()), exp)
    names = [n for n, fz in masks_fz.frozen.items() if not fz]
    pairs = [(card[2], cpu[2])] + [(episode(1, c)[2], episode(0, c)[2])
                                   for c in (nudged(frames, 1),
                                             nudged(frames, 2))]
    worst = grad_pairs_pass(pairs, names)

    # one AdamW update from the CPU's gradients, on both devices
    params = [{n: p.detach() for n, p in m.named_parameters()}
              for m in models]
    grads = {n: torch.zeros_like(g) if masks_fz.frozen[n] else g
             for n, g in cpu[2].items()}
    lr = optim.schedule_lr(step, exp)
    new = []
    for i, dev in enumerate(('cpu', 'cuda')):
        g = {n: grads[n].to(dev) for n in grads}
        upd, _ = optim.adam_update(
            optim.clip_by_global_norm(g, exp.train_clip_grad_norm),
            optim.init_opt_state(params[i], exp))
        new.append(optim.apply_updates(params[i], upd, masks_fz, lr, exp))
    step_err = max(float((new[1][n].cpu() - new[0][n]).abs().max())
                   / max(float(new[0][n].abs().max()), 1e-30)
                   for n in new[0])
    moved = sum(not torch.equal(new[0][n], params[0][n]) for n in names)
    check(step_err <= 1e-6 and moved == len(names),
          f'AdamW update card vs CPU: {step_err} of the leaf max, '
          f'{moved}/{len(names)} trainable leaves moved')
    print(f'training fp32 r50_deaotl 129x129 T=5 card vs CPU: ok in '
          f'{time.time() - t0:.1f} s; loss {float(card[0]):.6f} (rel err '
          f'{loss_err:.2e}), frame losses rel err {frame_err:.2e}, '
          f'{len(names)} trainable leaves, worst gradient (1 - cosine, '
          f'|ratio - 1|) {worst[0]:.2e}, {worst[1]:.2e} (best of '
          f'{len(pairs)} nudged clips); AdamW update rel err '
          f'{step_err:.2e}; launches (B1, B2, B3) across the step {counts}')
    return counts


def phase_training_bf16(torch):
    """9b: bf16 AMP training of r50_deaotl at the recipe shape (pre_vost_2:
    465x465 crops, T=17, write gap 4), 3 objects, remat 'full', per-card
    batch 2 and 4: CUDA events over 3 steps after 2 warm-up, episodes/s,
    frames/s, peak memory, a profile of one step; batch 2 again without
    remat. Returns the trained model of the batch-2 run and its step
    (ms, peak GiB)."""
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.tools import census
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    from rmem_ocu_tpu_torch.utils.profiling import format_census
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    base = get_config('pre_vost_2', model='r50_deaotl', train_amp=True)
    size, n_frames = base.data_randomcrop, base.data_seq_len
    check(base.train_long_term_mem_gap == 4 and n_frames == 17
          and tuple(size) == (465, 465), f'recipe {size} T={n_frames} gap '
          f'{base.train_long_term_mem_gap}')
    trained, step = None, None
    # (batch, remat, warm-up steps, timed steps)
    for batch, policy, n_warm, n_timed in ((2, 'full', 2, 3),
                                           (4, 'full', 1, 2),
                                           (2, 'none', 0, 1)):
        exp = replace(base, train_remat_policy=policy)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_vos_model(exp.model, seed=0, exp=exp)
        trainer = Trainer(model, exp)
        state = trainer.init_state()
        frames, masks = train_clip(batch, n_frames, size, seed=batch)
        batch_d = {'frames': torch.from_numpy(frames).cuda(),
                   'masks': torch.from_numpy(masks).cuda(),
                   'obj_nums': torch.full((batch,), N_OBJ, device='cuda')}
        gen = torch.Generator().manual_seed(7)
        tag = f'training bf16 r50_deaotl B={batch} remat={policy}'
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema0 = {n: v.clone() for n, v in state.ema.items()}
        reset_counts()
        try:
            events, losses = [], []
            for i in range(n_warm + n_timed):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, metrics = trainer.train_step(state, batch_d, gen)
                end.record()
                losses.append(metrics['loss'])
                if i >= n_warm:
                    events.append((start, end))
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            total = torch.cuda.get_device_properties(0).total_memory
            print(f'{tag}: does not fit in {total / 2 ** 30:.1f} GiB '
                  f'({str(e).splitlines()[0][:120]})')
            del model, trainer, state
            continue
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if policy == 'none':
            print(f'{tag}: fits, peak memory {peak:.3f} GiB')
            continue
        check(read_counts() == (0, 0, 0), f'{tag}: kernels launched '
                                          f'{read_counts()}')
        check(all(bool(torch.isfinite(x)) for x in losses), f'{tag}: '
              f'non-finite loss {[float(x) for x in losses]}')
        check(float(metrics['grad_norm']) > 0, f'{tag}: zero gradient')
        moved = sum(not torch.equal(p.detach(), p0[n])
                    for n, p in model.named_parameters()
                    if p.requires_grad)
        ema_moved = sum(not torch.equal(v, ema0[n])
                        for n, v in state.ema.items())
        check(moved > 0 and ema_moved > 0, f'{tag}: {moved} parameters and '
                                           f'{ema_moved} EMA leaves moved')
        step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
        print(f'{tag} {size[0]}x{size[1]} T={n_frames} gap 4: '
              f'{step_ms:.1f} ms a step '
              f'(median of {len(events)} after {n_warm} warm-up), '
              f'{1e3 * batch / step_ms:.3f} episodes/s, '
              f'{1e3 * batch * n_frames / step_ms:.1f} frames/s, peak '
              f'memory {peak:.3f} GiB, loss {float(losses[-1]):.4f}, grad '
              f'norm {float(metrics["grad_norm"]):.3f}, {moved} parameter '
              f'and {ema_moved} EMA leaves moved, launches (B1, B2, B3) '
              f'{read_counts()}')
        if batch == 2:
            c, state, metrics = census.profile_train_step(trainer, state,
                                                          batch_d, gen)
            for line in format_census(c, tag):
                print(line)
            trained, step = model, dict(ms=step_ms, peak=peak)
    return trained, step


def phase_after_training(torch, model):
    """9c: the trained model back in eval mode: the InferEngine under
    no_grad launches the kernels again, exactly as many as the main path
    does."""
    from rmem_ocu_tpu_torch import InferEngine, get_config
    exp = get_config('pre_vost_2', model='r50_deaotl')
    model.eval()
    size, n_frames = (225, 225), 4
    eng = InferEngine(model, exp, long_term_mem_gap=1)
    img0, mask0, frames = make_inputs(1, n_frames, seed=9, size=size)
    state = eng.init_state(1, grid_of(size, True))
    reset_counts()
    state = eng.add_reference_frame(state, torch.from_numpy(img0),
                                    torch.from_numpy(mask0),
                                    torch.tensor([N_OBJ]))
    for f in frames:
        logits, state = eng.propagate(state, torch.from_numpy(f))
        state = eng.update_memory(state, eng.predict_mask(logits, size))
        check(bool(torch.isfinite(logits[..., :N_OBJ + 1]).all()),
              'non-finite logits after training')
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == expected_counts('deaot_1head', n_frames),
          f'after training: launches (B1, B2, B3) {counts}, expected '
          f'{expected_counts("deaot_1head", n_frames)}')
    print(f'after training, eval mode, no_grad: {n_frames} frames at '
          f'{size[0]}x{size[1]}, launches (B1, B2, B3) {counts} as expected')
    return counts


# ---------------------------------------------------------------- pipeline
def write_sequence(img_dir: str, ann_dir: str, size, n_frames: int,
                   rng: np.random.RandomState, n_obj: int = 0,
                   label_every: int = 1) -> None:
    """One synthetic sequence drawn from `rng`: n_obj (else 2 or 3)
    ellipses moving over a smooth random background, as JPEG frames
    %05d.jpg in img_dir and palette PNG masks %05d.png in ann_dir, one for
    every `label_every`-th frame."""
    import cv2
    from rmem_ocu_tpu_torch.ops.masks import save_mask_png
    h, w = size
    yy, xx = np.mgrid[:h, :w]
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    n_obj = n_obj or rng.randint(2, 4)
    centre = (0.25 + 0.5 * rng.rand(n_obj, 2)) * (h, w)
    step = (rng.rand(n_obj, 2) - 0.5) * (0.2 / n_frames) * (h, w)
    radius = (0.12 + 0.08 * rng.rand(n_obj, 2)) * (h, w)
    colour = rng.randint(0, 256, (n_obj, 3)).astype(np.float32)
    background = cv2.resize(
        rng.rand(h // 32 + 2, w // 32 + 2, 3).astype(np.float32) * 255,
        (w, h), interpolation=cv2.INTER_LINEAR)
    for t in range(n_frames):
        img = background.copy()
        label = np.zeros((h, w), np.uint8)
        for o in range(n_obj):
            cy, cx = centre[o] + t * step[o]
            inside = (((yy - cy) / radius[o, 0]) ** 2
                      + ((xx - cx) / radius[o, 1]) ** 2) < 1
            label[inside] = o + 1
            img[inside] = 0.6 * colour[o] + 0.4 * img[inside]
        cv2.imwrite(os.path.join(img_dir, f'{t:05d}.jpg'),
                    img[:, :, ::-1].astype(np.uint8))
        if t % label_every == 0:
            save_mask_png(label, os.path.join(ann_dir, f'{t:05d}.png'))


def write_vost_tree(root: str, size, n_frames: int, n_train: int = 3,
                    n_val: int = 2, seed: int = 0) -> dict:
    """A synthetic VOST tree from `seed`, in both layouts the pipeline
    reads: the train sequences under root/VOST/{JPEGImages, Annotations,
    ImageSets/train.txt}, the val sequences under root/{JPEGImages_10fps,
    Annotations, ImageSets/val.txt}. Returns {'train': names, 'val':
    names}."""
    rng = np.random.RandomState(seed)
    names = {}
    for split, n_seq, base, image_dir in (
            ('train', n_train, os.path.join(root, 'VOST'), 'JPEGImages'),
            ('val', n_val, root, 'JPEGImages_10fps')):
        names[split] = [f'{split}{i}' for i in range(n_seq)]
        os.makedirs(os.path.join(base, 'ImageSets'), exist_ok=True)
        with open(os.path.join(base, 'ImageSets', f'{split}.txt'), 'w') as f:
            f.write('\n'.join(names[split]) + '\n')
        for seq in names[split]:
            write_sequence(os.path.join(base, image_dir, seq),
                           os.path.join(base, 'Annotations', seq), size,
                           n_frames, rng)
    return names


PIPELINE_SIZE, PIPELINE_FRAMES = (480, 854), 24
PIPELINE_ARGS = ['--stage', 'pre_vost_2', '--model', 'r50_deaotl',
                 '--dataset', 'vost', '--batch_size', '2', '--total_steps',
                 '4', '--save_step', '2']


def phase_pipeline(torch, root: str):
    """10: `tools.pipeline.main()` in-process on a synthetic VOST tree (3
    train and 2 val sequences of 24 frames at 480x854): R50-DeAOT-L at
    full width trains 4 steps (recipe crops 465x465, T=17, batch 2, fp32,
    the default loader of data_workers threads), saves step_2 and step_4,
    evaluates the newest checkpoint's EMA and scores. Holds 0 launches
    across training, the exact B1 and B2 launches of the eval leg, finite
    metrics rows, the checkpoints, a mask for every val frame, J in [0, 1]
    and ckpt/step_4's EMA equal to ema_ckpt/step_4 on the card. Returns
    the eval leg's launches (B1, B2, B3)."""
    import re
    from rmem_ocu_tpu_torch.config import config_from_dict, get_config
    from rmem_ocu_tpu_torch.data.eval_datasets import build_vost_dataset
    from rmem_ocu_tpu_torch.data.train_datasets import (TrainDataLoader,
                                                        build_train_dataset)
    from rmem_ocu_tpu_torch.tools import eval as eval_tool
    from rmem_ocu_tpu_torch.tools import pipeline
    from rmem_ocu_tpu_torch.tools import train as train_tool
    from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
    # a fresh process's settings: cuDNN may use TF32, matmuls may not
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    data = os.path.join(root, 'data')
    names = write_vost_tree(data, PIPELINE_SIZE, PIPELINE_FRAMES, seed=0)
    print(f'pipeline: wrote the VOST tree in {time.time() - t0:.1f} s')
    legs, saves = {}, []
    train_main, eval_main = train_tool.main, eval_tool.main
    save = ckpt.save_checkpoint

    def leg(name, main, extra=()):
        def run():
            # the recipe logs every 20 steps; this run takes 4, so its
            # train leg logs each one
            sys.argv = sys.argv + list(extra)
            reset_counts()
            start = time.time()
            main()
            torch.cuda.synchronize()
            legs[name] = (read_counts(), time.time() - start)
        return run

    def timed_save(root_dir, step, state, *a, **k):
        start = time.time()
        path = save(root_dir, step, state, *a, **k)
        saves.append((os.path.basename(root_dir), time.time() - start,
                      os.path.getsize(path) / 2 ** 20))
        return path

    cwd = os.getcwd()
    os.chdir(root)
    train_tool.main = leg('train', train_main, ('--log_step', '1'))
    eval_tool.main = leg('eval', eval_main)
    ckpt.save_checkpoint = timed_save
    try:
        pipeline.main(PIPELINE_ARGS + ['--data_root', data])
    finally:
        train_tool.main, eval_tool.main = train_main, eval_main
        ckpt.save_checkpoint = save
        os.chdir(cwd)
    result = os.path.join(root, get_config(
        'pre_vost_2', model=PIPELINE_ARGS[PIPELINE_ARGS.index('--model') + 1]
    ).dir_result())

    with open(os.path.join(result, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    check([r['step'] for r in rows] == [1, 2, 3, 4]
          and all(np.isfinite(v) for r in rows for k, v in r.items()
                  if k not in ('frame_losses', 'frame_ious'))
          and all(np.isfinite(r['frame_losses']).all() for r in rows),
          f'pipeline: metrics rows {rows}')
    for sub in ('ckpt', 'ema_ckpt'):
        check(ckpt.list_checkpoint_steps(os.path.join(result, sub))
              == [2, 4], f'pipeline: {sub} steps')
    check(os.path.isfile(os.path.join(result, 'config.json')),
          'pipeline: config.json')
    check(legs['train'][0] == (0, 0, 0),
          f'pipeline: training launched kernels {legs["train"][0]}')
    out = os.path.join(result, 'eval', 'vost')
    dataset = build_vost_dataset(data, 'val')
    want = tuple(sum(c) for c in zip(*(eval_counts(seq)
                                       for _, seq in dataset.items())))
    check(legs['eval'][0] == want, f'pipeline eval: launches (B1, B2, B3) '
                                   f'{legs["eval"][0]}, expected {want}')
    for seq in names['val']:
        masks = sorted(os.listdir(os.path.join(out, seq)))
        check(masks == [f'{t:05d}.png' for t in range(PIPELINE_FRAMES)],
              f'pipeline eval: masks of {seq}: {masks}')
    with open(os.path.join(out, 'global_results-val.csv')) as f:
        head, values = [line.strip().split(',') for line in f]
    summary = dict(zip(head, map(float, values)))
    check(0.0 <= summary['J_mean'] <= 1.0, f'pipeline: scores {summary}')
    with open(os.path.join(out, 'print.log')) as f:
        fps = float(re.findall(r'all-frame FPS: ([0-9.]+)', f.read())[-1])

    # the train state's EMA against the bare EMA, restored on the card
    dev = torch.device('cuda')
    state, step = ckpt.restore_checkpoint(os.path.join(result, 'ckpt'),
                                          step=4)
    ema, _ = ckpt.restore_checkpoint(os.path.join(result, 'ema_ckpt'),
                                     step=4)
    ema_state = {k: v.to(dev) for k, v in state['ema'].items()}
    ema_bare = {k: v.to(dev) for k, v in ema['state_dict'].items()}
    check(step == 4 and state['step'] == 4 and ema_state.keys() ==
          ema_bare.keys() and all(torch.equal(v, ema_bare[k])
                                  for k, v in ema_state.items()),
          'pipeline: the EMA of ckpt/step_4 differs from ema_ckpt/step_4')

    # the loader alone, on the same tree and config, as the CLI's loop
    # calls it: one next() after each step, serial with it
    with open(os.path.join(result, 'config.json')) as f:
        exp = config_from_dict(json.load(f))
    loader = iter(TrainDataLoader(build_train_dataset(exp),
                                  exp.train_batch_size, seed=0,
                                  num_workers=exp.data_workers))
    next(loader)
    load_ms = []
    for _ in range(6):
        start = time.time()
        next(loader)
        load_ms.append(1e3 * (time.time() - start))
    step_ms = [1e3 / r['it_per_s'] for r in rows[1:]]
    n_eval = sum(len(seq) for _, seq in dataset.items())
    ckpt_saves = [s for s in saves if s[0] == 'ckpt']
    ema_saves = [s for s in saves if s[0] == 'ema_ckpt']
    print(f'pipeline r50_deaotl pre_vost_2, {exp.data_randomcrop[0]}x'
          f'{exp.data_randomcrop[1]} crops, T={exp.data_seq_len}, B='
          f'{exp.train_batch_size}, fp32: train leg {legs["train"][1]:.1f} '
          f's (model build included), CLI step '
          f'{statistics.median(step_ms):.1f} ms median of steps 2-4 '
          f'({[round(x, 1) for x in step_ms]}), '
          f'{1e3 / statistics.median(step_ms):.3f} it/s; launches across '
          f'training {legs["train"][0]}; losses '
          f'{[round(r["loss"], 4) for r in rows]}')
    print(f'pipeline loader: {statistics.median(load_ms):.1f} ms a batch '
          f'(median of {len(load_ms)} next() after the first, '
          f'{exp.data_workers} threads, {exp.train_batch_size} x '
          f'{exp.data_seq_len} JPEG frames of {PIPELINE_SIZE[0]}x'
          f'{PIPELINE_SIZE[1]}): {[round(x, 1) for x in load_ms]}; '
          f'{statistics.median(load_ms) / statistics.median(step_ms):.3f} '
          f'of the CLI step')
    print(f'pipeline checkpoints: ckpt/ (train state) '
          f'{ckpt_saves[-1][2]:.1f} MB in '
          f'{[round(1e3 * s[1], 1) for s in ckpt_saves]} ms, ema_ckpt/ '
          f'{ema_saves[-1][2]:.1f} MB in '
          f'{[round(1e3 * s[1], 1) for s in ema_saves]} ms')
    print(f'pipeline eval leg: {n_eval} frames of {len(names["val"])} '
          f'sequences ({n_eval - len(names["val"])} propagated), '
          f'{fps:.3f} eval frames/s (the evaluator\'s all-frame FPS), '
          f'{legs["eval"][1]:.1f} s with the model build '
          f'and checkpoint load, launches (B1, B2, B3) {legs["eval"][0]} '
          f'as expected; scores {summary}; ckpt/step_4 EMA = '
          f'ema_ckpt/step_4 on the card; ok in {time.time() - t0:.1f} s')
    return legs['eval'][0], statistics.median(step_ms)


# ---------------------------------------------------------- data parallel
DP_SIZE, DP_T = (129, 129), 5
# the model of phases 9-13b: (name, config overrides)
R50_DEAOTL = ('r50_deaotl', {})
# the settings of 11a: name, config overrides of r50_deaotl, ZeRO-1. The
# trainable BN trains with SGD: AdamW's first steps move a parameter by
# ~lr whatever its gradient, so the trainable BN's near-cancelled
# gradients, rounding in either world, would move it by ~lr in either
DP_SETTINGS = (
    ('adamw', dict(train_remat_policy='none'), False),
    ('adamw_zero1', dict(train_remat_policy='full'), True),
    ('bn_sgd', dict(freeze_bn=False, train_opt='sgd',
                    train_remat_policy='full'), False),
    ('bn_sgd_zero1', dict(freeze_bn=False, train_opt='sgd',
                          train_remat_policy='none'), True),
)
DP_METRICS = ('loss', 'aux_loss', 'pred_loss', 'iou', 'frame_losses',
              'frame_ious')


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn_ranks(n: int, argv, cwd=None):
    """n processes of `python argv...`, ranks of one world on card 0 (each
    its LOCAL_RANK 0, as n hosts of one card each)."""
    port = str(free_port())
    root = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen(
        [sys.executable, *argv], cwd=cwd or root,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK='0',
                 MASTER_ADDR='127.0.0.1', MASTER_PORT=port,
                 PYTHONPATH=root + os.pathsep
                 + os.environ.get('PYTHONPATH', '')),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def wait_ranks(procs, timeout: float):
    """The processes' outputs; raises if one fails or outlives `timeout`
    seconds, after ending them all."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f'rank {r} exited {p.returncode}:\n'
                                 f'{out[-6000:]}')
    return outs


def on_device(tree, device):
    """A checkpoint's nested dicts, lists and tuples with every tensor
    copied to `device` (a copy even where it is there already: a
    state_dict's tensors are the live parameters)."""
    import torch
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_device(v, device) for v in tree)
    return tree.to(device, copy=True) if torch.is_tensor(tree) else tree


def dp_train(torch, setting, world, start=None, arch=R50_DEAOTL,
             dtype: str = 'float32', size=DP_SIZE) -> dict:
    """Two fp32 (or `dtype`) steps of r50_deaotl, or of `arch` (model
    name, config overrides), at 129x129 (or `size`), T=5, gap 1, 3
    objects, in one
    setting, on this rank's rows of a global batch of 2; returns the
    world's metrics of each step, the weights before and after (and the
    names and sizes of their leaves), the EMA, whether every rank holds
    the same, and the kernel launches; whole tensors under tensor
    parallelism. TP_SETTING also returns each step's averaged gradients
    and the weights after the first step, and on rank 0 of a model group
    the trainer's state after it (`state1`: its checkpoint and the
    generator). `start`, such a state1, takes only the second step from
    it."""
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.parallel.dist import same_on_all_ranks
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    from rmem_ocu_tpu_torch.parallel import tp
    from rmem_ocu_tpu_torch.train import optim
    name, overrides, zero1 = setting
    if world.tp > 1:
        overrides = dict(overrides, mesh_shape=(world.data.size, world.tp),
                         mesh_axes=('data', 'model'))
    exp = replace(get_config('pre_vost_2', model=arch[0],
                             data_seq_len=DP_T, train_total_steps=100,
                             **arch[1], **overrides),
                  train_long_term_mem_gap=1, train_zero1=zero1)
    model = build_vos_model(exp.model, device=world.device, seed=0,
                            exp=exp).to(getattr(torch, dtype))
    trainer = Trainer(model, exp, world)
    state = trainer.init_state()
    generator = torch.Generator().manual_seed(1)
    if start is not None:
        state = trainer.load_state_dict(on_device(start['ckpt'],
                                                  world.device))
        generator.set_state(start['generator'])
    flat = lambda d: torch.cat([v.detach().float().reshape(-1)
                                for v in d.values()])
    # whole, gathered over a model group
    weights = lambda: flat({k: v for k, v in
                            tp.whole_state_dict(model).items()
                            if v.is_floating_point()})
    out = {'weights0': weights(), 'steps': [], 'grads': [],
           'leaves': [(k, v.numel()) for k, v in
                      tp.whole_state_dict(model).items()
                      if v.is_floating_point()]}
    # the ranks of a model group take the same rows
    n = 2 // world.data.size
    rows = slice(world.data.rank * n, (world.data.rank + 1) * n)
    clip = optim.clip_by_global_norm
    held = name in (TP_SETTING[0], SP_SETTING[0])

    def capture(grads, *args, **kw):
        # this step's averaged gradients, whole
        out['grads'].append({k: v.cpu() for k, v in
                             trainer._whole(grads).items()})
        return clip(grads, *args, **kw)
    reset_counts()
    for i in range(0 if start is None else 1, 2):
        frames, masks = train_clip(2, DP_T, size, seed=20 + i)
        batch = {'frames': torch.from_numpy(frames[rows]).to(
                     world.device, getattr(torch, dtype)),
                 'masks': torch.from_numpy(masks[rows]).to(world.device),
                 'obj_nums': torch.full((n,), N_OBJ, device=world.device)}
        # phase 12d holds each step's gradients of its setting
        optim.clip_by_global_norm = capture if held else clip
        try:
            state, m = trainer.train_step(state, batch, generator)
        finally:
            optim.clip_by_global_norm = clip
        out['steps'].append({k: torch.as_tensor(m[k]).tolist()
                             for k in DP_METRICS})
        if held and i == 0:
            out['weights1'] = weights()
            if world.tp > 1:
                ckpt = on_device(trainer.state_dict(state), 'cpu')
                if world.model.rank == 0:
                    out['state1'] = {'ckpt': ckpt,
                                     'generator': generator.get_state()}
    torch.cuda.synchronize(world.device)
    out.update(weights=weights(), ema=flat(trainer.ema_state_dict(state)),
               launches=read_counts())
    out['same'] = same_on_all_ranks([out['weights'], out['ema']], world)
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in out.items()}


def dp_worker(out_path: str) -> int:
    """A rank of 11a, in a child process: every setting over a gloo group
    on CUDA tensors; rank 0 writes the results to out_path."""
    import torch
    from rmem_ocu_tpu_torch.parallel import dist
    torch.backends.cudnn.allow_tf32 = False
    world = dist.init_from_env('cuda:0', backend='gloo', timeout_s=600)
    try:
        results = {s[0]: dp_train(torch, s, world) for s in DP_SETTINGS}
        if world.is_main:
            torch.save(results, out_path)
    finally:
        dist.destroy(world)
    return 0


def phase_dp_two_ranks(torch, root: str):
    """11a: two ranks on the one card (gloo over CUDA tensors; NCCL takes
    one rank a card), one sample each, against this process on both, in
    the four DP_SETTINGS. Gates: loss and metrics within 1e-5 (the ious
    of the second step, which count pixels of an argmax, within 1e-3),
    weights and EMA within 1e-4, the weights' change within 1e-2 of its
    L2 norm, both ranks alike, no kernel launched."""
    from rmem_ocu_tpu_torch.parallel.dist import World
    t0 = time.time()
    out = os.path.join(root, 'dp_two_ranks.pt')
    procs = spawn_ranks(2, [os.path.abspath(__file__), '--dp-worker', out])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        one = {s[0]: dp_train(torch, s, World(device=torch.device('cuda')))
               for s in DP_SETTINGS}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        wait_ranks(procs, 900)
    two = torch.load(out)
    launches = tuple(sum(c) for c in zip(*(r[name]['launches'] for r in
                                           (one, two)
                                           for name, _, _ in DP_SETTINGS)))
    for name, _, _ in DP_SETTINGS:
        a, b = one[name], two[name]
        err = 0.0
        for i, (sa, sb) in enumerate(zip(a['steps'], b['steps'])):
            for k in DP_METRICS:
                e = float(np.abs(np.subtract(sb[k], sa[k])).max())
                check(e <= (1e-3 if i and 'iou' in k else 1e-5),
                      f'11a {name}: {k} of step {i + 1} off by {e}')
                if 'iou' not in k:
                    err = max(err, e)
        moved = a['weights'] - a['weights0']
        dw = float((b['weights'] - a['weights']).abs().max())
        de = float((b['ema'] - a['ema']).abs().max())
        rel = float((b['weights'] - b['weights0'] - moved).norm()
                    / moved.norm())
        check(torch.equal(a['weights0'], b['weights0']) and dw <= 1e-4
              and de <= 1e-4 and rel <= 1e-2 and b['same'],
              f'11a {name}: weights {dw}, EMA {de}, change {rel}, ranks '
              f'alike {b["same"]}')
        check(a['launches'] == b['launches'] == (0, 0, 0),
              f'11a {name}: training launched {a["launches"]}, '
              f'{b["launches"]}')
        losses = [[s['loss'] for s in r['steps']] for r in (b, a)]
        print(f'dp 11a {name}: world 2 x B=1 (gloo, CUDA tensors) vs world '
              f'1 x B=2, fp32, 2 steps: losses {losses[0]} vs '
              f'{losses[1]}, max loss/metric diff '
              f'{err:.3g}, weights {dw:.3g}, EMA {de:.3g}, change '
              f'{rel:.3g} of its norm; ranks alike; launches (0, 0, 0)')
    print(f'dp 11a ok in {time.time() - t0:.1f} s')
    return launches, one


def phase_dp_cli(torch, root: str, data: str, pipeline_ms: float):
    """11b: `tools.train.main(['--multihost', '--mesh', '1', '--zero1',
    ...])` in this process over NCCL at world 1, on phase 10's tree at the
    recipe shape (465x465, T=17, B=2, fp32, 4 steps, saves at 2 and 4),
    then step_4 restored on the card. Reports the CLI's step beside phase
    10's, the bytes and CUDA-event time of each all-reduce, and the moment
    bytes a rank holds with ZeRO-1 and without. Returns (the launches
    across training, the result directory)."""
    from rmem_ocu_tpu_torch.config import get_config
    from rmem_ocu_tpu_torch.models import build_vos_model
    from rmem_ocu_tpu_torch.parallel import dist
    from rmem_ocu_tpu_torch.parallel.tp import zero1_dim
    from rmem_ocu_tpu_torch.tools import train as train_tool
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
    t0 = time.time()
    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
               MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    calls = []
    real = dist.all_reduce_

    def timed(tensors, world, mean=False):
        tensors = list(tensors)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(tensors, world, mean)
        end.record()
        calls.append((sum(t.numel() * t.element_size() for t in tensors),
                      start, end))
    dist.all_reduce_ = timed
    reset_counts()
    try:
        train_tool.main(['--multihost', '--mesh', '1', '--zero1', '--stage',
                         'pre_vost_2', '--model', 'r50_deaotl', '--exp_name',
                         'dp', '--datasets', 'vost', '--data_root', data,
                         '--batch_size', '2', '--total_steps', '4',
                         '--save_step', '2', '--log_step', '1'])
        torch.cuda.synchronize()
    finally:
        dist.all_reduce_ = real
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = read_counts()
    check(launches == (0, 0, 0), f'11b: training launched {launches}')
    result = get_config('pre_vost_2', 'dp', 'r50_deaotl').dir_result()
    with open(os.path.join(result, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    check([r['step'] for r in rows] == [1, 2, 3, 4] and all(
        np.isfinite(r['loss']) for r in rows), f'11b: metrics rows {rows}')
    for sub in ('ckpt', 'ema_ckpt'):
        check(ckpt.list_checkpoint_steps(os.path.join(result, sub))
              == [2, 4], f'11b: {sub} steps')
    step_ms = [1e3 / r['it_per_s'] for r in rows[1:]]
    sizes = {}
    for n_bytes, start, end in calls:
        sizes.setdefault(n_bytes, []).append(start.elapsed_time(end))

    # step_4 restored on the card, into a trainer of one process
    exp = get_config('pre_vost_2', 'dp', 'r50_deaotl')
    trainer = Trainer(build_vos_model(exp.model, device='cuda', seed=3),
                      exp)
    state0 = trainer.init_state()
    restored, step = ckpt.restore_checkpoint(
        os.path.join(result, 'ckpt'), trainer.state_dict(state0))
    back = trainer.state_dict(trainer.load_state_dict(restored))
    check(step == 4 and back['step'] == 4 and all(
        torch.equal(back[part][k], v) for part in ('state_dict', 'ema')
        for k, v in restored[part].items()) and all(
        torch.equal(back['opt_state'][m][k], v) for m in ('mu', 'nu')
        for k, v in restored['opt_state'][m].items()),
        '11b: ckpt/step_4 does not restore bitwise')
    # the Adam moments' bytes on a rank: f32 mu and nu, each split over n
    # ranks where zero1_dim finds a dimension
    shapes = [v.shape for v in restored['opt_state']['mu'].values()]
    held = {n: 2 * 4 * sum(
        int(np.prod(s)) // (1 if zero1_dim(s, (), n) is None else n)
        for s in shapes) for n in (1, 2, 4, 8)}
    whole = 2 * 4 * sum(int(np.prod(s)) for s in shapes)
    print(f'dp 11b train CLI --multihost --mesh 1 --zero1 (NCCL, world 1), '
          f'r50_deaotl 465x465, T={exp.data_seq_len}, B=2, fp32: CLI step '
          f'{statistics.median(step_ms):.1f} ms median of steps 2-4 '
          f'({[round(x, 1) for x in step_ms]}) against phase 10\'s '
          f'{pipeline_ms:.1f} ms; launches across training {launches}; '
          f'losses {[round(r["loss"], 4) for r in rows]}')
    print('dp 11b all-reduces (bytes, calls, median / max ms by CUDA '
          'events): ' + '; '.join(
              f'{b} B x{len(v)} {statistics.median(v):.3f} / {max(v):.3f}'
              for b, v in sorted(sizes.items(), reverse=True)))
    print(f'dp 11b Adam moments a rank holds: {whole / 2 ** 20:.1f} MB '
          f'without ZeRO-1; with it (from the shapes) ' + ', '.join(
              f'world {n}: {b / 2 ** 20:.1f} MB' for n, b in held.items())
          + f'; step_4 restored bitwise on the card; ok in '
            f'{time.time() - t0:.1f} s')
    return launches, result


def phase_dp_eval(torch, root: str, data: str, result: str, want):
    """11c: the eval CLI of 11b's step_4 EMA over the val split in two
    processes on the card (RANK 0 and 1, no group) and in this process.
    Gates: the two ranks' masks together equal this process's, file for
    file; their B1, B2, B3 launches sum to this process's and to phase
    10's eval leg; print.log is rank 0's. Returns the ranks' launches."""
    from PIL import Image
    from rmem_ocu_tpu_torch.tools import eval as eval_tool
    t0 = time.time()
    argv = ['--stage', 'pre_vost_2', '--model', 'r50_deaotl', '--exp_name',
            'dp', '--dataset', 'vost', '--data_root', data, '--ckpt_path',
            os.path.join(result, 'ema_ckpt'), '--ckpt_step', '4',
            '--output']
    two, one = os.path.join(root, 'eval_two'), os.path.join(root, 'eval_one')
    procs = spawn_ranks(2, [os.path.abspath(__file__), '--cli-worker',
                            'eval', json.dumps(argv + [two])],
                        cwd=os.getcwd())
    try:
        reset_counts()
        eval_tool.main(argv + [one])
        torch.cuda.synchronize()
        mine = read_counts()
    finally:
        outs = wait_ranks(procs, 900)
    ranks = rank_counts(outs)
    total = tuple(sum(c) for c in zip(*ranks))
    check(len(ranks) == 2 and total == mine == tuple(want),
          f'11c: launches by rank {ranks}, one process {mine}, phase 10 '
          f'{want}')
    n_masks = 0
    for seq in sorted(os.listdir(one)):
        if not os.path.isdir(os.path.join(one, seq)):
            continue
        names = sorted(os.listdir(os.path.join(one, seq)))
        check(names == sorted(os.listdir(os.path.join(two, seq))),
              f'11c: masks of {seq}')
        for name in names:
            check(np.array_equal(
                np.asarray(Image.open(os.path.join(one, seq, name))),
                np.asarray(Image.open(os.path.join(two, seq, name)))),
                f'11c: {seq}/{name} differs between 2 ranks and 1')
            n_masks += 1
    with open(os.path.join(two, 'print.log')) as f:
        log = f.read()
    check('[rank 0]' in log and '[rank 1]' not in log,
          '11c: print.log is not rank 0\'s alone')
    print(f'dp 11c eval CLI in 2 processes on the card (RANK 0 and 1): '
          f'launches (B1, B2, B3) by rank {ranks}, sum {total} = one '
          f'process = phase 10; {n_masks} masks equal file for file; ok in '
          f'{time.time() - t0:.1f} s')
    return total, one, mine


# ------------------------------------------------- 12: tensor parallelism
TP = 2                          # the model group of phase 12
TP_PATHS = ('deaot_1head', 'aot', 'deaot_2heads')
TP_FRAMES, TP_WARM, TP_TIMED = 12, 3, 10
TP_SETTING = DP_SETTINGS[1]     # AdamW, ZeRO-1, remat 'full'
# 13: TP_SETTING with the model group splitting the image's rows
SP_SETTING = ('adamw_zero1_spatial', dict(TP_SETTING[1],
                                          train_spatial_sharding=True), True)


def phase_tp_kernels(torch, whole_rows):
    """12a: each kernel at the shard shapes a rank of a model group of M
    reads on the 23x40 grid, B=1 and B=8, against its plain version: B1
    with one head and V, ID_V 512/M wide, B1 with 8/M AOT heads (M=4: 2
    heads, the wide-head kernel), B3 with two heads of 512/M (M=2), B2 with
    E=1024/M. Prints each row's share of its bound beside the whole
    shape's (phase 3)."""
    rows, bf16 = {}, torch.bfloat16
    for batch in (1, 8):
        for m in (2, 4):
            name = f'b1_tp{m}_bf16_B{batch}'
            rows[name] = b1_row(torch, name, batch, bf16, False, BF16_TOL,
                                dict(cvs=(512 // m,) * 2))
            name = f'b1mh_tp{m}_bf16_B{batch}'
            rows[name] = b1_row(torch, name, batch, bf16, False, BF16_TOL,
                                dict(heads=8 // m, d=32, cvs=(32,)))
            name = f'b2_tp{m}_bf16_B{batch}'
            rows[name] = b2_row(torch, name, batch, bf16, BF16_TOL, GRID,
                                1024 // m)
        name = f'b3_tp2_bf16_B{batch}'
        rows[name] = b3_row(torch, name, batch, bf16, 256)
    for name, row in rows.items():
        kind, _, _, batch = name.split('_')
        whole = whole_rows[f'{kind}_bf16_{batch}']
        print(f'kernel {name}: {row["ms"]:.4f} ms, share of bound '
              f'{row["bound_share"]:.3f}; the whole shape {whole["ms"]:.4f} '
              f'ms, share {whole["bound_share"]:.3f}')
    return rows


def tp_serve_fp32(torch, path: str, world):
    """The fp32 engine of `path` on this rank's shard of the model group
    of `world` (the whole model at one process) on the card, 353x625, one
    reference frame and TP_FRAMES frames at write gap 1: the bank's
    ordered frame ids after each update, the masks, the logits of the
    objects and the kernel launches."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    from rmem_ocu_tpu_torch.parallel import tp
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exp = get_config('pre_vost_2', **spec_of(path)['overrides'])
    model = build_vos_model(exp.model, device=world.device, seed=0)
    tp.shard_model(model, world.model)
    eng = InferEngine(model, exp, long_term_mem_gap=1)
    img0, mask0, frames = make_inputs(1, TP_FRAMES, seed=3,
                                      independent=exp.model.vos == 'aot')
    state = eng.init_state(1, GRID)
    reset_counts()
    state = eng.add_reference_frame(state, torch.from_numpy(img0),
                                    torch.from_numpy(mask0),
                                    torch.tensor([N_OBJ]))
    out = dict(ids=[], preds=[], logits=[])
    for f in frames:
        logits, state = eng.propagate(state, torch.from_numpy(f))
        pred = eng.predict_mask(logits, (H, W))
        state = eng.update_memory(state, pred)
        out['ids'].append(state.bank.ordered_frame_ids.cpu())
        out['preds'].append(pred.to(torch.uint8).cpu())
        out['logits'].append(logits[..., :N_OBJ + 1].float().cpu())
    torch.cuda.synchronize(world.device)
    out['launches'] = read_counts()
    return out


def bank_bytes(state) -> int:
    bank = state.bank
    return sum(x.numel() * x.element_size()
               for x in bank.k + bank.v + (bank.id_v or []))


def tp_serve_bf16(torch, path: str, batch: int, world):
    """The bf16 main path of `path` on this rank's shard, 353x625, 3
    objects, `batch` streams at the path's gap: the bank bytes the rank
    holds, the launches, the median frame time (CUDA events) and the
    collectives a frame (count and bytes of the all-reduces, which also
    carry the gathers) over the timed frames."""
    import torch.distributed as tdist
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    from rmem_ocu_tpu_torch.parallel import tp
    spec = spec_of(path)
    exp = get_config('pre_vost_2', compute_dtype='bfloat16',
                     **spec['overrides'])
    model = build_vos_model(exp.model, device=world.device, seed=0)
    tp.shard_model(model, world.model)
    model = model.to(torch.bfloat16)
    eng = InferEngine(model, exp, long_term_mem_gap=spec['gap'])
    img0, mask0, frames = make_inputs(batch, 8, seed=5)
    frames = [torch.from_numpy(f).to(world.device) for f in frames]
    state = eng.init_state(batch, GRID)
    held = bank_bytes(state)
    reset_counts()
    state = eng.add_reference_frame(state, torch.from_numpy(img0),
                                    torch.from_numpy(mask0),
                                    torch.full((batch,), N_OBJ))
    calls, real = [], tdist.all_reduce

    def counted(t, *args, **kw):
        calls.append(t.numel() * t.element_size())
        return real(t, *args, **kw)
    events = []
    try:
        for i in range(TP_WARM + TP_TIMED):
            if i == TP_WARM:
                tdist.all_reduce = counted
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, state = eng.propagate(state, frames[i % len(frames)])
            pred = eng.predict_mask(logits, (H, W))
            state = eng.update_memory(state, pred)
            end.record()
            if i >= TP_WARM:
                events.append((start, end))
    finally:
        tdist.all_reduce = real
    torch.cuda.synchronize(world.device)
    counts = read_counts()
    n = TP_WARM + TP_TIMED
    want = expected_counts(path, n, batch=batch, grid=GRID, shards=TP)
    check(counts == want, f'12b {path} B={batch}: launches {counts} for '
                          f'{n} frames, expected {want}')
    check(bool(torch.isfinite(logits[..., :N_OBJ + 1].float()).all()),
          f'12b {path} B={batch}: non-finite logits')
    return dict(bank_bytes=held, launches=counts,
                frame_ms=statistics.median(s.elapsed_time(e)
                                           for s, e in events),
                collectives=len(calls) / TP_TIMED,
                collective_bytes=sum(calls) / TP_TIMED)


GRAD_TOL = 2e-3   # 12d: a gradient's difference over its leaf's largest


def by_leaf(torch, leaves, flat):
    """A flat vector of dp_train's weights cut into its leaves."""
    return dict(zip([k for k, _ in leaves],
                    torch.split(flat, [n for _, n in leaves])))


def step_gaps(torch, leaves, ga, gb, ua, ub):
    """One training step of a 1 x M world (averaged gradients gb, weight
    update ub) against one process's from the same state (ga, ua), leaf
    by leaf: the gradient's largest difference over the leaf's largest
    magnitude, and the update's gap over its norm on the elements whose
    reference gradient exceeds twice the leaf's largest difference, so
    that its sign is the same in both worlds. An element nearer 0 may
    change sign between them, and AdamW then moves it by ~lr the other
    way whatever its size. A leaf whose largest gradient lies below 1e-6
    of the step's global gradient norm in both worlds is zero but for
    rounding (an AOT self-attention's key bias: the softmax ignores a
    per-query constant) and is left out, as phase 9a leaves it out.
    Returns ((gradient difference, leaf), (update gap, leaf), elements
    with a gradient left out of the update's gap, elements with a
    gradient)."""
    ua, ub = by_leaf(torch, leaves, ua), by_leaf(torch, leaves, ub)
    worst_g, worst_u, left, total = (0.0, ''), (0.0, ''), 0, 0
    norm = float(sum(float(g.double().square().sum())
                     for g in ga.values())) ** 0.5
    for k, g in ga.items():
        g, h = g.float().reshape(-1), gb[k].float().reshape(-1)
        if max(float(g.abs().max()), float(h.abs().max())) < 1e-6 * norm:
            continue
        top = max(float(g.abs().max()), 1e-30)
        diff = float((h - g).abs().max())
        worst_g = max(worst_g, (diff / top, k))
        keep = g.abs() > 2 * diff
        x, y = ua[k][keep], ub[k][keep]
        worst_u = max(worst_u, (float((y - x).norm())
                                / max(float(x.norm()), 1e-30), k))
        live = g != 0
        left += int((live & ~keep).sum())
        total += int(live.sum())
    return worst_g, worst_u, left, total


def sign_flip_share(torch, a, b):
    """What of the two-step change's gap between one process (a) and a
    1 x M world (b) lies on the elements whose averaged gradient changes
    sign between them at either step: (their count, their share of the
    squared gap, the largest of their step-1 reference gradients over its
    leaf's largest, the leaves that carry most of the gap with their
    share)."""
    gap = by_leaf(torch, a['leaves'], (b['weights'] - b['weights0'])
                  - (a['weights'] - a['weights0']))
    count, on, whole, top, share = 0, 0.0, 0.0, 0.0, []
    for k, d in gap.items():
        whole += float(d.square().sum())
        if k not in a['grads'][0]:
            continue
        flips = torch.zeros(d.numel(), dtype=torch.bool)
        for ga, gb in zip(a['grads'], b['grads']):
            flips |= (ga[k].reshape(-1) > 0) != (gb[k].reshape(-1) > 0)
        g1 = a['grads'][0][k].float().reshape(-1).abs()
        step1 = ((a['grads'][0][k] > 0) != (b['grads'][0][k] > 0)).reshape(-1)
        if step1.any():
            top = max(top, float(g1[step1].max() / g1.max()))
        count += int(flips.sum())
        on += float(d[flips].square().sum())
        share.append((float(d.square().sum()), k))
    share = [(k, round(v / whole, 3)) for v, k in sorted(share)[::-1][:3]]
    return count, on / whole, top, share


def tp_worker(spec_path: str) -> int:
    """A rank of 12b and 12d, in a child process, a model group of two on
    card 0 over gloo (NCCL takes one rank a card): the fp32 serving of
    each TP path, the training steps of TP_SETTING, then, once this
    script's own runs are done (the spec's `go` file), the bf16 main
    paths. Each rank writes its results."""
    import torch
    from rmem_ocu_tpu_torch.parallel import dist
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    world = dist.init_from_env('cuda:0', backend='gloo', timeout_s=900,
                               tp=TP)
    try:
        out = {'fp32': {p: tp_serve_fp32(torch, p, world)
                        for p in TP_PATHS}}
        out['train'] = dp_train(torch, TP_SETTING, world)
        deadline = time.time() + 900
        while not os.path.exists(spec['go']):
            check(time.time() < deadline, '12: no go from the parent')
            time.sleep(0.2)
        out['bf16'] = {(p, b): tp_serve_bf16(torch, p, b, world)
                       for p in TP_PATHS for b in (1, 8)}
        torch.save(out, f'{spec["out"]}.rank{world.rank}')
    finally:
        dist.destroy(world)
    return 0


def phase_tp_serving(torch, root: str, dp_one: dict):
    """12b and 12d's trainer: two ranks on the card in child processes
    (`--tp-worker`), one model group of M=2 over gloo, against this
    process. fp32 at write gap 1 (eviction fires), per TP path: eviction
    ids identical at every update on both ranks, more than 99.9% of mask
    pixels equal to this process's, both ranks' masks equal, each rank's
    launches those of one process. bf16 at 1 and 8 streams: the bank
    bytes a rank holds against this process's (AOT half, DeAOT its whole
    keys and half its values), the collectives a frame, the frame time
    (gloo through the host on one card: written down, not compared).
    Training: TP_SETTING's two fp32 steps at 129x129 against 11a's one
    process: losses within 1e-5, weights and EMA within 1e-4, the ranks
    alike, no kernel launched; and each step against one process's from
    the same state (the second from the world's state after the first):
    each leaf's averaged gradient within GRAD_TOL of its largest
    magnitude, and its update within 1e-2 of its norm on the elements
    whose gradient keeps its sign (step_gaps). Returns the launches by
    path."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    from rmem_ocu_tpu_torch.parallel.dist import World
    t0 = time.time()
    spec = dict(out=os.path.join(root, 'tp'), go=os.path.join(root, 'tp.go'))
    spec_path = os.path.join(root, 'tp.json')
    with open(spec_path, 'w') as f:
        json.dump(spec, f)
    procs = spawn_ranks(2, [os.path.abspath(__file__), '--tp-worker',
                            spec_path])
    one_world = World(device=torch.device('cuda'))
    held = {}
    try:
        one = {p: tp_serve_fp32(torch, p, one_world) for p in TP_PATHS}
        for p in TP_PATHS:
            exp = get_config('pre_vost_2', compute_dtype='bfloat16',
                             **spec_of(p)['overrides'])
            eng = InferEngine(build_vos_model(exp.model, seed=0).to(
                torch.bfloat16), exp)
            for b in (1, 8):
                held[p, b] = bank_bytes(eng.init_state(b, GRID))
            del eng
    finally:
        open(spec['go'], 'w').close()
        wait_ranks(procs, 1200)
    ranks = [torch.load(f'{spec["out"]}.rank{r}') for r in range(TP)]
    counts = {}
    for p in TP_PATHS:
        a = one[p]
        want = expected_counts(p, TP_FRAMES)
        worst_agree, worst_logit = 1.0, 0.0
        for r, got in enumerate(x['fp32'][p] for x in ranks):
            for t, (x, y) in enumerate(zip(a['ids'], got['ids'])):
                check(torch.equal(x, y), f'12b {p} rank {r} update {t}: '
                                         f'eviction ids {y} vs {x}')
            for x, y in zip(a['preds'], got['preds']):
                worst_agree = min(worst_agree,
                                  float((x == y).float().mean()))
            for x, y in zip(a['logits'], got['logits']):
                worst_logit = max(worst_logit, max_err(x, y))
            check(got['launches'] == a['launches'] == want,
                  f'12b {p} rank {r}: launches {got["launches"]}, one '
                  f'process {a["launches"]}, expected {want}')
        check(worst_agree > 0.999, f'12b {p}: mask agreement {worst_agree}')
        check(all(torch.equal(x, y) for x, y in zip(
            ranks[0]['fp32'][p]['preds'], ranks[1]['fp32'][p]['preds'])),
            f'12b {p}: the ranks\' masks differ')
        final = set(a['ids'][-1][0].tolist())
        evicted = sorted(set(range(1, TP_FRAMES + 1)) - final)
        check(evicted, f'12b {p}: no eviction ({sorted(final)})')
        print(f'tp 12b {p} fp32 353x625, M={TP} (gloo, CUDA tensors) vs '
              f'one process, {TP_FRAMES} frames at gap 1: eviction ids '
              f'identical at every update on both ranks (frames {evicted} '
              f'evicted), worst mask agreement {worst_agree:.6f}, worst '
              f'|logit diff| {worst_logit:.3e}, ranks\' masks equal, '
              f'launches (B1, B2, B3) a rank {want}')
        model_cfg = get_config('pre_vost_2', **spec_of(p)['overrides']).model
        for b in (1, 8):
            res = [x['bf16'][p, b] for x in ranks]
            d = model_cfg.encoder_embedding_dim
            deaot = model_cfg.vos == 'deaot'
            ck = (d // 2 if model_cfg.att_heads == 1 else d) if deaot else d
            cv, nv = (2 * d, 2) if deaot else (d, 1)
            want_held = held[p, b] * (ck / (1 if deaot else TP)
                                      + nv * cv / TP) / (ck + nv * cv)
            check(all(x['bank_bytes'] == want_held for x in res),
                  f'12b {p} B={b}: bank bytes a rank '
                  f'{[x["bank_bytes"] for x in res]}, expected {want_held}')
            print(f'tp 12b {p} bf16 353x625 {N_OBJ} objects streams={b}, '
                  f'M={TP}: bank {res[0]["bank_bytes"] / 2 ** 20:.2f} MiB a '
                  f'rank against {held[p, b] / 2 ** 20:.2f} MiB in one '
                  f'process; {res[0]["collectives"]:.1f} all-reduces a frame '
                  f'a rank, {res[0]["collective_bytes"] / 2 ** 20:.3f} MiB; '
                  f'frame time (gloo through the host) '
                  f'{[round(x["frame_ms"], 3) for x in res]} ms by rank; '
                  f'launches {res[0]["launches"]}')
        counts[f'tp_{p}'] = ranks[0]['bf16'][p, 1]['launches']

    counts['tp_train'] = tp_training(torch, dp_one, ranks, one_world)
    print(f'tp 12b/12d ok in {time.time() - t0:.1f} s')
    return counts, ranks[0]['train']


def tp_training(torch, dp_one: dict, ranks: list, one_world,
                setting=TP_SETTING, tag: str = 'tp 12d', arch=R50_DEAOTL,
                dtype: str = 'float32', size=DP_SIZE):
    """12d's gates on a trainer of a 1 x M world in `setting` (`ranks`'
    results, TP_SETTING's by default) against 11a's one process in
    TP_SETTING (`dp_one`; spatial sharding is a no-op at one process),
    both training `arch` in `dtype` at `size`; see phase_tp_serving.
    Returns rank 0's kernel launches."""
    # the trainer of a 1 x 2 world against 11a's one process, and its
    # second step against one process's from the world's first
    name = setting[0]
    key = 'train' if setting is TP_SETTING else 'spatial'
    a, b = dp_one[TP_SETTING[0]], ranks[0][key]
    a2 = dp_train(torch, setting, one_world, start=b.pop('state1'),
                  arch=arch, dtype=dtype, size=size)
    err = 0.0
    for i, (sa, sb) in enumerate(zip(a['steps'], b['steps'])):
        for k in DP_METRICS:
            e = float(np.abs(np.subtract(sb[k], sa[k])).max())
            check(e <= (1e-3 if i and 'iou' in k else 1e-5),
                  f'{tag} {name}: {k} of step {i + 1} off by {e}')
            if 'iou' not in k:
                err = max(err, e)
    moved_a = a['weights'] - a['weights0']
    dw = float((b['weights'] - a['weights']).abs().max())
    de = float((b['ema'] - a['ema']).abs().max())
    rel = float((b['weights'] - b['weights0'] - moved_a).norm()
                / moved_a.norm())
    check(torch.equal(a['weights0'], b['weights0'])
          and torch.equal(a2['weights0'], b['weights1']) and dw <= 1e-4
          and de <= 1e-4 and b['same'] and ranks[1][key]['same'],
          f'{tag} {name}: weights {dw}, EMA {de}, ranks alike {b["same"]}')
    # each step from the same state: step 1 from the common start, step 2
    # from the world's state after step 1; a gradient part summed wrongly
    # over the group would be off by ~1 of its leaf's largest, an update
    # made wrongly from a right gradient by ~1 of its norm
    steps = (step_gaps(torch, a['leaves'], a['grads'][0], b['grads'][0],
                       a['weights1'] - a['weights0'],
                       b['weights1'] - b['weights0']),
             step_gaps(torch, a['leaves'], a2['grads'][0], b['grads'][1],
                       a2['weights'] - a2['weights0'],
                       b['weights'] - b['weights1']))
    for i, ((dg, gleaf), (du, uleaf), left, total) in enumerate(steps):
        check(dg <= GRAD_TOL and du <= 1e-2,
              f'{tag} {name} step {i + 1} from one state: gradient {dg} of '
              f'its leaf\'s largest ({gleaf}), update {du} of its norm '
              f'({uleaf})')
    e2 = max(float(np.abs(np.subtract(a2['steps'][0][k],
                                      b['steps'][1][k])).max())
             for k in ('loss', 'frame_losses'))
    check(e2 <= 1e-5, f'{tag} {name}: step 2 from one state, losses off by '
                      f'{e2}')
    check(all(x[key]['launches'] == (0, 0, 0) for x in ranks),
          f'{tag}: training launched {[x[key]["launches"] for x in ranks]}')
    flips, flip_share, flip_g, leaves = sign_flip_share(torch, a, b)
    print(f'{tag} trainer 1 x {TP} (gloo, CUDA tensors) {arch[0]} '
          f'{arch[1] or ""} {name} vs one process, {dtype} '
          f'{size[0]}x{size[1]}, '
          f'T={DP_T}, 2 steps: losses '
          f'{[s["loss"] for s in b["steps"]]} vs '
          f'{[s["loss"] for s in a["steps"]]}, max loss/metric diff '
          f'{err:.3g}, weights {dw:.3g}, EMA {de:.3g}; ranks alike; '
          f'launches (0, 0, 0)')
    for i, ((dg, gleaf), (du, uleaf), left, total) in enumerate(steps):
        print(f'{tag} step {i + 1} from one state (step 2: one process '
              f'from the world\'s state after step 1, its frame losses '
              f'within {e2:.3g}): gradient {dg:.3g} of its leaf\'s largest '
              f'({gleaf}); update {du:.3g} of its norm ({uleaf}) on the '
              f'elements whose gradient exceeds twice its leaf\'s largest '
              f'difference ({left} of the {total} with a gradient left '
              f'out)')
    print(f'{tag} the two steps\' change {rel:.3g} of its norm (not '
          f'gated): {flips} elements whose gradient changes sign between '
          f'the worlds at step 1 or 2 carry {flip_share:.3f} of its square '
          f'(at step 1 each within {flip_g:.3g} of its leaf\'s largest); '
          f'largest shares by leaf {leaves}')
    return b['launches']


# ------------------------------------------------- 13: spatial sharding
# 13c: the encoders banded since r50_deaotl's (name, model, overrides);
# the first two also at the recipe shape, one step each
SP_ENCODERS = (
    ('resnest101', ('rs101_aotl', {})),
    ('topdown', ('r50_topdown_aotl', {})),
    ('topdown_oracle', ('r50_topdown_aotl', dict(oracle=True))),
    ('mobilenetv3', ('aotl', dict(encoder='mobilenetv3',
                                  encoder_dim=(24, 40, 112, 960)))))
# 13c's training against one process runs in float64: in float32 the
# split-attention pool's mean of a map whose signs cancel feeds a ReLU, and
# the rounding of any order of its sums flips kinks behind it (the world's
# step-1 gradients of ResNeSt-101's first layer-2 and layer-3 blocks were
# up to 15% of a leaf's largest off one process's in float32, within 1e-6
# in float64)
SP_ENC_DTYPE = 'float64'
# 13d: Swin-B under the knob (name, (model, overrides)), against one
# process in SP_ENC_DTYPE at SP_SWIN_SIZE (multiples of 16: the id bank's
# 16x16 conv takes whole grid cells; at M=2, 128 px has unshifted halos,
# a wrap that carries a real row and a padded bottom at stride 4); the
# first also at the recipe shape (464x464), one step
SP_SWIN = (('swinb_deaotl', ('swinb_deaotl', {})),
           ('swinb_aotl', ('swinb_aotl', {})))
SP_SWIN_SIZE = (128, 128)


def sp_bf16(torch, world, spatial_on: bool, arch=R50_DEAOTL) -> dict:
    """13b-13d on this rank: one bf16 AMP step of r50_deaotl (or of
    `arch`) at the recipe shape (465x465, 464x464 for Swin, T=17, gap 4,
    B=2, remat 'full') on a 1 x M world with the knob on or off (TP
    alone), or in one process (`world` without a group). One step: its
    peak, cuDNN's choice of algorithms included, lay within 3% of the
    next step's in every run of two. Returns the step's peak memory above
    the memory held before the model was built and where it lies (the
    memory held before the step, after its episode's forward and the
    forward's peak, against the step's), its CUDA-event ms, its halo
    exchanges and gathers with their bytes, the launches and the loss."""
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.parallel import spatial
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    mesh = {} if world.tp == 1 else dict(mesh_shape=(1, world.tp),
                                         mesh_axes=('data', 'model'))
    exp = replace(get_config('pre_vost_2', model=arch[0], train_amp=True,
                             **arch[1], **mesh),
                  train_spatial_sharding=spatial_on)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.empty_cache()
    torch.cuda.synchronize(world.device)
    base = torch.cuda.memory_allocated(world.device)
    torch.cuda.reset_peak_memory_stats(world.device)
    model = build_vos_model(exp.model, device=world.device, seed=0, exp=exp)
    trainer = Trainer(model, exp, world)
    state = trainer.init_state()
    frames, masks = train_clip(2, exp.data_seq_len, exp.data_randomcrop,
                               seed=2)
    batch = {'frames': torch.from_numpy(frames).to(world.device),
             'masks': torch.from_numpy(masks).to(world.device),
             'obj_nums': torch.full((2,), N_OBJ, device=world.device)}
    gen = torch.Generator().manual_seed(7)
    reset_counts()
    above = lambda f: (f(world.device) - base) / 2 ** 30
    out = {'size': tuple(exp.data_randomcrop),
           'marks': {'held': above(torch.cuda.memory_allocated)}}
    episode = trainer.engine.episode_loss

    def marked(*args, **kw):
        result = episode(*args, **kw)
        torch.cuda.synchronize(world.device)
        out['marks'].update(
            after_forward=above(torch.cuda.memory_allocated),
            forward_peak=above(torch.cuda.max_memory_allocated))
        return result
    trainer.engine.episode_loss = marked
    spatial.reset_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, m = trainer.train_step(state, batch, gen)
    end.record()
    end.synchronize()
    out['marks']['step_peak'] = above(torch.cuda.max_memory_allocated)
    out.update(step_ms=start.elapsed_time(end), stats=dict(spatial.STATS),
               loss=float(m['loss']),
               peak=torch.cuda.max_memory_allocated(world.device) - base,
               launches=read_counts())
    del model, trainer, state
    torch.cuda.empty_cache()
    return out


def sp_worker(spec_path: str) -> int:
    """A rank of 13, in a child process, a model group of two on card 0
    over gloo: 13a's fp32 training of SP_SETTING, then 13b's bf16 steps
    with the knob off and on; then rank 0 takes 13b's steps in one
    process while rank 1 waits; 13c's float64 training of SP_SETTING for
    each of SP_ENCODERS (after 13a, before any bf16 step turns TF32 on)
    and its bf16 steps with the knob off and on for the first two; 13d's
    the same for SP_SWIN at SP_SWIN_SIZE, bf16 for the first. The spec's
    `parts` (default all of '13a', '13b', '13c', '13d') picks what runs.
    Each rank writes its results."""
    import torch
    from rmem_ocu_tpu_torch.parallel import dist
    from rmem_ocu_tpu_torch.parallel.dist import World
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    world = dist.init_from_env('cuda:0', backend='gloo', timeout_s=900,
                               tp=TP)
    try:
        parts = spec.get('parts', ('13a', '13b', '13c', '13d'))
        out, t0 = {}, time.time()

        def lap(part: str) -> None:
            """The seconds of `part` on this rank, under ('seconds', part)."""
            nonlocal t0
            out['seconds', part] = time.time() - t0
            t0 = time.time()
        if '13a' in parts:
            out['spatial'] = dp_train(torch, SP_SETTING, world)
            lap('13a')
        if '13c' in parts:
            for name, arch in SP_ENCODERS:
                out['13c', name] = dp_train(torch, SP_SETTING, world,
                                            arch=arch, dtype=SP_ENC_DTYPE)
            lap('13c float64')
        if '13d' in parts:
            for name, arch in SP_SWIN:
                out['13d', name] = dp_train(
                    torch, SP_SETTING, world, arch=arch, dtype=SP_ENC_DTYPE,
                    size=SP_SWIN_SIZE)
            lap('13d float64')
        if '13b' in parts:
            for on in (False, True):
                out['bf16', on] = sp_bf16(torch, world, on)
            if world.is_main:
                out['bf16_one'] = sp_bf16(torch, World(device=world.device),
                                          True)
            dist.agree(False, world)
            lap('13b bf16')
        if '13c' in parts:
            for name, arch in SP_ENCODERS[:2]:
                for on in (False, True):
                    out['13c bf16', name, on] = sp_bf16(torch, world,
                                                        on, arch)
            lap('13c bf16')
        if '13d' in parts:
            for on in (False, True):
                out['13d bf16', on] = sp_bf16(torch, world, on,
                                              SP_SWIN[0][1])
            lap('13d bf16')
        torch.save(out, f'{spec["out"]}.rank{world.rank}')
    finally:
        dist.destroy(world)
    return 0


# 13's parts, on two pairs of ranks at once (the steps of a pair are
# bound by the host, not the card)
SP_PARTS = (('13a', '13c'), ('13b', '13d'))


def spatial_ranks(torch, root: str, parts=SP_PARTS, meanwhile=None
                  ) -> list:
    """The results of phase 13's ranks on the card in child processes
    (`--sp-worker`, gloo over CUDA tensors; each rank trains on its band
    of the image's rows): each item of `parts`, a part or a tuple of
    parts, runs on a pair of ranks of its own, all pairs at once, and
    each rank's results are merged over the pairs. `meanwhile()`, when
    given, runs in this process while they train."""
    procs, outs = [], []
    for i, group in enumerate(parts):
        group = (group,) if isinstance(group, str) else group
        outs.append(os.path.join(root, f'sp{i}'))
        spec_path = os.path.join(root, f'sp{i}.json')
        with open(spec_path, 'w') as f:
            json.dump(dict(out=outs[-1], parts=list(group)), f)
        procs += spawn_ranks(TP, [os.path.abspath(__file__), '--sp-worker',
                                  spec_path])
    try:
        if meanwhile is not None:
            meanwhile()
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    wait_ranks(procs, 1200)
    return [{k: v for out in outs
             for k, v in torch.load(f'{out}.rank{r}').items()}
            for r in range(TP)]


def phase_spatial(torch, ranks: list, dp_one: dict, tp_train: dict):
    """13a and 13b: `train_spatial_sharding` on a 1 x 2 world, the two
    ranks' results (spatial_ranks). 13a: SP_SETTING's two
    fp32 steps at 129x129, T=5, gap 1, against 11a's one process with
    12d's gates (tp_training: losses 1e-5, weights and EMA 1e-4, each
    step from one state with each leaf's gradient within GRAD_TOL of its
    largest and its update within 1e-2, the ranks alike, 0 launches), and
    against 12d's 1 x 2 world without the knob (losses 1e-5, weights and
    EMA 1e-4, step 1's gradients within GRAD_TOL of each leaf's largest).
    13b: bf16 AMP at the recipe shape, one step each with the knob
    off (tensor parallelism alone), on, and in one process: the peak
    memory a rank, the halo exchanges and gathers a step with their MB,
    the step time (gloo through the host on one card: written down, not
    compared), finite losses and 0 launches. Gate: the peak a rank
    lower with the knob than without (print_sp_bf16). Returns the
    launches."""
    from rmem_ocu_tpu_torch.parallel.dist import World
    t0 = time.time()
    one_world = World(device=torch.device('cuda'))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        launches = tp_training(torch, dp_one, ranks, one_world, SP_SETTING,
                               'sp 13a')
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # 13a against 12d's world without the knob
    b = ranks[0]['spatial']
    err = max(float(np.abs(np.subtract(x[k], y[k])).max())
              for x, y in zip(b['steps'], tp_train['steps'])
              for k in ('loss', 'aux_loss', 'pred_loss', 'frame_losses'))
    dw = float((b['weights'] - tp_train['weights']).abs().max())
    de = float((b['ema'] - tp_train['ema']).abs().max())
    dg, leaf = max((float((b['grads'][0][k] - g).abs().max())
                    / max(float(g.abs().max()), 1e-6), k)
                   for k, g in tp_train['grads'][0].items())
    check(err <= 1e-5 and dw <= 1e-4 and de <= 1e-4 and dg <= GRAD_TOL,
          f'13a against 12d without the knob: losses {err}, weights {dw}, '
          f'EMA {de}, step 1 gradient {dg} of its leaf\'s largest ({leaf})')
    print(f'sp 13a against 12d\'s 1 x {TP} without the knob: losses within '
          f'{err:.3g}, weights {dw:.3g}, EMA {de:.3g}, step 1 gradients '
          f'{dg:.3g} of their leaf\'s largest ({leaf})')
    runs = {'one process': ranks[0]['bf16_one']}
    for on, label in ((False, 'TP alone'), (True, 'spatial')):
        for r, x in enumerate(ranks):
            runs[f'{label} rank {r}'] = x['bf16', on]
    print_sp_bf16('sp 13b', R50_DEAOTL, runs)
    print(f'sp 13a/13b gates ok in {time.time() - t0:.1f} s')
    return {'sp_train': launches,
            'sp_bf16': ranks[0]['bf16', True]['launches']}


def print_sp_bf16(tag: str, arch, runs: dict) -> None:
    """13b-13d's gates and lines for bf16 steps of `arch` at the recipe
    shape (label -> sp_bf16's result): a finite loss and 0 launches in
    each; the peak a rank lower with the knob ('spatial rank r') than
    with TP alone ('TP alone rank r')."""
    for label, x in runs.items():
        check(x['launches'] == (0, 0, 0), f'{tag} {label}: launches '
                                          f'{x["launches"]}')
        check(bool(np.isfinite(x['loss'])), f'{tag} {label}: loss '
                                            f'{x["loss"]}')
    peak = {k: v['peak'] / 2 ** 30 for k, v in runs.items()}
    sp_peak = max(peak[f'spatial rank {r}'] for r in range(TP))
    tp_peak = max(peak[f'TP alone rank {r}'] for r in range(TP))
    check(sp_peak < tp_peak, f'{tag} {arch[0]}: peak a rank {sp_peak:.3f} '
                             f'GiB with the knob, {tp_peak:.3f} without')
    for label, x in runs.items():
        st = x['stats']
        size = 'x'.join(map(str, x['size']))
        print(f'{tag} {label}: {arch[0]} {arch[1] or ""} bf16 AMP {size} '
              f'T=17 B=2 remat full, one step: peak memory '
              f'{peak[label]:.3f} GiB above the start; step '
              f'{x["step_ms"]:.1f} ms; {st["halo"]} halo exchanges, '
              f'{st["halo_bytes"] / 2 ** 20:.2f} MiB sent, {st["gather"]} '
              f'gathers, {st["gather_bytes"] / 2 ** 20:.2f} MiB; loss '
              f'{x["loss"]:.4f}; launches {x["launches"]}; in GiB above '
              f'the start: '
              f'{ {k: round(v, 3) for k, v in x["marks"].items()} }')
    print(f'{tag} {arch[0]} peak a rank {sp_peak:.3f} GiB with the knob '
          f'against {tp_peak:.3f} GiB with TP alone '
          f'({sp_peak / tp_peak:.3f}x)' + (
              f' and {peak["one process"]:.3f} GiB in one process'
              if 'one process' in peak else ''))


@contextlib.contextmanager
def no_tf32(torch):
    """f32 convolutions and matmuls in full precision inside."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def sp_models(part: str):
    """(models, clip size) of 13c's or 13d's runs against one process."""
    return (SP_ENCODERS, DP_SIZE) if part == '13c' else (SP_SWIN,
                                                         SP_SWIN_SIZE)


def sp_one_process(torch, part: str) -> dict:
    """The one process of 13c's or 13d's float64 runs (`part`): each
    model's two TP_SETTING steps in SP_ENC_DTYPE on the card ({name:
    dp_train's result}). main() runs them while the ranks train."""
    from rmem_ocu_tpu_torch.parallel.dist import World
    models, size = sp_models(part)
    one_world = World(device=torch.device('cuda'))
    with no_tf32(torch):
        return {name: dp_train(torch, TP_SETTING, one_world, arch=arch,
                               dtype=SP_ENC_DTYPE, size=size)
                for name, arch in models}


def sp_against_one(torch, ranks: list, part: str, ones=None) -> dict:
    """(a) of 13c or 13d (`part`): for each of its models SP_SETTING's two
    steps in SP_ENC_DTYPE on the two ranks (`ranks`, spatial_ranks)
    against one process on the card (`ones`, sp_one_process's, run here
    when None) with 12d's gates (tp_training: losses 1e-5, weights and
    EMA 1e-4, each step from one state with each leaf's gradient within
    GRAD_TOL of its largest and its update within 1e-2, the ranks alike,
    0 launches). Returns the launches."""
    from rmem_ocu_tpu_torch.parallel.dist import World
    t0 = time.time()
    models, size = sp_models(part)
    ones = sp_one_process(torch, part) if ones is None else ones
    one_world = World(device=torch.device('cuda'))
    launches = {}
    with no_tf32(torch):
        for name, arch in models:
            launches[f'sp_{name}'] = tp_training(
                torch, {TP_SETTING[0]: ones[name]},
                [{'spatial': r[part, name]} for r in ranks], one_world,
                SP_SETTING, f'sp {part} {name}', arch, SP_ENC_DTYPE, size)
    print(f'sp {part} {SP_ENC_DTYPE} ok in {time.time() - t0:.1f} s')
    return launches


def phase_spatial_encoders(torch, ranks: list, ones=None) -> dict:
    """13c: the encoders banded since r50_deaotl's under the knob, from
    the two ranks' results (spatial_ranks). (a) SP_ENCODERS (the
    full-depth rs101_aotl, r50_topdown_aotl, the same with oracle=True,
    aotl on MobileNetV3) at 129x129, T=5, gap 1, against one process
    (sp_against_one; `ones`, sp_one_process's). (b) For the first two,
    bf16 AMP at the recipe shape, one step each with the knob
    and with TP alone: 13b's lines and gates (print_sp_bf16). Returns the
    launches."""
    t0 = time.time()
    launches = sp_against_one(torch, ranks, '13c', ones)
    for name, arch in SP_ENCODERS[:2]:
        runs = {f'{label} rank {r}': x['13c bf16', name, on]
                for on, label in ((False, 'TP alone'), (True, 'spatial'))
                for r, x in enumerate(ranks)}
        print_sp_bf16(f'sp 13c {name}', arch, runs)
        launches[f'sp_{name}_bf16'] = runs['spatial rank 0']['launches']
    print(f'sp 13c ok in {time.time() - t0:.1f} s')
    return launches


def phase_spatial_swin(torch, ranks: list, ones=None) -> dict:
    """13d: Swin-B under the knob (its windows' halos, the shifted
    windows' wrap round the image), from the two ranks' results
    (spatial_ranks). (a) SP_SWIN (the full-width swinb_deaotl and
    swinb_aotl) at SP_SWIN_SIZE, T=5, gap 1, against one process
    (sp_against_one; `ones`, sp_one_process's). (b) swinb_deaotl in bf16
    AMP at the recipe shape (464x464, T=17, B=2), one step each
    with the knob and with TP alone: 13b's lines and gates
    (print_sp_bf16). Returns the launches."""
    t0 = time.time()
    launches = sp_against_one(torch, ranks, '13d', ones)
    name, arch = SP_SWIN[0]
    runs = {f'{label} rank {r}': x['13d bf16', on]
            for on, label in ((False, 'TP alone'), (True, 'spatial'))
            for r, x in enumerate(ranks)}
    print_sp_bf16(f'sp 13d {name}', arch, runs)
    launches[f'sp_{name}_bf16'] = runs['spatial rank 0']['launches']
    print(f'sp 13d ok in {time.time() - t0:.1f} s')
    return launches


def cli_worker(tool: str, argv_json: str) -> int:
    """A rank of a CLI run in a child process (11c, 12c, 12d): the eval or
    train CLI, then its kernel launches on a line of their own."""
    import importlib
    import torch
    reset_counts()
    importlib.import_module(f'rmem_ocu_tpu_torch.tools.{tool}').main(
        json.loads(argv_json))
    torch.cuda.synchronize()
    print('COUNTS ' + json.dumps(read_counts()))
    return 0


def rank_counts(outs):
    return [tuple(json.loads(line[len('COUNTS '):]))
            for out in outs for line in out.splitlines()
            if line.startswith('COUNTS ')]


TP_TRAIN_ARGS = ['--multihost', '--mesh', f'1x{TP}', '--zero1', '--backend',
                 'gloo', '--stage', 'pre_vost_2', '--model', 'r50_deaotl',
                 '--exp_name', 'tp', '--datasets', 'vost', '--batch_size',
                 '2', '--total_steps', '4', '--save_step', '2',
                 '--log_step', '1']


def phase_tp_cli(torch, root: str, data: str, result: str, one_dir: str,
                 one_counts):
    """12c and 12d's CLI, at once, each in two processes on the card over
    gloo. 12c: `tools.eval --mesh 2` of 11b's step_4 EMA over phase 10's
    val split, one model group serving both sequences; its masks agree
    with 11c's one process (the same checkpoint) on more than 99.9% of
    pixels, each rank launches what its shard's reads make, print.log is
    rank 0's. 12d: `tools.train --multihost --mesh 1x2 --zero1` on phase
    10's tree at the recipe shape (465x465, T=17, B=2, fp32), 11b's 4
    steps (the schedule and the loss's ramps follow the total): the
    first two losses within 1e-4 (relative) of 11b's (one process, the
    same samples), no kernel launched, and ckpt/step_2 restored bitwise
    by a trainer of one process. Returns the launches by run."""
    from PIL import Image
    from rmem_ocu_tpu_torch.config import get_config
    from rmem_ocu_tpu_torch.data.eval_datasets import build_vost_dataset
    from rmem_ocu_tpu_torch.models import build_vos_model
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
    t0 = time.time()
    two = os.path.join(root, 'eval_tp')
    argv = ['--stage', 'pre_vost_2', '--model', 'r50_deaotl', '--exp_name',
            'dp', '--dataset', 'vost', '--data_root', data, '--ckpt_path',
            os.path.join(result, 'ema_ckpt'), '--ckpt_step', '4', '--mesh',
            str(TP), '--backend', 'gloo', '--output', two]
    me = os.path.abspath(__file__)
    evals = spawn_ranks(TP, [me, '--cli-worker', 'eval', json.dumps(argv)],
                        cwd=os.getcwd())
    trains = spawn_ranks(TP, [me, '--cli-worker', 'train', json.dumps(
        TP_TRAIN_ARGS + ['--data_root', data])], cwd=os.getcwd())
    try:
        eval_outs = wait_ranks(evals, 900)
    finally:
        train_outs = wait_ranks(trains, 900)
    t_cli = time.time() - t0

    ranks = rank_counts(eval_outs)
    # a rank's shard reads narrower heads, so its reads may split where
    # one process's do not
    want = tuple(sum(c) for c in zip(*(
        eval_counts(seq, TP)
        for _, seq in build_vost_dataset(data, 'val').items())))
    check(len(ranks) == TP and all(r == want for r in ranks)
          and want[1:] == tuple(one_counts)[1:],
          f'12c: launches by rank {ranks}, expected {want}, one process '
          f'{one_counts}')
    n = same = n_masks = 0
    for seq in sorted(os.listdir(one_dir)):
        if not os.path.isdir(os.path.join(one_dir, seq)):
            continue
        names = sorted(os.listdir(os.path.join(one_dir, seq)))
        check(names == sorted(os.listdir(os.path.join(two, seq))),
              f'12c: masks of {seq}')
        for f in names:
            a = np.asarray(Image.open(os.path.join(one_dir, seq, f)))
            b = np.asarray(Image.open(os.path.join(two, seq, f)))
            n, same, n_masks = n + a.size, same + int((a == b).sum()), \
                n_masks + 1
    check(n_masks > 0 and same > 0.999 * n,
          f'12c: {same} of {n} pixels agree')
    with open(os.path.join(two, 'print.log')) as f:
        log = f.read()
    check('[rank 0]' in log, '12c: print.log has no rank 0 lines')
    print(f'tp 12c eval CLI --mesh {TP} in {TP} processes on the card '
          f'(gloo): launches (B1, B2, B3) by rank {ranks} as expected '
          f'(one process {tuple(one_counts)}); {n_masks} masks, {same} of {n} '
          f'pixels ({same / n:.6f}) equal to 11c\'s one process')

    check(all(r == (0, 0, 0) for r in rank_counts(train_outs))
          and len(rank_counts(train_outs)) == TP,
          f'12d: the train CLI launched {rank_counts(train_outs)}')
    tp_result = get_config('pre_vost_2', 'tp', 'r50_deaotl').dir_result()
    rows = []
    for r in (result, tp_result):
        with open(os.path.join(r, 'metrics.jsonl')) as f:
            rows.append([json.loads(line) for line in f])
    check([r['step'] for r in rows[1]] == [1, 2, 3, 4],
          f'12d: metrics rows {rows[1]}')
    # steps 1 and 2 gate; later steps drift further (two runs of one
    # process through the CLI, TF32 convolutions on, agree to 3-4
    # decimals: 11b against phase 10)
    rel = [abs(y['loss'] - x['loss']) / abs(x['loss'])
           for x, y in zip(*rows)]
    check(max(rel[:2]) <= 1e-4,
          f'12d: CLI losses {[r["loss"] for r in rows[1]]} vs 11b\'s '
          f'{[r["loss"] for r in rows[0]]}')
    exp = get_config('pre_vost_2', 'tp', 'r50_deaotl')
    trainer = Trainer(build_vos_model(exp.model, device='cuda', seed=3),
                      exp)
    state0 = trainer.init_state()
    restored, step = ckpt.restore_checkpoint(
        os.path.join(tp_result, 'ckpt'), trainer.state_dict(state0), step=2)
    back = trainer.state_dict(trainer.load_state_dict(restored))
    check(step == 2 and back['step'] == 2 and all(
        torch.equal(back[part][k], v) for part in ('state_dict', 'ema')
        for k, v in restored[part].items()) and all(
        torch.equal(back['opt_state'][m][k], v) for m in ('mu', 'nu')
        for k, v in restored['opt_state'][m].items()),
        '12d: ckpt/step_2 of the 1 x 2 world does not restore bitwise at '
        'world 1')
    step_ms = [1e3 / r['it_per_s'] for r in rows[1][1:]]
    print(f'tp 12d train CLI --multihost --mesh 1x{TP} --zero1 (gloo, CUDA '
          f'tensors), r50_deaotl 465x465, T={exp.data_seq_len}, B=2, fp32: '
          f'losses {[round(r["loss"], 6) for r in rows[1]]} vs 11b\'s '
          f'{[round(r["loss"], 6) for r in rows[0]]} (relative '
          f'{[float(f"{x:.3g}") for x in rel]}; steps 1-2 gated at 1e-4); '
          f'CLI step '
          f'{statistics.median(step_ms):.1f} ms median of steps 2-4 '
          f'({[round(x, 1) for x in step_ms]}); launches (0, 0, 0) a rank; '
          f'step_2 restored '
          f'bitwise at world 1; 12c and 12d ok in {time.time() - t0:.1f} s '
          f'({t_cli:.1f} s for the two CLIs at once)')
    return {'tp_eval_cli': ranks[0], 'tp_train_cli': (0, 0, 0)}


# ------------------------------------------------------ 14: the census
B_GROUPS = ('B1 memory_read', 'B2 local_attn', 'B3 memory_read_attention')
# frames a clip of the CLI's `train` census (9b profiles a step of the
# recipe's 17; this one checks the CLI's sums and attribution)
CENSUS_TRAIN_T = 5


def census_cli(argv) -> dict:
    """`python -m rmem_ocu_tpu_torch.tools.census ARGV` in this process:
    prints its lines and returns its JSON dict (its last line)."""
    import contextlib
    import io
    from rmem_ocu_tpu_torch.tools import census
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = census.main(argv)
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines[0].startswith('card: '),
          f'census {argv}: rc {rc}, first line {lines[:1]}')
    for line in lines[:-1]:
        print(f'census {argv[0]}: {line}')
    return json.loads(lines[-1])


def phase_census(torch, rows, main_runs, trace_dir: str) -> dict:
    """14: the census tool (rmem_ocu_tpu_torch/tools/census.py) on the
    card: `stages` of deaot_1head at 1 and 8 streams beside phase 5's p50;
    `frames --stage_by_stage` of deaot_1head (B1, B2) and deaot_2heads (B3)
    at 1 stream on a bank filled to steady state, its B1/B2/B3 launches
    equal to the expected counts and to the wrappers' counters, each
    group's ms a call beside phase 3's row; `train` at 465x465, B=2,
    T=CENSUS_TRAIN_T: its components and unmatched sum to the step's
    device busy time within 1%, the matched share at least 0.5, no
    B1/B2/B3 launch; `trace` of phase 5's deaot_1head trace, its device
    total equal to that profile's busy time within 1%. Returns the census
    ms a call of B1, B2 and B3."""
    from rmem_ocu_tpu_torch.tools import census
    from rmem_ocu_tpu_torch.utils.profiling import format_census
    frame_stages = ('propagate (enc+lstt+decode @4x)', 'update_memory',
                    'predict_mask (upsample+argmax)')
    t0 = time.time()
    for streams in (1, 8):
        st = census_cli(['stages', '--streams', str(streams)])['stages']
        parts = sum(st[k]['median_ms'] for k in frame_stages)
        full = st['FULL FRAME']['median_ms']
        print(f'census stages deaot_1head streams={streams} (medians): '
              + ', '.join(f'{k} {v["median_ms"]:.3f} ms'
                          for k, v in st.items())
              + f'; propagate + update_memory + predict_mask {parts:.3f} '
              f'ms = {parts / full:.3f} x the full frame; phase 5 p50 '
              f'{main_runs[("deaot_1head", streams)][1]:.3f} ms')

    print(f'census stages: {time.time() - t0:.1f} s')
    t0 = time.time()
    per_call = {}
    n = 5
    for path, row_of in (('deaot_1head', {B_GROUPS[0]: 'b1_bf16_B1',
                                          B_GROUPS[1]: 'b2_bf16_B1'}),
                         ('deaot_2heads', {B_GROUPS[2]: 'b3_bf16_B1'})):
        spec = spec_of(path)
        overrides = dict(spec['overrides'])
        engine, state, frames, size = census.build_frames(
            overrides.pop('model'), 1, spec['size'], 'cuda', overrides,
            spec['gap'])
        state = census.fill_bank(engine, state, frames, size)
        reset_counts()
        c, state = census.profile_frames(engine, state, frames, size, n)
        counts = read_counts()
        tag = f'census frames {path} streams=1'
        for line in format_census(c, tag, stage_by_stage=True):
            print(line)
        got = tuple(round(c['group_launches'][g] * n) for g in B_GROUPS)
        want = expected_counts(path, n, n_reference=0)
        check(got == want == counts, f'{tag}: launches (B1, B2, B3) '
              f'{got}, counters {counts}, expected {want}')
        for group, row in row_of.items():
            # a bank read (B1, B3) is two launches: the read and its combine
            launches = c['group_launches'][group]
            calls = launches / (1 if group == B_GROUPS[1] else 2)
            per_call[group] = c['groups'][group] / calls
            print(f'{tag}: {group} {c["groups"][group] / launches:.4f} ms a '
                  f'launch, {per_call[group]:.4f} ms a call ({calls:g} '
                  f'calls a frame), phase 3 row {row}: '
                  f'{rows[row]["ms"]:.4f} ms')

    print(f'census frames: {time.time() - t0:.1f} s')
    t0 = time.time()
    c = census_cli(['train', '--batch', '2', '--seq', str(CENSUS_TRAIN_T)])
    print(f'census train: {time.time() - t0:.1f} s')
    comps = c['components']
    total = sum(sum(v.values()) for v in comps.values())
    bwd = sum(v['backward'] for v in comps.values())
    print(f'census train r50_deaotl B=2 T={CENSUS_TRAIN_T}: components '
          f'and unmatched '
          f'{total:.3f} ms against device busy {c["busy_ms"]:.3f} ms; '
          f'matched share {c["matched_share"]:.4f}, of the backward '
          f'{c["backward_matched_share"]:.4f}; forward / backward / '
          f'recompute {sum(v["forward"] for v in comps.values()):.3f} / '
          f'{bwd:.3f} / {sum(v["recompute"] for v in comps.values()):.3f} '
          f'ms; B1/B2/B3 launches '
          f'{[c["group_launches"][g] for g in B_GROUPS]}')
    check(abs(total - c['busy_ms']) <= 0.01 * c['busy_ms'],
          f'census train: components {total} ms, busy {c["busy_ms"]} ms')
    check(c['matched_share'] >= 0.5,
          f'census train: matched share {c["matched_share"]}')
    check(all(c['group_launches'][g] == 0 for g in B_GROUPS),
          f'census train: kernels launched {c["group_launches"]}')

    t = census_cli(['trace', trace_dir, '--steps',
                    str(MAIN_CENSUS_FRAMES)])
    main = main_runs[('deaot_1head', 1)][2]
    print(f'census trace of phase 5 deaot_1head streams=1: device '
          f'{t["total_ms"]:.4f} ms a frame ({t["kernel_ms"]:.4f} kernels) '
          f'against the profile\'s busy {main["busy_ms"]:.4f} '
          f'({main["kernel_ms"]:.4f} kernels)')
    check(abs(t['total_ms'] - main['busy_ms']) <= 0.01 * main['busy_ms']
          and abs(t['kernel_ms'] - main['kernel_ms'])
          <= 0.01 * main['kernel_ms'],
          f'census trace {t["total_ms"]} ms, profile {main["busy_ms"]} ms')
    return per_call


# ------------------------------------------------------- RMEM_BF16_PROBS
# 15: the paths whose plain attention sites the switch reaches in eval
# (deaot_2heads: self-attention, the capacity-1 reference read and the
# dense two-head window attention beside B3; swinb_deaotl: Swin-B's window
# attention beside B1 and B2), the runs of each and their frames
PROBS_PATHS = ('deaot_2heads', 'swinb_deaotl')
PROBS_MODES = ('default', 'f32 probs', 'fp32')
PROBS_FRAMES, PROBS_CENSUS = 10, 3


@contextlib.contextmanager
def probs_mode(torch, mode: str):
    """PROBS_MODES' settings inside: RMEM_BF16_PROBS=0 in 'f32 probs' (the
    variable's value before is restored after, also when the body
    raises), f32 matmuls and convolutions without TF32 in 'fp32'."""
    old = os.environ.get('RMEM_BF16_PROBS')
    if mode == 'f32 probs':
        os.environ['RMEM_BF16_PROBS'] = '0'
    try:
        with no_tf32(torch) if mode == 'fp32' else contextlib.nullcontext():
            yield
    finally:
        if old is None:
            os.environ.pop('RMEM_BF16_PROBS', None)
        else:
            os.environ['RMEM_BF16_PROBS'] = old


def probs_run(torch, path: str, mode: str) -> dict:
    """One serving run of `path` at 1 stream in `mode` (PROBS_MODES: bf16
    at the default, bf16 with RMEM_BF16_PROBS=0, fp32 without TF32), the
    weights of seed 0, a reference frame and PROBS_FRAMES frames, each
    frame's mask written into its own memory. Returns the logits and masks
    of each frame (on the CPU), the launches, the frames' CUDA-event ms,
    the peak memory and (engine, state, frames) for probs_census."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    spec = spec_of(path)
    size = spec['size']
    bf16 = mode != 'fp32'
    exp = get_config('pre_vost_2',
                     compute_dtype='bfloat16' if bf16 else 'float32',
                     **spec['overrides'])
    with probs_mode(torch, mode):
        # the runs before stay held for their census
        base = torch.cuda.memory_allocated()
        model = build_vos_model(exp.model, seed=0)
        eng = InferEngine(model.to(torch.bfloat16) if bf16 else model, exp,
                          long_term_mem_gap=spec['gap'])
        img0, mask0, frames = make_inputs(1, PROBS_FRAMES, seed=15,
                                          size=size)
        frames = [torch.from_numpy(f).cuda() for f in frames]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state = eng.init_state(1, grid_of(size, exp.model.align_corners))
        state = eng.add_reference_frame(state, torch.from_numpy(img0),
                                        torch.from_numpy(mask0),
                                        torch.tensor([N_OBJ]))
        out = {'logits': [], 'masks': [], 'ms': []}
        for f in frames:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, state = eng.propagate(state, f)
            pred = eng.predict_mask(logits, size)
            state = eng.update_memory(state, pred)
            end.record()
            out['logits'].append(logits[..., :N_OBJ + 1].float().cpu())
            out['masks'].append(pred.cpu())
            end.synchronize()
            out['ms'].append(start.elapsed_time(end))
        out['launches'] = read_counts()
        out['peak'] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    out['align_corners'] = exp.model.align_corners
    out['live'] = (eng, state, frames)
    return out


def probs_census(torch, run: dict, mode: str, size) -> dict:
    """The census of PROBS_CENSUS frames after a probs_run in `mode`, on
    its engine."""
    from rmem_ocu_tpu_torch.tools import census
    eng, state, frames = run.pop('live')
    with probs_mode(torch, mode):
        c, _ = census.profile_frames(eng, state, frames, size, PROBS_CENSUS)
    return c


def mask_agreement(run: dict, ref: dict, size) -> tuple:
    """(share of pixels equal over the frames, the same with a differing
    pixel excused where `ref`'s two best logits lie within twice the
    frame's largest logit difference, the largest logit difference, the
    mean one): the tie rule of phase 4."""
    from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
    equal = excused = n = 0
    worst, total = 0.0, 0.0
    for a, b, la, lb in zip(run['masks'], ref['masks'], run['logits'],
                            ref['logits']):
        diff = float((la - lb).abs().max())
        worst = max(worst, diff)
        total += float((la - lb).abs().mean())
        up = interpolate_bilinear(lb.permute(0, 3, 1, 2), size,
                                  ref['align_corners'])
        top2 = up.topk(2, dim=1).values
        differ = a != b
        equal += int((~differ).sum())
        excused += int((differ & (top2[:, 0] - top2[:, 1]
                                  <= 2 * diff)).sum())
        n += a.numel()
    return equal / n, (equal + excused) / n, worst, total / len(run['masks'])


def phase_probs_serving(torch, path: str) -> dict:
    """15(a): `path` in PROBS_MODES on the same weights and frames. Gates:
    the kernels launch as often with the switch as at the default, and as
    expected; every logit finite; the switch's masks agree with the
    default's and with fp32's on more than 99.9% of pixels, a differing
    pixel excused only by the tie rule. Prints each bf16 mode's largest
    (and mean) logit difference to fp32, the agreements, p50 and
    device-busy ms a frame and the peak memory of each mode: every mode is
    timed before any is profiled (a profile slows the frames timed after
    it in its process). Returns the switch's launches."""
    t0 = time.time()
    spec = spec_of(path)
    runs = {mode: probs_run(torch, path, mode) for mode in PROBS_MODES}
    for mode, r in runs.items():
        r['census'] = probs_census(torch, r, mode, spec['size'])
    torch.cuda.empty_cache()
    want = expected_counts(path, PROBS_FRAMES)
    for mode, r in runs.items():
        check(r['launches'] == want, f'15 {path} {mode}: launches '
              f'(B1, B2, B3) {r["launches"]}, expected {want}')
        check(all(bool(torch.isfinite(x).all()) for x in r['logits']),
              f'15 {path} {mode}: non-finite logits')
    on = runs['f32 probs']
    for ref in ('default', 'fp32'):
        raw, agree, diff, _ = mask_agreement(on, runs[ref],
                                             spec['size'])
        check(agree > 0.999, f'15 {path}: f32 probs against {ref}: masks '
              f'agree on {agree:.6f} with ties excused ({raw:.6f} raw)')
        print(f'probs 15a {path}: f32 probs against {ref}: masks agree on '
              f'{raw:.6f} of pixels, {agree:.6f} with ties excused, largest '
              f'|logit diff| {diff:.4e}')
    for mode, r in runs.items():
        err = ''
        if mode != 'fp32':
            raw, _, worst, mean = mask_agreement(r, runs['fp32'],
                                                 spec['size'])
            err = (f', |logit - fp32 logit| largest {worst:.4e}, mean '
                   f'{mean:.4e}, masks equal to fp32\'s on {raw:.6f}')
        c = r['census']
        print(f'probs 15a {path} {mode} {spec["size"][0]}x'
              f'{spec["size"][1]} streams=1: p50 frame '
              f'{statistics.median(r["ms"]):.3f} ms ({PROBS_FRAMES} frames), '
              f'device busy {c["busy_ms"]:.3f} ms a frame (census of '
              f'{PROBS_CENSUS}), peak memory {r["peak"]:.3f} GiB, launches '
              f'(B1, B2, B3) {r["launches"]}{err}')
    print(f'probs 15a {path}: ok in {time.time() - t0:.1f} s')
    return on['launches']


def probs_grads(torch, mode: str) -> tuple:
    """(loss, trainable leaves' gradients) of one r50_deaotl episode at
    129x129, T=5 (9a's clip and weights, every rate 0, no id shuffle) in
    `mode` (PROBS_MODES; the bf16 ones in AMP)."""
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
    from rmem_ocu_tpu_torch.models.vos_model import zero_dropout
    from rmem_ocu_tpu_torch.train import optim
    exp = replace(get_config('pre_vost_2', model='r50_deaotl',
                             latter_mem_len=2, data_seq_len=5,
                             train_lstt_droppath=0.0,
                             train_amp=mode != 'fp32'),
                  train_long_term_mem_gap=1)
    frames, masks = train_clip(1, 5, (129, 129), seed=21)
    with probs_mode(torch, mode):
        model = zero_dropout(build_vos_model(exp.model, seed=0,
                                             exp=exp)).train()
        loss, _ = TrainEngine(model, exp).episode_loss(
            torch.from_numpy(frames), torch.from_numpy(masks),
            torch.tensor([N_OBJ]), 1000, None, enable_id_shuffle=False)
        loss.backward()
    frozen = optim.make_masks(dict(model.named_parameters()), exp).frozen
    return float(loss.detach()), {n: p.grad.detach().float()
                                  for n, p in model.named_parameters()
                                  if not frozen[n]}


def probs_recipe_steps(torch, mode: str) -> dict:
    """Two r50_deaotl steps at the recipe shape (465x465, T=17, gap 4,
    B=2, bf16 AMP, remat 'full'; 9b's B=2 clip and weights) in `mode`
    ('default' or 'f32 probs'): each step's CUDA-event ms, the losses,
    the last grad norm and the peak memory above what was held before the
    model was built."""
    from dataclasses import replace
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    exp = replace(get_config('pre_vost_2', model='r50_deaotl',
                             train_amp=True), train_remat_policy='full')
    frames, masks = train_clip(2, exp.data_seq_len, exp.data_randomcrop,
                               seed=2)
    out = {'ms': [], 'losses': []}
    with probs_mode(torch, mode):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(build_vos_model(exp.model, seed=0, exp=exp), exp)
        state = trainer.init_state()
        batch = {'frames': torch.from_numpy(frames).cuda(),
                 'masks': torch.from_numpy(masks).cuda(),
                 'obj_nums': torch.full((2,), N_OBJ, device='cuda')}
        gen = torch.Generator().manual_seed(7)
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = trainer.train_step(state, batch, gen)
            end.record()
            end.synchronize()
            out['ms'].append(start.elapsed_time(end))
            out['losses'].append(float(metrics['loss']))
        out['peak'] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        out['grad_norm'] = float(metrics['grad_norm'])
    del trainer, state, batch
    torch.cuda.empty_cache()
    return out


def phase_probs_training(torch, default_step: dict) -> tuple:
    """15(b): r50_deaotl at the recipe shape (465x465, T=17, gap 4, B=2,
    bf16 AMP, remat 'full'), one warm-up and one timed step at the default
    and with RMEM_BF16_PROBS=0, beside 9b's default B=2 step
    (`default_step`); then the 129x129, T=5 episode in bf16 AMP at the
    default and with the switch, each leaf's gradient cosine to the fp32
    episode's. Gates: no kernel launched, finite losses and gradients.
    Returns the launches."""
    t0 = time.time()
    reset_counts()
    for mode in ('default', 'f32 probs'):
        r = probs_recipe_steps(torch, mode)
        check(all(np.isfinite(r['losses'])) and np.isfinite(r['grad_norm'])
              and r['grad_norm'] > 0, f'15b {mode}: losses {r["losses"]}, '
                                      f'grad norm {r["grad_norm"]}')
        print(f'probs 15b r50_deaotl B=2 remat=full 465x465 T=17 gap 4, '
              f'bf16 AMP, {mode}: step {r["ms"][1]:.1f} ms (after 1 '
              f'warm-up, {r["ms"][0]:.1f}), peak memory {r["peak"]:.3f} GiB '
              f'above the start, losses {[round(x, 4) for x in r["losses"]]}, '
              f'grad norm {r["grad_norm"]:.3f}; 9b default: step '
              f'{default_step["ms"]:.1f} ms, peak memory '
              f'{default_step["peak"]:.3f} GiB')
    loss32, g32 = probs_grads(torch, 'fp32')
    cos = lambda a, b: float((a * b).sum() / (a.norm() * b.norm())
                             .clamp_min(1e-30))
    result = {}
    for mode in ('default', 'f32 probs'):
        loss, g = probs_grads(torch, mode)
        check(np.isfinite(loss) and all(bool(torch.isfinite(x).all())
                                        for x in g.values()),
              f'15b 129x129 {mode}: non-finite loss or gradient')
        result[mode] = {n: cos(g[n], g32[n]) for n in g32
                        if float(g32[n].norm()) > 0}
        c = sorted(result[mode].items(), key=lambda kv: kv[1])
        print(f'probs 15b r50_deaotl 129x129 T=5 bf16 AMP {mode}: loss '
              f'{loss:.6f} (fp32 {loss32:.6f}); gradient cosine to fp32 '
              f'over {len(c)} leaves: lowest {c[0][1]:.6f} ({c[0][0]}), '
              f'median {statistics.median(v for _, v in c):.6f}, '
              f'{sum(v < 0.99 for _, v in c)} below 0.99')
    closer = sum(result['f32 probs'][n] > result['default'][n]
                 for n in result['default'])
    counts = read_counts()
    check(counts == (0, 0, 0), f'15b: training launched kernels {counts}')
    print(f'probs 15b: the f32-probs gradient lies closer to fp32 than the '
          f'default on {closer} of {len(result["default"])} leaves; '
          f'launches (B1, B2, B3) {counts}; ok in {time.time() - t0:.1f} s')
    return counts


def phase_probs(torch, smi: str, default_step: dict) -> dict:
    """15: RMEM_BF16_PROBS=0 on the card, serving (15a) and training
    (15b). Returns the launches by run."""
    print(f'probs 15 on {smi}')
    counts = {f'probs_{path}': phase_probs_serving(torch, path)
              for path in PROBS_PATHS}
    counts['probs_train'] = phase_probs_training(torch, default_step)
    return counts


def print_resources(logs) -> None:
    """Registers, shared memory and spills of each kernel: ptxas's report
    per entry (static shared memory only), then the runtime's view of the
    kernels the main path runs, dynamic shared memory included."""
    import re
    from rmem_ocu_tpu_torch.ops.kernels import local_attn, memory_read
    for lib, log in logs.items():
        entry = None
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and ('spill' in line or 'registers' in line):
                print(f'ptxas {lib} {entry[:80]}: {line.split(":", 1)[-1]}'
                      .rstrip())
    for name, info in (
            ('B1/B3 memory_read_ws D=128 (deaot_1head, deaot_2heads)',
             memory_read.kernel_info(1, 128, 1024)),
            ('B1 memory_read_heads D=32 Dv=32 (aot)',
             memory_read.kernel_info(8, 32, 32)),
            ('B2 local_attn_tc D=128 max_dis=7 (deaot_1head)',
             local_attn.kernel_info(128, 7))):
        print(f'resources {name}: {info[0]} registers, {info[1]} bytes '
              f'shared memory, {info[2]} bytes local (spill) per thread')


# name, source, the TPU kernel it replaces, the row of phase 3 that times it
# at its path's B=1 shape, its index in the counts, the path whose 1-stream
# run gives `launches` (B1 and B2: this slice's main path, swinb_deaotl)
KERNELS = (
    ('memory_read_fused', 'rmem_ocu_tpu_torch/csrc/memory_read.cu',
     'rmem_ocu_tpu/ops/pallas/memory_read.py:281', 'b1_bf16_B1_22x39', 0,
     'swinb_deaotl'),
    ('local_window_attention', 'rmem_ocu_tpu_torch/csrc/local_attn.cu',
     'rmem_ocu_tpu/ops/pallas/local_attn.py:91', 'b2_bf16_B1_22x39', 1,
     'swinb_deaotl'),
    ('memory_read_attention',
     'rmem_ocu_tpu_torch/csrc/memory_read_attention.cu',
     'rmem_ocu_tpu/ops/pallas/memory_read.py:88', 'b3_bf16_B1', 2,
     'deaot_2heads'),
)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    try:
        from rmem_ocu_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f'chip_smoke: the rmem_ocu_tpu_torch package is missing: {e}',
              file=sys.stderr)
        return 1
    t_start = time.time()
    marks, laps = [t_start], [t_start]

    def done(phase: int) -> None:
        """The end of a phase: seconds since the start and its own."""
        marks.append(time.time())
        laps.append(marks[-1])
        print(f'phase {phase} done at {marks[-1] - t_start:.1f} s '
              f'({marks[-1] - marks[-2]:.1f} s)')

    def lap(part: str) -> None:
        """The end of a part of a phase: its seconds."""
        laps.append(time.time())
        print(f'part {part}: {laps[-1] - laps[-2]:.1f} s')
    from rmem_ocu_tpu_torch.utils.profiling import card_line
    smi = card_line('cuda')
    print(f'device: {smi}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}')

    t0 = time.time()
    build.build(['memory_read', 'local_attn', 'memory_read_attention'])
    print(f'build: {time.time() - t0:.1f} s')
    print_resources(build.BUILD_LOGS)

    rows = phase_kernels(torch)
    done(3)
    for path in PATHS:
        phase_engine_fp32(torch, path)
    done(4)
    counts, main_runs = {}, {}
    # phase 5's trace of deaot_1head at 1 stream, read by phase 14 (removed
    # at exit also when a phase fails)
    traces = tempfile.TemporaryDirectory()
    trace_dir = traces.name
    runs = [(path, batch) for path in PATHS
            for batch in spec_of(path)['streams']]
    live = {}
    for path, batch in runs:
        *main_runs[(path, batch)], live[(path, batch)] = phase_main_path(
            torch, path, batch)
        if batch == 1:
            counts[path] = main_runs[(path, batch)][0]
    lap('5 timed runs')
    for run in runs:
        main_runs[run].append(main_path_census(
            torch, *run, trace_dir if run == ('deaot_1head', 1) else None,
            live.pop(run)))
    torch.cuda.empty_cache()
    done(5)
    with tempfile.TemporaryDirectory() as tmp:
        phase_eval_fp32(torch, os.path.join(tmp, 'fp32'))
        lap('6 eval fp32')
        counts['eval_bf16'] = phase_eval_bf16(torch, os.path.join(tmp,
                                                                  'bf16'))
        lap('7 eval bf16')
        phase_eval_cli(os.path.join(tmp, 'cli'))
        done(7)
        counts['oracle_bf16'] = phase_oracle(torch, os.path.join(tmp,
                                                                 'oracle'))
    done(8)
    counts['training_fp32'] = phase_training_fp32(torch)
    lap('9a')
    trained, default_step = phase_training_bf16(torch)
    lap('9b')
    check(trained is not None, 'the batch-2 training run did not finish')
    counts['after_training'] = phase_after_training(torch, trained)
    done(9)
    del trained
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counts['pipeline_eval'], pipeline_ms = phase_pipeline(torch, tmp)
        done(10)
        counts['dp_two_ranks'], dp_one = phase_dp_two_ranks(torch, tmp)
        lap('11a')
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            data = os.path.join(tmp, 'data')
            counts['dp_cli'], result = phase_dp_cli(torch, tmp, data,
                                                    pipeline_ms)
            lap('11b')
            counts['dp_eval'], eval_one, one_counts = phase_dp_eval(
                torch, tmp, data, result, counts['pipeline_eval'])
            done(11)
            tp_rows = phase_tp_kernels(torch, rows)
            lap('12a')
            tp_counts, tp_train = phase_tp_serving(torch, tmp, dp_one)
            lap('12b and 12d trainer')
            counts.update(tp_counts)
            counts.update(phase_tp_cli(torch, tmp, data, result, eval_one,
                                       one_counts))
            done(12)
            # 13c's and 13d's one process runs while the ranks train
            ones = {}
            ranks = spatial_ranks(torch, tmp, meanwhile=lambda: ones.update(
                {part: sp_one_process(torch, part)
                 for part in ('13c', '13d')}))
            lap('13 ranks')
            print('part 13 on rank 0, in its pair: ' + ', '.join(
                f'{k[1]} {v:.1f} s' for k, v in ranks[0].items()
                if isinstance(k, tuple) and k[0] == 'seconds'))
            counts.update(phase_spatial(torch, ranks, dp_one, tp_train))
            counts.update(phase_spatial_encoders(torch, ranks, ones['13c']))
            counts.update(phase_spatial_swin(torch, ranks, ones['13d']))
            del ranks, ones
        finally:
            os.chdir(cwd)
    done(13)
    census_ms = phase_census(torch, rows, main_runs, trace_dir)
    traces.cleanup()
    done(14)
    counts.update(phase_probs(torch, smi, default_step))
    done(15)

    kernels = []
    for (name, src, replaces, row_name, idx, path), group in zip(
            KERNELS, B_GROUPS):
        # every check above raised on failure, so reaching here is 'ok'
        kind = row_name.split('_')[0]
        kernels.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=counts[path][idx],
            launches_by_path={p: c[idx] for p, c in counts.items()},
            **rows[row_name], census_ms=census_ms[group], verdict='ok',
            tp_shard_rows={k: {f: v[f] for f in ('ms', 'bound_ms',
                                                 'bound_share')}
                           for k, v in tp_rows.items()
                           if k.split('_')[0] in (kind, kind + 'mh')}))
    print(f'total: {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dp-worker']:
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ['--cli-worker']:
        sys.exit(cli_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ['--tp-worker']:
        sys.exit(tp_worker(sys.argv[2]))
    if sys.argv[1:2] == ['--sp-worker']:
        sys.exit(sp_worker(sys.argv[2]))
    sys.exit(main())
