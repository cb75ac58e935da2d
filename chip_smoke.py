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
   the card could take (bound) and the share of it reached (bound / time);
4. engine, fp32, card against CPU, per path: seeded random weights, one
   reference frame and 10-12 frames at write gap 1 (eviction fires; 12 at
   353x625 for the ResNet-50 paths, 10 at 128x224 or 129x225 for the
   others), holding eviction ids, masks and exact kernel launch counts;
5. main path, bf16, per path: 353x625 (352x624 for Swin), 3 objects, at 1
   and 8 streams (the ResNet-50 paths and swinb_deaotl) or 1: frames/s,
   p50 frame latency, peak memory and a profile by kernel group and by
   part of the model (encoder, in Swin its window attention, the
   attention's qkv and proj linears and the MLPs; LSTT; decoder);
6. eval protocol, fp32, card against CPU: the port's Evaluator with flip
   and scales (1.0, 1.3) on 241x433 frames, 3 objects, and 10 objects
   growing to 12 (re-reference, two groups), holding eviction ids at every
   update, written masks and exact launch counts, and scoring the card's
   masks against the CPU's (J&F);
7. eval protocol, bf16, 1080x1920 frames at the default test_max_size
   (577x1041 and 753x1345), flip: eval frames/s, p50 frame latency, peak
   memory, launches and a profiled window per sequence; then the eval CLI
   on the synthetic test set, on its default device;
8. the VOST oracle, `r50_topdown_aotl`: the Evaluator fp32 on the card
   against the CPU (129x225, flip: eviction ids at every update, masks,
   launches, no re-reference), then bf16 on 1080x1920 frames.
9. training, `r50_deaotl`: (a) one fp32 episode (129x129, T=5, gap 1,
   evictions) on the card against the CPU, loss, per-frame losses and
   every trainable gradient, and an AdamW update from the same gradients;
   no kernel launched across the step (training reads densely: the
   kernels have no backward); (b) bf16 AMP steps at the recipe shape
   (465x465 crops, T=17, gap 4, remat 'full', batch 2 and 4, and batch 2
   without remat): step time, episodes/s, frames/s, peak memory and a
   profile of one step by part; (c) the trained model in eval mode: the
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

The last lines are one JSON object listing the kernels, the card's
`nvidia-smi` name and power limit, and `{"ok": true, "device": ...}`. With
no CUDA device, or without the package beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

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


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# cycles of the sleep kernel a timed burst waits behind: ~30 ms, longer
# than the host takes to enqueue a burst of ten wrapper calls, so that the
# device runs the burst back to back
SLEEP_CYCLES = 50_000_000


def time_ms(torch, fn, burst: int = 10, samples: int = 21) -> float:
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


def b3_case(torch, batch: int, dtype, seed: int):
    """B3 inputs as the two-head DeAOT read gives them: D=128 per head, V
    and ID_V 512 wide each (head 0 is V, head 1 ID_V), T=10 with a dead
    slot in the middle, HWq = HWk = 920, the PE already on the keys."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    hw, t_cap, heads, d, e_dim = GRID[0] * GRID[1], 10, 2, 128, 512
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


def b2_case(torch, batch: int, dtype, seed: int, grid=GRID):
    """B2 inputs of the DeAOT path: D=128, E=1024 (V||ID_V), on `grid`
    (23x40 on the main path)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    (h, w), d, e_dim, md = grid, 128, 1024, 7
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
    n_split, hpb, scratch = read_plan(batch, heads, hwq, d, cph, t_cap,
                                      hwq, torch.device('cuda'))
    n_bytes = 2 * sum(x.numel() * 4 for x in scratch)
    kernel = (f'memory_read_heads, {hpb} heads a block' if hpb
              else 'memory_read_wide')
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


def kernel_row(torch, name, run, plain, library, n_bytes, n_flops, operands,
               err, plain_burst: int = 2):
    """`operands` names the type the kernel multiplies ('bfloat16' or
    'float32'), which sets the peak rate of the bound; the storage type is
    already in `n_bytes`."""
    b_ms, b_by = bound_ms(n_bytes, n_flops, operands)
    row = dict(max_abs_err=err, ms=time_ms(torch, run),
               plain_ms=time_ms(torch, plain, burst=plain_burst),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(torch, library))
    row['bound_share'] = b_ms / row['ms']
    print(f'kernel {name}: ok, {json.dumps(row)}')
    return row


def phase_kernels(torch):
    from rmem_ocu_tpu_torch.ops.kernels.local_attn import (
        local_window_attention, local_window_attention_plain)
    from rmem_ocu_tpu_torch.ops.kernels.memory_read import (
        memory_read_fused, memory_read_fused_plain)
    from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import (
        memory_read_multihead, memory_read_multihead_plain)
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
        rows[name] = kernel_row(
            torch, name, lambda: memory_read_fused(*args, **kw),
            lambda: memory_read_fused_plain(*args, **kw),
            b1_library(torch, args, kw), n_bytes, n_flops,
            'float32' if precise else 'bfloat16', max(err, err_mass))

    # B3: f32 storage still multiplies bf16 operands (the path never asks
    # for precise), so every row has the bf16 bar
    for name, batch, dtype in (('b3_bf16_B1', 1, torch.bfloat16),
                               ('b3_f32_B1', 1, torch.float32),
                               ('b3_bf16_B8', 8, torch.bfloat16)):
        args, n_bytes, n_flops = b3_case(torch, batch, dtype, 3)
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
        rows[name] = kernel_row(
            torch, name, lambda: memory_read_multihead(*args),
            lambda: memory_read_multihead_plain(*args),
            sdpa_over_bank(q, k, torch.cat(vs, -1), valid, heads, scale),
            n_bytes, n_flops, 'bfloat16', max(err, err_mass))
        if batch == 1 and dtype == torch.bfloat16:
            # what the kernel's two-bank form saves: the reference
            # concatenates V||ID_V before the read
            print(f'kernel {name}: concatenating V||ID_V '
                  f'{tuple(vs[0].shape)} x2 would take '
                  f'{time_ms(torch, lambda: torch.cat(vs, -1)):.4f} ms')

    for name, batch, dtype, tol, grid in (
            ('b2_bf16_B1', 1, torch.bfloat16, BF16_TOL, GRID),
            ('b2_f32_B1', 1, torch.float32, F32_TOL, GRID),
            ('b2_bf16_B8', 8, torch.bfloat16, BF16_TOL, GRID)) + tuple(
                (f'b2_bf16_B{batch}_{grid[0]}x{grid[1]}', batch,
                 torch.bfloat16, BF16_TOL, grid)
                for grid, batch in EVAL_GRIDS + ((SWIN_GRID, 1),
                                                 (SWIN_GRID, 8))):
        args, n_bytes, n_flops = b2_case(torch, batch, dtype, 2, grid)
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
        rows[name] = kernel_row(
            torch, name, lambda: local_window_attention(*args),
            lambda: local_window_attention_plain(*args),
            b2_library(torch, args), n_bytes, n_flops,
            'float32' if args[-1] else 'bfloat16', err)
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
# count. A bank read (B1 or B3) is two launches, the split read and its
# combine. The first three paths are the ResNet-50 ones of the earlier
# slices; `swinb_deaotl` is this slice's main path, and one model stands
# for each other encoder (MobileNetV3 in AOT-L, the only way a registered
# configuration reaches it).
DEFAULTS = dict(size=(H, W), streams=(1, 8), warm=5, timed=30,
                check_size=(H, W), check_frames=12, feed_cpu_mask=False)
NEW = dict(check_frames=10, feed_cpu_mask=True)
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


def expected_counts(path: str, n_frames: int, n_reference: int = 1):
    spec = spec_of(path)
    return tuple(f * n_frames + r * n_reference for f, r
                 in zip(spec['per_frame'], spec['per_reference']))


def reset_counts():
    from rmem_ocu_tpu_torch.ops.kernels import (local_attn, memory_read,
                                                memory_read_mh)
    memory_read.memory_read_fused.launches = 0
    local_attn.local_window_attention.launches = 0
    memory_read_mh.memory_read_attention.launches = 0


def read_counts():
    """Launches of (B1, B2, B3) since reset_counts()."""
    from rmem_ocu_tpu_torch.ops.kernels import (local_attn, memory_read,
                                                memory_read_mh)
    return (memory_read.memory_read_fused.launches,
            local_attn.local_window_attention.launches,
            memory_read_mh.memory_read_attention.launches)


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


# kernel-name fragments -> group, first match wins (cuDNN's implicit-GEMM
# convolutions before cuBLAS's GEMMs)
KERNEL_GROUPS = (
    ('B3 memory_read_attention', ('attentionread',)),
    ('B1 memory_read', ('memory_read',)),
    ('B2 local_attn', ('local_attn',)),
    ('convolution', ('conv', 'fprop', 'implicit', 'winograd', 'cudnn')),
    ('matmul', ('gemm', 'cutlass', 'cublas', 'xmma', 'nvjet')),
    ('normalisation', ('norm',)),
    ('softmax', ('softmax',)),
    ('other', ('',)),
)


def annotate_modules(model):
    """Profiler ranges around the model's parts, by forward hooks (the
    port's code carries none): the encoder, in Swin its window attention
    (the whole WindowAttention module, and apart its qkv and proj linears)
    and its MLPs, the LSTT / GPM stack and the decoder. Returns the hook
    handles; report_profile reads each range's device time."""
    from torch.profiler import record_function
    from rmem_ocu_tpu_torch.models.encoders.swin import Mlp, WindowAttention
    parts = [('encoder', model.encoder), ('lstt', model.LSTT),
             ('decoder', model.decoder)]
    for m in model.modules():
        if isinstance(m, WindowAttention):
            parts += [('swin window attention', m),
                      ('swin attention qkv + proj linears', m.qkv),
                      ('swin attention qkv + proj linears', m.proj)]
        elif isinstance(m, Mlp):
            parts.append(('swin mlp', m))
    handles = []
    for name, mod in parts:
        ranges = []

        def enter(_mod, _args, name=name, ranges=ranges):
            ranges.append(record_function(f'part: {name}').__enter__())

        def leave(_mod, _args, _out, ranges=ranges):
            ranges.pop().__exit__(None, None, None)
        handles.append(mod.register_forward_pre_hook(enter))
        handles.append(mod.register_forward_hook(leave))
    return handles


def profile_frames(torch, eng, state, frames, tag: str, size, n: int = 5):
    """torch.profiler over n frames: device time by kernel group and by
    part of the model, kernels launched per frame and the device's idle
    share of the window."""
    from torch.profiler import ProfilerActivity, profile
    handles = annotate_modules(eng.model)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for i in range(n):
                logits, state = eng.propagate(state, frames[i % len(frames)])
                state = eng.update_memory(state,
                                          eng.predict_mask(logits, size))
            end.record()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return report_profile(prof, start.elapsed_time(end), n, tag)


def report_profile(prof, window_ms: float, n: int, tag: str):
    """Prints the device time of a profiled window of n frames by kernel
    group, the kernels launched per frame, the idle share of the window,
    the top kernels and, where annotate_modules marked them, the device
    time of the model's parts. Returns the device's busy ms per frame, or
    None when the profiler saw no kernels."""
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    busy, launches, kernels, parts = 0.0, 0, [], {}
    for evt in prof.key_averages():
        if evt.key.startswith('part: '):
            # the CPU range's device time sums the kernels launched in it;
            # its device-side twin spans the range, gaps included
            if not str(evt.device_type).endswith('CUDA'):
                parts[evt.key[6:]] = evt.device_time_total / 1e3
            continue
        if not str(evt.device_type).endswith('CUDA'):
            continue
        ms = evt.self_device_time_total / 1e3
        busy += ms
        launches += evt.count
        kernels.append((ms, evt.count, evt.key))
        name = evt.key.lower()
        for group, keys in KERNEL_GROUPS:
            if any(k in name for k in keys):
                groups[group] += ms
                break
    if busy == 0.0:
        print(f'profile {tag}: device time not measured (the profiler saw '
              f'no kernels)')
        return None
    parts_s = ', '.join(f'{g} {t / n:.3f} ms ({100 * t / busy:.1f}%)'
                        for g, t in sorted(groups.items(),
                                           key=lambda x: -x[1]))
    print(f'profile {tag}: {window_ms / n:.3f} ms/frame window, '
          f'device busy {busy / n:.3f} ms/frame, idle share '
          f'{max(0.0, 1 - busy / window_ms):.3f}, {launches / n:.0f} '
          f'kernels/frame; by group per frame: {parts_s}')
    if parts:
        print(f'profile {tag}: by part per frame: ' + ', '.join(
            f'{g} {t / n:.3f} ms ({100 * t / busy:.1f}%)'
            for g, t in parts.items()))
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        print(f'  top kernel {tag}: {ms / n:.3f} ms/frame, '
              f'{count / n:.0f}/frame, {name[:90]}')
    return busy / n


def phase_main_path(torch, path: str, batch: int):
    """The bf16 main path of `path` at `batch` streams; returns the kernel
    launch counts (B1, B2, B3) of the run."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    spec = spec_of(path)
    size, n_warm, n_timed = spec['size'], spec['warm'], spec['timed']
    exp = get_config('pre_vost_2', compute_dtype='bfloat16',
                     **spec['overrides'])
    grid = grid_of(size, exp.model.align_corners)
    model = build_vos_model(exp.model, seed=0).to(torch.bfloat16)
    eng = InferEngine(model, exp, long_term_mem_gap=spec['gap'])
    img0, mask0, frames = make_inputs(batch, 8, seed=5, size=size)
    frames = [torch.from_numpy(f).cuda() for f in frames]
    state = eng.init_state(batch, grid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = eng.add_reference_frame(state, torch.from_numpy(img0),
                                    torch.from_numpy(mask0),
                                    torch.full((batch,), N_OBJ))
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
    check(counts == expected_counts(path, n_prop),
          f'{path}: kernel launches (B1, B2, B3) {counts} for {n_prop} '
          f'frames, expected {expected_counts(path, n_prop)}')
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tag = f'{path} streams={batch}'
    print(f'main path bf16 {size[0]}x{size[1]} {N_OBJ} objects gap '
          f'{spec["gap"]} {tag}: {fps:.2f} frames/s aggregate, p50 frame '
          f'latency {statistics.median(per_frame):.3f} ms, peak memory '
          f'{peak:.3f} GiB, {n_timed} timed frames after {n_warm} warm-up, '
          f'launches (B1, B2, B3) {counts}')
    profile_frames(torch, eng, state, frames, tag, size)
    return counts


# ---------------------------------------------------------------- eval
def array_sequence(name: str, size, n_frames: int, labels: dict, seed: int,
                   **seq_kw):
    """A sequence of the port's eval data whose frames and labels are made
    here from `seed` instead of read from files: smooth random images that
    drift a little from frame to frame, and `labels`, {frame index: uint8
    label map at `size`}. `on_frame`, when set, is called with each frame
    index before the evaluator gets the frame (the profiler's window)."""
    import cv2
    from rmem_ocu_tpu_torch.data.eval_datasets import VOSSequence
    h, w = size
    base = np.random.RandomState(seed).rand(h // 32 + 2, w // 32 + 2, 3)

    class ArraySequence(VOSSequence):
        on_frame = None

        def _raw_image(self, img_name):
            idx = int(img_name[:5])
            jitter = np.random.RandomState(seed * 1000 + idx).rand(
                *base.shape)
            small = (0.8 * base + 0.2 * jitter).astype(np.float32) * 255
            return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)

        def _raw_label(self, label_name):
            return labels[int(label_name[:5])]

        def frame(self, idx):
            if self.on_frame is not None:
                self.on_frame(idx)
            return super().frame(idx)

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


def eval_counts(seq, n_aug: int):
    """Launches of (B1, B2, B3) the evaluator makes on a sequence: per
    augmentation, 6 B1 and 3 B2 per propagated frame and 3 B2 per
    reference added (frame 0 and every labelled frame after it)."""
    props = len(seq) - 1
    refs = len(seq.labels)
    return (6 * props * n_aug, 3 * (props + refs) * n_aug, 0)


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
    n_aug = 4
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
        check(counts == eval_counts(seq, n_aug),
              f'eval fp32 {name}: launches (B1, B2, B3) {counts}, expected '
              f'{eval_counts(seq, n_aug)}')
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
    from torch.profiler import ProfilerActivity, profile
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
        check(counts == eval_counts(seq, 4),
              f'eval bf16 {name}: launches (B1, B2, B3) {counts}, expected '
              f'{eval_counts(seq, 4)}')
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
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        running = []

        def on_frame(idx, prof=prof, events=events, first=first,
                     running=running):
            if idx == first:
                torch.cuda.synchronize()
                prof.start()
                running.append(True)
                events[0].record()
            elif idx == first + 5:
                events[1].record()
                torch.cuda.synchronize()
                prof.stop()
                running.pop()
        seq.on_frame = on_frame
        try:
            ev.evaluate(EvalDataset({name: seq}), verbose=False)
        finally:
            if running:
                prof.stop()
        device_ms[name] = report_profile(
            prof, events[0].elapsed_time(events[1]), 5, f'eval bf16 {name}')
    if None not in device_ms.values():
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


def annotate_training(model):
    """Profiler ranges of a training step: the model's parts by forward
    hooks (with remat their recompute in backward too), the loss, and the
    optimizer + EMA, by wrapping the functions the trainer calls."""
    from torch.profiler import record_function
    from rmem_ocu_tpu_torch.engine import train_engine
    from rmem_ocu_tpu_torch.train import optim
    handles = annotate_modules(model)
    saved = []

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def ranged(*a, **k):
            with record_function(f'part: {label}'):
                return fn(*a, **k)
        setattr(mod, name, ranged)
        saved.append((mod, name, fn))
    wrap(train_engine, 'segmentation_loss', 'loss')
    for name in ('clip_by_global_norm', 'adam_update', 'apply_updates',
                 'ema_update'):
        wrap(optim, name, 'optimizer + ema')

    def undo():
        for h in handles:
            h.remove()
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def report_train_profile(prof, window_ms: float, tag: str):
    """Device time of one profiled step by part and kernel group, the
    backward's share (autograd's evaluate_function ranges, remat recompute
    included) and the idle share of the step."""
    busy, parts, groups, bwd = 0.0, {}, {g: 0.0 for g, _ in KERNEL_GROUPS}, 0.0
    kernels = []
    for evt in prof.key_averages():
        cuda = str(evt.device_type).endswith('CUDA')
        if evt.key.startswith('part: '):
            # the CPU range's device time sums the kernels launched in it;
            # its device-side twin spans the range, gaps included
            if not cuda:
                parts[evt.key[6:]] = evt.device_time_total / 1e3
        elif (evt.key.startswith('autograd::engine::evaluate_function')
              and not cuda):
            bwd += evt.device_time_total / 1e3
        elif cuda:
            ms = evt.self_device_time_total / 1e3
            busy += ms
            kernels.append((ms, evt.count, evt.key))
            for group, keys in KERNEL_GROUPS:
                if any(k in evt.key.lower() for k in keys):
                    groups[group] += ms
                    break
    if busy == 0.0:
        print(f'profile {tag}: device time not measured (the profiler saw '
              f'no kernels)')
        return
    print(f'profile {tag}: step window {window_ms:.1f} ms, device busy '
          f'{busy:.1f} ms, idle share {max(0.0, 1 - busy / window_ms):.3f}; '
          f'backward (autograd, with the remat recompute) {bwd:.1f} ms '
          f'({100 * bwd / busy:.1f}%); by part (forward hooks: forward and '
          f'recompute): ' + ', '.join(f'{g} {t:.1f} ms ({100 * t / busy:.1f}'
                                      f'%)' for g, t in parts.items()))
    print(f'profile {tag}: by kernel group: ' + ', '.join(
        f'{g} {t:.1f} ms ({100 * t / busy:.1f}%)' for g, t in
        sorted(groups.items(), key=lambda x: -x[1])))
    print(f'profile {tag}: {sum(c for _, c, _ in kernels)} kernels a step')
    for ms, count, name in sorted(kernels, reverse=True)[:10]:
        print(f'  top kernel {tag}: {ms:.1f} ms, {count}x, {name[:100]}')


def phase_training_bf16(torch):
    """9b: bf16 AMP training of r50_deaotl at the recipe shape (pre_vost_2:
    465x465 crops, T=17, write gap 4), 3 objects, remat 'full', per-card
    batch 2 and 4: CUDA events over 5 steps after 2 warm-up, episodes/s,
    frames/s, peak memory, a profile of one step; batch 2 again without
    remat. Returns the trained model of the last batch-2 run."""
    from dataclasses import replace
    from torch.profiler import ProfilerActivity, profile
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    base = get_config('pre_vost_2', model='r50_deaotl', train_amp=True)
    size, n_frames = base.data_randomcrop, base.data_seq_len
    check(base.train_long_term_mem_gap == 4 and n_frames == 17
          and tuple(size) == (465, 465), f'recipe {size} T={n_frames} gap '
          f'{base.train_long_term_mem_gap}')
    trained = None
    for batch, policy in ((2, 'full'), (4, 'full'), (2, 'none')):
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
            n_steps = 7 if policy == 'full' else 2
            for i in range(n_steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, metrics = trainer.train_step(state, batch_d, gen)
                end.record()
                losses.append(metrics['loss'])
                if i >= 2 or policy == 'none':
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
              f'(median of {len(events)} after 2 warm-up), '
              f'{1e3 * batch / step_ms:.3f} episodes/s, '
              f'{1e3 * batch * n_frames / step_ms:.1f} frames/s, peak '
              f'memory {peak:.3f} GiB, loss {float(losses[-1]):.4f}, grad '
              f'norm {float(metrics["grad_norm"]):.3f}, {moved} parameter '
              f'and {ema_moved} EMA leaves moved, launches (B1, B2, B3) '
              f'{read_counts()}')
        if batch == 2:
            undo = annotate_training(model)
            try:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    start.record()
                    state, metrics = trainer.train_step(state, batch_d, gen)
                    end.record()
                    torch.cuda.synchronize()
            finally:
                undo()
            report_train_profile(prof, start.elapsed_time(end), tag)
            trained = model
    return trained


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
    want = tuple(sum(c) for c in zip(*(eval_counts(seq, 1)
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
    return legs['eval'][0]


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
            ('B1/B3 memory_read_wide D=128 (deaot_1head, deaot_2heads)',
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
    smi = nvidia_smi()
    print(f'device: {smi}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}')

    t0 = time.time()
    build.build(['memory_read', 'local_attn', 'memory_read_attention'])
    print(f'build: {time.time() - t0:.1f} s')
    print_resources(build.BUILD_LOGS)

    rows = phase_kernels(torch)
    print(f'phase 3 done at {time.time() - t_start:.1f} s')
    for path in PATHS:
        phase_engine_fp32(torch, path)
    print(f'phase 4 done at {time.time() - t_start:.1f} s')
    counts = {}
    for path in PATHS:
        for batch in spec_of(path)['streams']:
            c = phase_main_path(torch, path, batch)
            if batch == 1:
                counts[path] = c
    print(f'phase 5 done at {time.time() - t_start:.1f} s')
    with tempfile.TemporaryDirectory() as tmp:
        phase_eval_fp32(torch, os.path.join(tmp, 'fp32'))
        counts['eval_bf16'] = phase_eval_bf16(torch, os.path.join(tmp,
                                                                  'bf16'))
        phase_eval_cli(os.path.join(tmp, 'cli'))
        print(f'phase 7 done at {time.time() - t_start:.1f} s')
        counts['oracle_bf16'] = phase_oracle(torch, os.path.join(tmp,
                                                                 'oracle'))
    print(f'phase 8 done at {time.time() - t_start:.1f} s')
    counts['training_fp32'] = phase_training_fp32(torch)
    trained = phase_training_bf16(torch)
    check(trained is not None, 'the batch-2 training run did not finish')
    counts['after_training'] = phase_after_training(torch, trained)
    print(f'phase 9 done at {time.time() - t_start:.1f} s')
    del trained
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counts['pipeline_eval'] = phase_pipeline(torch, tmp)
    print(f'phase 10 done at {time.time() - t_start:.1f} s')

    kernels = []
    for name, src, replaces, row_name, idx, path in KERNELS:
        # every check above raised on failure, so reaching here is 'ok'
        kernels.append(dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=counts[path][idx],
            launches_by_path={p: c[idx] for p, c in counts.items()},
            **rows[row_name], verdict='ok'))
    print(f'total: {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
