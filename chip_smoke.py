#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rmem_ocu_tpu_torch) on one GPU.

    python3 chip_smoke.py

Three paths of the port are driven, each at the full width of its model:
`r50_deaotl` (DeAOT, one attention head: kernels B1 and B2), `r50_deaotl`
with `no_memory_gap` (two heads: kernel B3; its temporal PE is off, because
the model's PE is d/2 wide and a two-head query d wide, which the reference
package cannot add either) and `r50_aotl` (AOT, LSTT with 8 heads: kernel
B1 in its multi-head, one-bank mode).

Phases, each fatal on failure:
1. environment: card name and power limit, torch and CUDA versions;
2. build: compiles every CUDA kernel with nvcc (sm_90a), all at once, and
   prints each kernel's registers, shared memory and spills;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the three paths give it, with its time, the plain version's
   time, one library call's time as a yardstick, the least time the card
   could take (bound) and the share of it reached (bound / time);
4. engine, fp32, card against CPU, per path: seeded random weights, one
   reference frame and 12 frames at write gap 1 (eviction fires), holding
   eviction ids, masks and exact kernel launch counts;
5. main path, bf16, per path: 353x625, 3 objects, at 1 and 8 streams:
   frames/s, p50 frame latency, peak memory and a profile by kernel group.

The last lines are one JSON object listing the kernels, the card's
`nvidia-smi` name and power limit, and `{"ok": true, "device": ...}`. With
no CUDA device, or without the package beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}

H, W = 353, 625                 # DAVIS 480p long edge 624 -> 16k+1 grid
GRID = ((H - 1) // 16 + 1, (W - 1) // 16 + 1)        # 23 x 40
N_OBJ = 3


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
            heads: int = 1, d: int = 128, cvs=(512, 512)):
    """B1 inputs: T=10 with a dead slot in the middle, HWq = HWk = 920,
    temporal PE. Defaults: the DeAOT one-head read (D=128, the two 512-wide
    banks V and ID_V); the AOT read is heads=8, d=32, cvs=(32,)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    hw, t_cap = GRID[0] * GRID[1], 10
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


def b2_case(torch, batch: int, dtype, seed: int):
    """Main-path B2 inputs: 23x40 grid, D=128, E=1024 (V||ID_V)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    (h, w), d, e_dim, md = GRID, 128, 1024, 7
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
    for name, batch, dtype, precise, tol, shape in (
            ('b1_bf16_B1', 1, torch.bfloat16, False, BF16_TOL, {}),
            ('b1_f32_precise_B1', 1, torch.float32, True, F32_TOL, {}),
            ('b1_bf16_B8', 8, torch.bfloat16, False, BF16_TOL, {}),
            ('b1mh_bf16_B1', 1, torch.bfloat16, False, BF16_TOL, aot),
            ('b1mh_bf16_B8', 8, torch.bfloat16, False, BF16_TOL, aot)):
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

    for name, batch, dtype, tol in (
            ('b2_bf16_B1', 1, torch.bfloat16, BF16_TOL),
            ('b2_f32_B1', 1, torch.float32, F32_TOL),
            ('b2_bf16_B8', 8, torch.bfloat16, BF16_TOL)):
        args, n_bytes, n_flops = b2_case(torch, batch, dtype, 2)
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
def make_inputs(batch: int, n_frames: int, seed: int,
                independent: bool = False):
    """A clip of frames near the reference frame, or, `independent`, of
    unrelated frames: then the memory slots differ enough for the
    attention-usage scores to separate them (a near-static clip makes the
    LSTT's eviction choice a tie that rounding breaks)."""
    rng = np.random.RandomState(seed)
    img0 = rng.randn(batch, H, W, 3).astype(np.float32)
    mask0 = (rng.rand(batch, H, W) * (N_OBJ + 1)).astype(np.int64)
    base = 0.0 if independent else img0
    frames = [(base + (1.0 if independent else 0.5)
               * rng.randn(batch, H, W, 3)).astype(np.float32)
              for _ in range(n_frames)]
    return img0, mask0, frames


# The three paths: config overrides, the write gap of the bf16 run, and the
# kernel launches (B1, B2, B3) per propagated frame and per reference frame.
# A bank read (B1 or B3) is two launches, the split read and its combine.
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
}


def expected_counts(path: str, n_frames: int, n_reference: int = 1):
    spec = PATHS[path]
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
    """fp32 card against CPU, same weights, same inputs, in lock-step."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exp = get_config('pre_vost_2', **PATHS[path]['overrides'])
    cpu_model = build_vos_model(exp.model, device='cpu', seed=0)
    gpu_model = build_vos_model(exp.model, seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    n_frames = 12
    img0, mask0, frames = make_inputs(1, n_frames, seed=3,
                                      independent=exp.model.vos == 'aot')
    engines = [InferEngine(m, exp, long_term_mem_gap=1)
               for m in (cpu_model, gpu_model)]
    states = [e.init_state(1, GRID) for e in engines]
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
            pred = e.predict_mask(logits, (H, W))
            states[i] = e.update_memory(states[i], pred)
            preds.append(pred.cpu())
            logits_all.append(logits.float().cpu())
        ids = [s.bank.frame_ids.cpu() for s in states]
        ordered = [s.bank.ordered_frame_ids.cpu() for s in states]
        agree = float((preds[0] == preds[1]).float().mean())
        diff = float((logits_all[0][..., :N_OBJ + 1]
                      - logits_all[1][..., :N_OBJ + 1]).abs().max())
        worst_logit, worst_agree = max(worst_logit, diff), min(worst_agree,
                                                               agree)
        worst_mass = max(worst_mass, max_err(masses[0], masses[1]))
        print(f'engine fp32 {path} frame {t}: ordered ids '
              f'{ordered[1][0].tolist()} mask agreement {agree:.6f} max '
              f'|logit diff| {diff:.3e}')
        check(torch.equal(ids[0], ids[1]) and torch.equal(*ordered),
              f'{path} frame {t}: eviction ids differ {ordered}')
        check(agree > 0.999, f'{path} frame {t}: mask agreement {agree}')
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
    print(f'engine fp32 {path} card vs CPU: ok, {n_frames} frames, eviction '
          f'ids identical, worst mask agreement {worst_agree:.6f}, worst '
          f'|logit diff| {worst_logit:.3e}, worst |mass diff| '
          f'{worst_mass:.3e}, launches (B1, B2, B3) {counts}')


# kernel-name fragments -> group, first match wins (cuDNN's implicit-GEMM
# convolutions before cuBLAS's GEMMs)
KERNEL_GROUPS = (
    ('B3 memory_read_attention', ('attentionread',)),
    ('B1 memory_read', ('memory_read',)),
    ('B2 local_attn', ('local_attn',)),
    ('convolution', ('conv', 'fprop', 'implicit', 'winograd', 'cudnn')),
    ('matmul', ('gemm', 'cutlass', 'cublas', 'xmma')),
    ('normalisation', ('norm',)),
    ('softmax', ('softmax',)),
    ('other', ('',)),
)


def profile_frames(torch, eng, state, frames, tag: str, n: int = 5):
    """torch.profiler over n frames: device time by kernel group, kernels
    launched per frame and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(n):
            logits, state = eng.propagate(state, frames[i % len(frames)])
            state = eng.update_memory(state, eng.predict_mask(logits, (H, W)))
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    busy, launches, kernels = 0.0, 0, []
    for evt in prof.key_averages():
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
        return
    parts = ', '.join(f'{g} {t / n:.3f} ms ({100 * t / busy:.1f}%)'
                      for g, t in sorted(groups.items(), key=lambda x: -x[1]))
    print(f'profile {tag}: {window / n:.3f} ms/frame window, '
          f'device busy {busy / n:.3f} ms/frame, idle share '
          f'{max(0.0, 1 - busy / window):.3f}, {launches / n:.0f} kernels/'
          f'frame; by group per frame: {parts}')
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        print(f'  top kernel {tag}: {ms / n:.3f} ms/frame, '
              f'{count / n:.0f}/frame, {name[:90]}')


def phase_main_path(torch, path: str, batch: int, n_warm: int = 5,
                    n_timed: int = 30):
    """The bf16 main path of `path` at `batch` streams; returns the kernel
    launch counts (B1, B2, B3) of the run."""
    from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
    spec = PATHS[path]
    exp = get_config('pre_vost_2', compute_dtype='bfloat16',
                     **spec['overrides'])
    model = build_vos_model(exp.model, seed=0).to(torch.bfloat16)
    eng = InferEngine(model, exp, long_term_mem_gap=spec['gap'])
    img0, mask0, frames = make_inputs(batch, 8, seed=5)
    frames = [torch.from_numpy(f).cuda() for f in frames]
    state = eng.init_state(batch, GRID)
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
        pred = eng.predict_mask(logits, (H, W))
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
    check(tuple(logits.shape) == (batch, 4 * GRID[0] - 3, 4 * GRID[1] - 3,
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
    print(f'main path bf16 {H}x{W} {N_OBJ} objects gap {spec["gap"]} {tag}: '
          f'{fps:.2f} frames/s aggregate, p50 frame latency '
          f'{statistics.median(per_frame):.3f} ms, peak memory {peak:.3f} '
          f'GiB, {n_timed} timed frames after {n_warm} warm-up, launches '
          f'(B1, B2, B3) {counts}')
    profile_frames(torch, eng, state, frames, tag)
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
# run gives `launches`
KERNELS = (
    ('memory_read_fused', 'rmem_ocu_tpu_torch/csrc/memory_read.cu',
     'rmem_ocu_tpu/ops/pallas/memory_read.py:281', 'b1_bf16_B1', 0,
     'deaot_1head'),
    ('local_window_attention', 'rmem_ocu_tpu_torch/csrc/local_attn.cu',
     'rmem_ocu_tpu/ops/pallas/local_attn.py:91', 'b2_bf16_B1', 1,
     'deaot_1head'),
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
    for path in PATHS:
        phase_engine_fp32(torch, path)
    counts = {}
    for path in PATHS:
        counts[path] = phase_main_path(torch, path, 1)
        phase_main_path(torch, path, 8)

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
