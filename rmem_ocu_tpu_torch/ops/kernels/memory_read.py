"""Kernel B1: fused memory-bank read (attention output + per-slot mass).

Counterpart of `rmem_ocu_tpu/ops/pallas/memory_read.py:memory_read_fused`.
`memory_read_fused` launches the CUDA kernel of `csrc/memory_read.cu` on a
CUDA tensor and runs the plain PyTorch version on a CPU tensor; it never
falls back from a CUDA tensor. `memory_read_fused_plain` is the plain
version for any device, the reference the kernel is held to.

On the card the bf16 read is one launch where one unit of the kernel
covers a query tile's whole bank (`split_count` gives 1: the blocks fill
the card without a split), else two, the read split over slots and the
combine that merges the splits and yields the mass; the counter
`kernels.b1.launches` (`utils/tracing.py`) counts the launches made (one
for `precise`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from rmem_ocu_tpu_torch.ops.kernels import build
from rmem_ocu_tpu_torch.ops.layers import scale_in_dtype
from rmem_ocu_tpu_torch.utils import tracing

M_INIT = -1e30      # running-max init of the reference kernel
MAX_SLOTS = 32
# tiles of the bf16 read (csrc/memory_read_tc.cuh)
WIDE_ROWS = 128     # query rows per block of the wide-head kernel
HEADS_ROWS = 64     # query rows per block of the small-head kernel
BLOCK_KEYS = 64     # keys per tile
PANEL = 64          # value columns of a panel of the wide-head kernel
HEADS_PER_BLOCK = 8  # heads per block of the small-head kernel


def refuse_autograd(name: str, *tensors) -> None:
    """The kernels define no backward: raise, on any device, when grad
    mode is on and an input requires grad, rather than return an output
    cut off from the graph. Training takes the modules' dense
    differentiable branches (their `training` mode) and never calls a
    kernel."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in tensors):
        raise RuntimeError(
            f'{name} has no backward: it takes no input that requires grad '
            f'under grad mode (call it under torch.no_grad(), or run the '
            f'module in training mode, which reads densely)')


def _mm(x: torch.Tensor, precise: bool) -> torch.Tensor:
    """Matrix-operand rounding: bf16 operands unless precise."""
    return x.float() if precise else x.to(torch.bfloat16).float()


def _prepare(q, k_bank, v_banks, num_heads, scale, mem_pe):
    if len(v_banks) not in (1, 2):
        raise ValueError('memory_read_fused takes one or two value banks')
    if len(v_banks) == 2 and num_heads != 1:
        raise ValueError('two value banks share one probability matrix; '
                         'only num_heads=1 decomposes this way')
    b, _, hd = q.shape
    t_cap = k_bank.shape[1]
    q = scale_in_dtype(q, scale)
    pe = None
    if mem_pe is not None:
        if mem_pe.dim() == 2:
            mem_pe = mem_pe[None]
        pe = mem_pe.expand(b, t_cap, hd).to(q.dtype).contiguous()
    return q, pe


def online_softmax_read(q, k_bank, v_banks, valid, num_heads, pe, precise):
    """Online softmax over the slots in physical order, one slot per step
    (the reference kernels' block order when a slot fits one key block);
    the plain arithmetic of kernels B1 and B3. q is pre-scaled. Returns
    (outs [B, HWq, H*Dv_i] f32, mass [B, H, HWq, T_cap] f32)."""
    b, hwq, hd = q.shape
    _, t_cap, hwk, _ = k_bank.shape
    h = num_heads
    d = hd // h
    qh = _mm(q, precise).view(b, hwq, h, d).transpose(1, 2)
    kh = _mm(k_bank, precise).view(b, t_cap, hwk, h, d).permute(0, 3, 1, 2, 4)
    vhs = [_mm(v, precise).view(b, t_cap, hwk, h, -1).permute(0, 3, 1, 2, 4)
           for v in v_banks]
    peh = (None if pe is None
           else pe.float().view(b, t_cap, h, d).transpose(1, 2))
    live = valid.bool()
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, h, hwq, 1), M_INIT, **f32)
    l = torch.zeros((b, h, hwq, 1), **f32)
    accs = [torch.zeros((b, h, hwq, vh.shape[-1]), **f32) for vh in vhs]
    s = torch.zeros((b, h, hwq, t_cap), **f32)
    slot_ids = torch.arange(t_cap, device=q.device)
    for t in range(t_cap):
        logits = qh @ kh[:, :, t].transpose(-1, -2)
        if peh is not None:
            logits = logits + (qh * peh[:, :, t, None, :]).sum(-1, keepdim=True)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        p_sum = p.sum(-1, keepdim=True)
        p_mm = p if precise else p.to(torch.bfloat16).float()
        lv = live[:, t].view(b, 1, 1, 1)
        l = torch.where(lv, l * alpha + p_sum, l)
        accs = [torch.where(lv, acc * alpha + p_mm @ vh[:, :, t], acc)
                for acc, vh in zip(accs, vhs)]
        s = torch.where(lv, s * alpha + p_sum * (slot_ids == t), s)
        m = torch.where(lv, m_new, m)
    denom = l.clamp_min(1e-30)
    outs = tuple((acc / denom).transpose(1, 2).reshape(b, hwq, -1)
                 for acc in accs)
    return outs, s / denom


def _plain(q, k_bank, v_banks, valid, num_heads, pe, precise):
    outs, mass = online_softmax_read(q, k_bank, v_banks, valid, num_heads,
                                     pe, precise)
    return tuple(o.to(q.dtype) for o in outs), mass.mean(1)


def heads_per_block(num_heads: int, head_dim: int,
                    cols_per_head: int) -> int:
    """Heads per block of the bf16 read's several-heads kernel, or 0 for
    its one-head kernel."""
    if num_heads >= 4 and head_dim <= 32 and cols_per_head <= 32:
        return HEADS_PER_BLOCK
    return 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def column_blocks(cph: int) -> int:
    """Blocks of the wide-head kernel across a head's cph value columns:
    a block takes 64 columns where that holds the head, else 128
    (`block_cols`)."""
    panels = -(-cph // PANEL)
    return 1 if panels <= 1 else -(-panels // 2)


def split_count(b: int, h: int, hwq: int, d: int, cph: int, hwk: int,
                sm_count: int) -> int:
    """Units the key tiles of a query tile's live slots are shared out to:
    as many as keep every block in one round on `sm_count` SMs (one block
    is resident per SM: its shared memory) and no more than a slot has
    tiles, so that no unit is empty. 1 when the blocks of one share each
    fill the card already: the wide-head kernel then finishes the read in
    one launch."""
    hpb = heads_per_block(h, d, cph)
    if hpb:
        blocks = -(-hwq // HEADS_ROWS) * b * -(-h // hpb)
    else:
        blocks = -(-hwq // WIDE_ROWS) * b * h * column_blocks(cph)
    return max(1, min(sm_count // blocks, -(-hwk // BLOCK_KEYS)))


def read_plan(b: int, h: int, hwq: int, d: int, cph: int, t_cap: int,
              hwk: int, device: torch.device):
    """(n_split, heads_per_block, scratch, launches) of one bf16 read.
    n_split from `split_count` at the card's SM count; the f32 scratch
    (None where the read is one launch) holds each unit's accumulator
    [B, n_split, HWq, H*cph], running max [B, H, n_split, HWq] and the
    (max, p-sum) of each slot share [B, H, n_split, HWq, T, 2]."""
    hpb = heads_per_block(h, d, cph)
    n_split = split_count(b, h, hwq, d, cph, hwk, _sm_count(device.index))
    if n_split == 1 and not hpb:
        return n_split, hpb, (None, None, None), 1
    f32 = dict(dtype=torch.float32, device=device)
    scratch = (torch.empty((b, n_split, hwq, h * cph), **f32),
               torch.empty((b, h, n_split, hwq), **f32),
               torch.empty((b, h, n_split, hwq, t_cap, 2), **f32))
    return n_split, hpb, scratch, 2


def read_operands(*xs):
    """The kernels multiply bf16 operands: round f32 storage to bf16 (the
    rounding the plain version applies), keep bf16 as it is. TMA reads
    them from 16-byte aligned addresses: a view that starts elsewhere is
    copied."""
    out = []
    for x in xs:
        if x is not None:
            x = x.to(torch.bfloat16).contiguous()
            if x.data_ptr() % 16:
                x = x.clone()
        out.append(x)
    return tuple(out)


def _lib():
    lib = build.load('memory_read')
    fn = lib.rmem_memory_read_fused
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_info(num_heads: int, head_dim: int, cols_per_head: int):
    """(registers, shared memory bytes, local spill bytes per thread) of
    the bf16 read kernel these shapes select, from the CUDA runtime."""
    lib = build.load('memory_read')
    out = (ctypes.c_int * 3)()
    rc = lib.rmem_memory_read_info(
        head_dim, cols_per_head,
        heads_per_block(num_heads, head_dim, cols_per_head), out)
    if rc != 0:
        raise RuntimeError(f'memory_read kernel info failed: CUDA error {rc}')
    return tuple(out)


def _launch(q, k_bank, v_banks, valid, num_heads, pe, precise):
    b, hwq, hd = q.shape
    h = num_heads
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'memory_read_fused takes f32 or bf16, got {q.dtype}')
    tensors = [q, k_bank, *v_banks] + ([pe] if pe is not None else [])
    for x in tensors:
        if x.device != q.device or x.dtype != q.dtype:
            raise TypeError('q, k, v and pe must share device and dtype')
        if not x.is_contiguous():
            raise ValueError('memory_read_fused takes contiguous tensors')
    if k_bank.dim() != 4 or k_bank.shape[0] != b or k_bank.shape[3] != hd:
        raise ValueError(f'k_bank {tuple(k_bank.shape)} does not match q '
                         f'{tuple(q.shape)}')
    _, t_cap, hwk, _ = k_bank.shape
    # bf16 operands run on the tensor cores (D a multiple of 16 up to 128,
    # Dv % 8 == 0); f32 operands on the FP32 pipes (D <= 128, Dv % 4 == 0)
    head_dims = (16, 32, 64, 128) if not precise else range(1, 129)
    dv_mult = 8 if not precise else 4
    if hd % h or hd // h not in head_dims or t_cap > MAX_SLOTS:
        raise ValueError(f'head dim {hd}/{h} must be one of {head_dims}; '
                         f'slots {t_cap} <= {MAX_SLOTS}')
    dvs = []
    for v in v_banks:
        if v.shape[:3] != k_bank.shape[:3] or v.shape[3] % (dv_mult * h):
            raise ValueError(f'value bank {tuple(v.shape)} must be '
                             f'[B, T, HWk, H*Dv] with Dv % {dv_mult} == 0')
        dvs.append(v.shape[3] // h)
    if tuple(valid.shape) != (b, t_cap):
        raise ValueError(f'valid {tuple(valid.shape)} != {(b, t_cap)}')
    valid_i = valid.to(device=q.device, dtype=torch.int32).contiguous()
    outs = [torch.empty((b, hwq, h * dv), dtype=q.dtype, device=q.device)
            for dv in dvs]
    mass = torch.empty((b, h, hwq, t_cap), dtype=torch.float32,
                       device=q.device)
    two = len(v_banks) == 2
    if precise:
        n_split, hpb, scratch, launches = 1, 0, (None, None, None), 1
    else:
        n_split, hpb, scratch, launches = read_plan(
            b, h, hwq, hd // h, sum(dvs), t_cap, hwk, q.device)
        q, k_bank, *v_banks = read_operands(q, k_bank, *v_banks)
        pe = None if pe is None else pe.float()
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _lib()(ptr(q), ptr(k_bank), ptr(pe), ptr(v_banks[0]),
                ptr(v_banks[1]) if two else None, ptr(valid_i), ptr(outs[0]),
                ptr(outs[1]) if two else None, ptr(mass), *map(ptr, scratch),
                b, h, t_cap, hwq, hwk, hd // h, dvs[0],
                dvs[1] if two else 0, int(outs[0].dtype == torch.bfloat16),
                int(not precise), n_split, hpb,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'memory_read kernel launch failed: CUDA error {rc}')
    tracing.count('kernels.b1.launches', launches)
    return tuple(outs), mass.mean(1)


def memory_read_fused(q: torch.Tensor, k_bank: torch.Tensor,
                      v_banks: Sequence[torch.Tensor], valid: torch.Tensor,
                      num_heads: int, scale: float,
                      mem_pe: Optional[torch.Tensor] = None,
                      precise: bool = False
                      ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Fused bank read.

    q: [B, HWq, H*D] (unscaled); k_bank: [B, T_cap, HWk, H*D]; v_banks: one
    or two [B, T_cap, HWk, H*Dv_i] (two banks share one probability matrix
    and need num_heads == 1); valid: [B, T_cap] live physical slots;
    mem_pe: optional [B|1, T_cap, H*D] temporal PE, applied as the logit
    term q.pe_t. precise=False rounds the matrix operands and p to bf16
    whatever the input dtype. Returns (outs [B, HWq, H*Dv_i] in q.dtype,
    mass [B, HWq, T_cap] f32, the mean over heads).
    """
    refuse_autograd('memory_read_fused', q, k_bank, *v_banks, mem_pe)
    q, pe = _prepare(q, k_bank, v_banks, num_heads, scale, mem_pe)
    if q.device.type == 'cpu':
        return _plain(q, k_bank, v_banks, valid, num_heads, pe, precise)
    return _launch(q, k_bank, v_banks, valid, num_heads, pe, precise)


def memory_read_fused_plain(q, k_bank, v_banks, valid, num_heads, scale,
                            mem_pe=None, precise=False):
    """The plain PyTorch version of `memory_read_fused`, on any device."""
    q, pe = _prepare(q, k_bank, v_banks, num_heads, scale, mem_pe)
    return _plain(q, k_bank, v_banks, valid, num_heads, pe, precise)
