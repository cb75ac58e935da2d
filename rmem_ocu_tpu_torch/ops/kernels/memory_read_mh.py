"""Kernel B3: multi-head bank read (attention output + per-slot mass).

Counterpart of `rmem_ocu_tpu/ops/pallas/memory_read.py:
memory_read_attention` (heads folded into the leading axis) and of its
caller `memory_read_multihead` (the storage layout [B, T, HW, H*D]). Both
wrappers launch the CUDA kernel of `csrc/memory_read_attention.cu` on a CUDA
tensor and run the plain PyTorch version on a CPU tensor; they never fall
back from a CUDA tensor. `memory_read_attention_plain` and
`memory_read_multihead_plain` are the plain versions for any device.

Unlike kernel B1 there is no temporal-PE term (the caller adds the PE to the
keys), the output is f32 whatever the storage type, and on the storage
layout the kernel reads each head by stride, so the head-fold transposes of
the JAX wrapper are not made. The value bank may be given as two banks
whose channel-wise concatenation is meant (DeAOT's V||ID_V): with an even
head count each head lies in one of them and no concatenation is
materialised. On the card a read is one launch, or two (the read split
over slots and the combine) where `memory_read.split_count` splits it,
and the counter `kernels.b3.launches` (`utils/tracing.py`) counts the
launches made.
Neither wrapper has a backward: each raises on an input that requires grad
under grad mode, on every device.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from rmem_ocu_tpu_torch.ops.kernels import build
from rmem_ocu_tpu_torch.ops.kernels.memory_read import (MAX_SLOTS,
                                                        online_softmax_read,
                                                        read_operands,
                                                        read_plan,
                                                        refuse_autograd)
from rmem_ocu_tpu_torch.ops.layers import scale_in_dtype
from rmem_ocu_tpu_torch.utils import tracing

ValueBanks = Union[torch.Tensor, Sequence[torch.Tensor]]


def _lib():
    lib = build.load('memory_read_attention')
    fn = lib.rmem_memory_read_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k_bank, v_banks, valid, num_heads):
    """q [B, HWq, H*D] pre-scaled, k_bank [B, T, HWk, H*D], v_banks one or
    two [B, T, HWk, W_i] with W_1 + W_2 = H*Dv, valid [B, T]. Returns
    (out [B, HWq, H*Dv] f32, mass [B, H, HWq, T] f32)."""
    b, hwq, hd = q.shape
    h = num_heads
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'memory_read_attention takes f32 or bf16, got '
                        f'{q.dtype}')
    for x in (k_bank, *v_banks):
        if x.device != q.device or x.dtype != q.dtype:
            raise TypeError('q, k and v must share device and dtype')
    for x in (q, k_bank, *v_banks):
        if not x.is_contiguous():
            raise ValueError('memory_read_attention takes contiguous tensors')
    if k_bank.dim() != 4 or k_bank.shape[0] != b or k_bank.shape[3] != hd:
        raise ValueError(f'k_bank {tuple(k_bank.shape)} does not match q '
                         f'{tuple(q.shape)}')
    _, t_cap, hwk, _ = k_bank.shape
    if hd % h or hd // h not in (16, 32, 64, 128) or t_cap > MAX_SLOTS:
        raise ValueError(f'head dim {hd}/{h} must be 16, 32, 64 or 128; '
                         f'slots {t_cap} <= {MAX_SLOTS}')
    if len(v_banks) not in (1, 2):
        raise ValueError('memory_read_attention takes one or two value banks')
    hdv = sum(v.shape[-1] for v in v_banks)
    dv = hdv // h
    if hdv % h or dv % 8 or dv == 0:
        raise ValueError(f'value width {hdv}/{h} must be a multiple of 8')
    for v in v_banks:
        if (v.dim() != 4 or v.shape[:3] != k_bank.shape[:3]
                or v.shape[3] % dv):
            raise ValueError(f'value bank {tuple(v.shape)} must be [B, T, '
                             f'HWk, n*Dv]: each bank holds whole heads')
    if tuple(valid.shape) != (b, t_cap):
        raise ValueError(f'valid {tuple(valid.shape)} != {(b, t_cap)}')
    valid_i = valid.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, hwq, hdv), dtype=torch.float32, device=q.device)
    mass = torch.empty((b, h, hwq, t_cap), dtype=torch.float32,
                       device=q.device)
    n_split, hpb, scratch, launches = read_plan(b, h, hwq, hd // h, dv,
                                                t_cap, hwk, q.device)
    q, k_bank, *v_banks = read_operands(q, k_bank, *v_banks)
    two = len(v_banks) == 2
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _lib()(ptr(q), ptr(k_bank), ptr(v_banks[0]),
                ptr(v_banks[1]) if two else None, ptr(valid_i), ptr(out),
                ptr(mass), *map(ptr, scratch), b, h, t_cap, hwq, hwk,
                hd // h, dv, v_banks[0].shape[3], n_split, hpb,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'memory_read_attention kernel launch failed: '
                           f'CUDA error {rc}')
    tracing.count('kernels.b3.launches', launches)
    return out, mass


def memory_read_attention_plain(q, k_bank, v_bank, valid,
                                precise: bool = False):
    """The plain PyTorch version of `memory_read_attention`: the online
    softmax slot by slot, on any device."""
    (out,), mass = online_softmax_read(q, k_bank, (v_bank,), valid, 1, None,
                                       precise)
    return out, mass[:, 0]


def memory_read_attention(q: torch.Tensor, k_bank: torch.Tensor,
                          v_bank: torch.Tensor, valid: torch.Tensor,
                          precise: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bank read on the head-folded layout.

    q: [BH, HWq, D] (pre-scaled, PE already on the keys); k_bank: [BH,
    T_cap, HWk, D]; v_bank: [BH, T_cap, HWk, Dv]; valid: [BH, T_cap] live
    physical slots. precise=False rounds the matrix operands and p to bf16
    whatever the input dtype. Returns (out [BH, HWq, Dv] f32, mass [BH,
    HWq, T_cap] f32). The CUDA kernel has bf16 operands only: precise=True
    on a CUDA tensor raises.
    """
    refuse_autograd('memory_read_attention', q, k_bank, v_bank)
    if q.device.type == 'cpu':
        return memory_read_attention_plain(q, k_bank, v_bank, valid, precise)
    if precise:
        raise ValueError('the CUDA memory_read_attention kernel multiplies '
                         'bf16 operands; precise=True runs on CPU tensors '
                         'only')
    out, mass = _launch(q, k_bank, (v_bank,), valid, 1)
    return out, mass[:, 0]


def _banks(v_bank: ValueBanks) -> Tuple[torch.Tensor, ...]:
    return (v_bank,) if isinstance(v_bank, torch.Tensor) else tuple(v_bank)


def memory_read_multihead_plain(q, k_bank, v_bank: ValueBanks, valid,
                                num_heads: int, scale: float):
    """The plain PyTorch version of `memory_read_multihead`: fold the heads
    into the batch axis as the JAX wrapper does, read, unfold."""
    b, hwq, hd = q.shape
    v = torch.cat(_banks(v_bank), dim=-1)
    _, t_cap, hwk, hdv = v.shape
    h = num_heads
    d, dv = hd // h, hdv // h
    qf = scale_in_dtype(q, scale).reshape(b, hwq, h, d).transpose(1, 2)
    kf = k_bank.reshape(b, t_cap, hwk, h, d).permute(0, 3, 1, 2, 4)
    vf = v.reshape(b, t_cap, hwk, h, dv).permute(0, 3, 1, 2, 4)
    out, mass = memory_read_attention_plain(
        qf.reshape(b * h, hwq, d), kf.reshape(b * h, t_cap, hwk, d),
        vf.reshape(b * h, t_cap, hwk, dv), valid.repeat_interleave(h, dim=0))
    out = out.reshape(b, h, hwq, dv).transpose(1, 2).reshape(b, hwq, hdv)
    return out, mass.reshape(b, h, hwq, t_cap).mean(1)


def memory_read_multihead(q: torch.Tensor, k_bank: torch.Tensor,
                          v_bank: ValueBanks, valid: torch.Tensor,
                          num_heads: int, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bank read on the storage layout.

    q: [B, HWq, H*D] (unscaled); k_bank: [B, T_cap, HWk, H*D]; v_bank: [B,
    T_cap, HWk, H*Dv], or two banks whose channel-wise concatenation is
    that tensor, each holding whole heads; valid: [B, T_cap] live physical
    slots. Returns (out [B, HWq, H*Dv] f32, mass [B, HWq, T_cap] f32, the
    mean over heads).
    """
    refuse_autograd('memory_read_multihead', q, k_bank, *_banks(v_bank))
    if q.device.type == 'cpu':
        return memory_read_multihead_plain(q, k_bank, v_bank, valid,
                                           num_heads, scale)
    out, mass = _launch(scale_in_dtype(q, scale), k_bank, _banks(v_bank),
                        valid, num_heads)
    return out, mass.mean(1)
