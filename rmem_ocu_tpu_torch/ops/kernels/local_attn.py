"""Kernel B2: one-head local-window attention (DeAOT short-term read).

Counterpart of `rmem_ocu_tpu/ops/pallas/local_attn.py:local_window_attention`
as called by `LocalGatedPropagation._pallas_core`. `local_window_attention`
launches the CUDA kernel of `csrc/local_attn.cu` on a CUDA tensor and runs
the plain PyTorch version on a CPU tensor; it never falls back from a CUDA
tensor. `local_window_attention_plain` is the plain version for any device:
a dense attention over the zero-padded key grid with a window mask and a
gathered bias (the JAX package's `_dense_core`), independent of the
kernel's indexing. The wrapper has no backward and raises on an input
that requires grad under grad mode, on every device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rmem_ocu_tpu_torch.ops.kernels import build
from rmem_ocu_tpu_torch.ops.kernels.memory_read import (_mm, read_operands,
                                                        refuse_autograd)
from rmem_ocu_tpu_torch.ops.layers import tokens_from_2d, tokens_to_2d
from rmem_ocu_tpu_torch.utils import tracing

NEG_INF = -1e8
MAX_HEAD_DIM = 128
MAX_VALUE_DIM = 1024    # of the f32 (precise) kernel
MAX_DIS = 7


@functools.lru_cache(maxsize=32)
def _local_window_maps(h: int, w: int, max_dis: int):
    """(mask [HW, HpWp] bool: key inside the query's window and the image,
    rel_idx [HW, HpWp] int64: window offset dy*ws+dx inside the window,
    ws*ws (a zero-bias sentinel) elsewhere) over the padded key grid."""
    ws = 2 * max_dis + 1
    hp, wp = h + 2 * max_dis, w + 2 * max_dis
    qy, qx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    ky, kx = np.meshgrid(np.arange(hp), np.arange(wp), indexing='ij')
    dy = ky.reshape(1, -1) - qy.reshape(-1, 1)
    dx = kx.reshape(1, -1) - qx.reshape(-1, 1)
    inside = (dy >= 0) & (dy < ws) & (dx >= 0) & (dx < ws)
    in_image = ((ky.reshape(1, -1) >= max_dis)
                & (ky.reshape(1, -1) < h + max_dis)
                & (kx.reshape(1, -1) >= max_dis)
                & (kx.reshape(1, -1) < w + max_dis))
    rel = np.where(inside, dy * ws + dx, ws * ws)
    return inside & in_image, rel.astype(np.int64)


def local_window_attention_plain(q, k, v, rel, size_2d: Tuple[int, int],
                                 max_dis: int, precise: bool):
    """The plain PyTorch version of `local_window_attention`."""
    h, w = size_2d
    b = q.shape[0]
    md = max_dis
    mask_np, idx_np = _local_window_maps(h, w, md)
    mask = torch.from_numpy(mask_np).to(q.device)
    idx = torch.from_numpy(idx_np).to(q.device)

    def padded(x):
        return tokens_from_2d(F.pad(tokens_to_2d(x, size_2d),
                                    (md, md, md, md)))

    logits = _mm(q, precise) @ _mm(padded(k), precise).transpose(1, 2)
    rel_ext = F.pad(rel.float(), (0, 1))                 # sentinel -> 0
    bias = torch.gather(rel_ext, 2, idx.expand(b, -1, -1))
    logits = logits + bias + torch.where(mask, 0.0, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    if not precise:
        p = p.to(torch.bfloat16).float()
    return (p @ _mm(padded(v), precise)).to(v.dtype)


def _lib():
    lib = build.load('local_attn')
    fn = lib.rmem_local_window_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_info(head_dim: int, max_dis: int):
    """(registers, shared memory bytes, local spill bytes per thread) of
    the bf16 kernel at these shapes, from the CUDA runtime."""
    out = (ctypes.c_int * 3)()
    rc = build.load('local_attn').rmem_local_attn_info(head_dim, max_dis, out)
    if rc != 0:
        raise RuntimeError(f'local_attn kernel info failed: CUDA error {rc}')
    return tuple(out)


def _launch(q, k, v, rel, size_2d, max_dis, precise):
    h, w = size_2d
    b, hw, d = q.shape
    e = v.shape[-1]
    ws2 = (2 * max_dis + 1) ** 2
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'local_window_attention takes f32 or bf16, '
                        f'got {q.dtype}')
    for x in (k, v):
        if x.device != q.device or x.dtype != q.dtype:
            raise TypeError('q, k and v must share device and dtype')
    if rel.device != q.device or rel.dtype != torch.float32:
        raise TypeError('rel must be float32 on the device of q')
    for x in (q, k, v, rel):
        if not x.is_contiguous():
            raise ValueError('local_window_attention takes contiguous tensors')
    if (hw != h * w or tuple(k.shape) != (b, hw, d) or v.shape[:2] != (b, hw)
            or tuple(rel.shape) != (b, hw, ws2)):
        raise ValueError(f'shapes q {tuple(q.shape)} k {tuple(k.shape)} '
                         f'v {tuple(v.shape)} rel {tuple(rel.shape)} do not '
                         f'match a {h}x{w} grid')
    if d > MAX_HEAD_DIM or e % 8 or max_dis > MAX_DIS:
        raise ValueError(f'needs D <= {MAX_HEAD_DIM}, E % 8 == 0 and '
                         f'max_dis <= {MAX_DIS}')
    if precise and e > MAX_VALUE_DIM:
        raise ValueError(f'the f32 kernel needs E <= {MAX_VALUE_DIM}')
    if not precise and d not in (16, 32, 64, 128):
        raise ValueError('the bf16 kernel needs D in (16, 32, 64, 128)')
    out = torch.empty_like(v)
    if not precise:  # bf16 operands on the tensor cores
        q, k, v = read_operands(q, k, v)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(),
                out.data_ptr(), b, h, w, d, e, max_dis,
                int(out.dtype == torch.bfloat16), int(not precise),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'local_attn kernel launch failed: CUDA error {rc}')
    tracing.count('kernels.b2.launches')
    return out


def local_window_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, rel: torch.Tensor,
                           size_2d: Tuple[int, int], max_dis: int,
                           precise: bool) -> torch.Tensor:
    """Windowed attention of each query over its (2*max_dis+1)^2 window.

    q, k: [B, HW, D] (q pre-scaled); v: [B, HW, E]; rel: [B, HW, ws*ws] f32
    relative bias indexed by window offset dy*ws + dx. Keys outside the
    image take no part. Softmax in f32; precise=False rounds the matrix
    operands and p to bf16. Returns [B, HW, E] in v.dtype.
    """
    refuse_autograd('local_window_attention', q, k, v, rel)
    if q.device.type == 'cpu':
        return local_window_attention_plain(q, k, v, rel, size_2d, max_dis,
                                            precise)
    return _launch(q, k, v, rel, size_2d, max_dis, precise)
