"""Attention modules of the DeAOT path.

Counterpart of the JAX package's `ops/attention.py`: `scaled_dot_attention`,
`GatedPropagation` (DeAOT's gated attention; reference
aot_plus/networks/layers/attention.py:93-216) and `LocalGatedPropagation`
(its 15x15 windowed short-term attention, reference :220-413). Tokens are
[B, L, C].

The long-term bank read (`GatedPropagation.bank_read`) runs kernel B1 and
the windowed attention runs kernel B2 (ops/kernels/). Self-attention and the
capacity-1 reference-frame read stay plain matmul + softmax.

bf16 storage policy (the JAX package's `_qk_out_dtype` /
`_maybe_compact_logits` at their default): on bf16 inputs the QK logits are
emitted in bf16 and the probabilities are stored in bf16; the softmax
arithmetic is f32. f32 inputs keep f32 throughout.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.kernels.local_attn import local_window_attention
from rmem_ocu_tpu_torch.ops.kernels.memory_read import memory_read_fused
from rmem_ocu_tpu_torch.ops.layers import DWConv2d, scale_in_dtype


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, c = x.shape
    return x.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _compact(x: torch.Tensor, in_dtype: torch.dtype) -> torch.Tensor:
    """bf16 storage of logits/probs on bf16 inputs."""
    if in_dtype == torch.bfloat16 and x.dtype != torch.bfloat16:
        return x.to(torch.bfloat16)
    return x


def scaled_dot_attention(q, k, v, num_heads: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Lq, H*Dq], k: [B, Lk, H*Dq], v: [B, Lk, H*Dv] ->
    [B, Lq, H*Dv]. scale defaults to Dq**-0.5."""
    qh = split_heads(q, num_heads)
    kh = split_heads(k, num_heads)
    vh = split_heads(v, num_heads)
    if scale is None:
        scale = qh.shape[-1] ** -0.5
    # a bf16 matmul accumulates in f32 and rounds once on write
    logits = scale_in_dtype(qh, scale) @ kh.transpose(-1, -2)
    probs = _compact(torch.softmax(logits.float(), dim=-1), q.dtype)
    return merge_heads(probs.to(vh.dtype) @ vh)


class GatedPropagation(nn.Module):
    """DeAOT gated attention. d_vu is the un-expanded value/gate width;
    values are expanded by expand_ratio and gated with SiLU(U) after
    aggregation."""

    def __init__(self, d_qk: int, d_vu: int, num_heads: int = 8,
                 d_att: Optional[int] = None, expand_ratio: float = 2.0,
                 use_linear: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.use_linear = use_linear
        self.expand_d_vu = int(d_vu * expand_ratio)
        self.hidden = self.expand_d_vu // num_heads
        self.att_dim = d_qk // num_heads if d_att is None else d_att
        if use_linear:
            half = self.hidden * num_heads // 2
            self.linear_QK = nn.Linear(d_qk, self.att_dim * num_heads)
            self.linear_V1 = nn.Linear(d_vu // 2, half)
            self.linear_V2 = nn.Linear(d_vu // 2, half)
            self.linear_U1 = nn.Linear(d_vu // 2, half)
            self.linear_U2 = nn.Linear(d_vu // 2, half)
        self.dw_conv = DWConv2d(self.expand_d_vu)
        self.projection = nn.Linear(self.expand_d_vu, d_vu)

    def _cat_half(self, x1, x2):
        """Interleave the two halves per head (reference
        attention.py:154-162)."""
        if self.num_heads > 1:
            b, l, half = x1.shape
            hd = half // self.num_heads
            return torch.cat([x1.reshape(b, l, self.num_heads, hd),
                              x2.reshape(b, l, self.num_heads, hd)],
                             -1).reshape(b, l, -1)
        return torch.cat([x1, x2], -1)

    def _project_inputs(self, q, v, u):
        q = self.linear_QK(q)
        v1, v2 = v.chunk(2, dim=-1)
        v = F.silu(self._cat_half(self.linear_V1(v1), self.linear_V2(v2)))
        u1, u2 = u.chunk(2, dim=-1)
        u = F.silu(self._cat_half(self.linear_U1(u1), self.linear_U2(u2)))
        return q, v, u

    def _gate_and_project(self, out, u, size_2d):
        return self.projection(self.dw_conv(out * u, size_2d))

    def forward(self, q, k, v, u, size_2d: Tuple[int, int]) -> torch.Tensor:
        if self.use_linear:
            q, v, u = self._project_inputs(q, v, u)
            k = q
        out = scaled_dot_attention(q, k, v, self.num_heads,
                                   scale=self.att_dim ** -0.5)
        return self._gate_and_project(out, u, size_2d)

    def multi_value_call(self, q, k, vs: Sequence[torch.Tensor], u,
                         size_2d) -> torch.Tensor:
        """Single-head gated attention sharing one probability matrix
        across several value banks: concat_i(P @ vs[i]), gated and
        projected; equals forward(q, k, concat(vs)) with one head."""
        if self.num_heads != 1:
            raise ValueError('shared-probs split requires one head')
        logits = scale_in_dtype(q, self.att_dim ** -0.5) @ k.transpose(1, 2)
        probs = _compact(torch.softmax(logits.float(), dim=-1), q.dtype)
        attn = probs.to(vs[0].dtype)
        out = torch.cat([attn @ v for v in vs], dim=-1)
        return self._gate_and_project(out, u, size_2d)

    def bank_read(self, q, k_bank, v_bank, id_v_bank, u, valid, size_2d,
                  mem_pe=None):
        """Long-term read over the bank through kernel B1.

        k_bank [B, T, HW, Datt], v_bank / id_v_bank [B, T, HW, E] (DeAOT's
        value and id-value halves, which the reference concatenates
        channel-wise), valid [B, T], mem_pe optional [B|1, T, Datt].
        Returns (out, mass [B, HWq, T])."""
        if self.num_heads != 1:
            raise NotImplementedError(
                'the multi-head bank read (kernel B3) is not ported yet')
        # the kernel rounds its operands to bf16 even on f32 inputs, as the
        # reference's bank_read does (precise=False)
        (o_v, o_id), mass = memory_read_fused(
            q, k_bank, (v_bank, id_v_bank), valid, 1, self.att_dim ** -0.5,
            mem_pe=mem_pe)
        raw = torch.cat([o_v, o_id], dim=-1)
        return self._gate_and_project(raw.to(q.dtype), u, size_2d), mass


class LocalGatedPropagation(nn.Module):
    """15x15 windowed gated attention over the short-term memory, one head,
    without input projections (the GPM configuration). The relative
    position bias is a learned 1x1 conv of the query (reference
    attention.py:260-264, 314)."""

    def __init__(self, d_qk: int, d_vu: int, num_heads: int = 1,
                 max_dis: int = 7, d_att: Optional[int] = None,
                 expand_ratio: float = 2.0):
        super().__init__()
        if num_heads != 1:
            raise NotImplementedError(
                'windowed attention is ported for one head (the GPM case)')
        self.max_dis = max_dis
        ws = 2 * max_dis + 1
        self.d_att = d_qk // num_heads if d_att is None else d_att
        expand_d_vu = int(d_vu * expand_ratio)
        self.relative_emb_k = nn.Conv2d(self.d_att * num_heads,
                                        num_heads * ws * ws, kernel_size=1,
                                        groups=num_heads)
        self.dw_conv = DWConv2d(expand_d_vu)
        self.projection = nn.Linear(expand_d_vu, d_vu)

    def forward(self, q, k, v, u, size_2d: Tuple[int, int]) -> torch.Tensor:
        """q, k: [B, HW, Datt]; v, u: [B, HW, E]."""
        w = self.relative_emb_k.weight
        rel = F.linear(q, w.reshape(w.shape[0], w.shape[1]),
                       self.relative_emb_k.bias)          # [B, HW, ws*ws]
        out = local_window_attention(
            scale_in_dtype(q, self.d_att ** -0.5), k.contiguous(), v,
            rel.float().contiguous(), size_2d, self.max_dis,
            precise=q.dtype == torch.float32)
        return self.projection(self.dw_conv(out * u, size_2d))
