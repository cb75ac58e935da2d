"""Attention modules.

Counterpart of the JAX package's `ops/attention.py`: `scaled_dot_attention`,
`MultiheadAttention` (the LSTT's self / long-term / short-term attention;
reference aot_plus/networks/layers/attention.py:8-86), `GatedPropagation`
(DeAOT's gated attention; reference :93-216) and `LocalGatedPropagation`
(its 15x15 windowed short-term attention, reference :220-413). Tokens are
[B, L, C].

The long-term bank read runs a kernel of ops/kernels/: B1 for
`MultiheadAttention.bank_read` and for `GatedPropagation.bank_read` with one
head, B3 for `GatedPropagation.bank_read` with several heads. The one-head
windowed attention runs kernel B2 in eval mode; in training mode, and with
several heads, it is the dense padded-grid form, as in the JAX package.
Self-attention, the capacity-1 reference-frame read and every read in
training mode stay plain matmul + softmax, which autograd differentiates
(the kernels have no backward; the JAX package runs its kernels only when
`deterministic`). In training mode the probabilities are dropped at the
module's `dropout` rate (reference attention.py:61, 348).

Under tensor parallelism (parallel/tp.py, `set_tp`) a module holds its
shards of the column-split input projections and of the row-split output
`projection`, and returns the rank's partial sum of the projected output,
without the projection's bias: the caller (the LSTT or GPM block) sums
the partials over the model group and adds the bias once. The LSTT's
attention splits by heads (`heads_here` of them on a rank). The gated
attentions keep their query and keys whole on every rank and split their
values by channel inside each of the value's two halves (V and ID_V, or
the halves of `_cat_half`; their depthwise conv and projection follow the
same channels), so that every rank computes the same probabilities, and
the same eviction mass, with no collective but the gather of the query.

bf16 storage policy (the JAX package's `_qk_out_dtype` /
`_maybe_compact_logits`): by default, on bf16 inputs the QK logits are
emitted in bf16 and the probabilities are stored in bf16; the softmax
arithmetic is f32. f32 inputs keep f32 throughout. `RMEM_BF16_PROBS=0`
(or `false`, `False`), read at each call as the JAX package reads it at
each trace, keeps the logits and probabilities of bf16 inputs in f32
storage at the plain attention sites: `scaled_dot_attention`,
`GatedPropagation.multi_value_call`, `LocalGatedPropagation._dense_core`
and Swin's `WindowAttention`. The PV product still reads the
probabilities in the values' dtype. The kernels B1, B2 and B3 ignore the
switch, as the JAX package's Pallas kernels do.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.ops.kernels.local_attn import (NEG_INF,
                                                       _local_window_maps,
                                                       local_window_attention)
from rmem_ocu_tpu_torch.ops.kernels.memory_read import memory_read_fused
from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import \
    memory_read_multihead
from rmem_ocu_tpu_torch.ops.layers import (DWConv2d, dropout,
                                           scale_in_dtype, tokens_from_2d,
                                           tokens_to_2d)
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.parallel.layers import (copy_to_model,
                                                gather_from_model)
from rmem_ocu_tpu_torch.parallel.tp import ranges_of


@functools.lru_cache(maxsize=2)
def _window_maps_on(device: torch.device, h: int, w: int, max_dis: int):
    """(inside [HW, HpWp] bool: the key lies in the query's window and in
    the image; bias index [HW, HpWp] int64) of the dense windowed
    attention, copied to `device` once: a copy per call would synchronise
    the stream. All layers share the entry of the current grid; only two
    grids are held, so a run over many resolutions does not pin a pair of
    device tensors for each."""
    inside, idx = _local_window_maps(h, w, max_dis)
    return (torch.from_numpy(inside).to(device),
            torch.from_numpy(idx).to(device))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, c = x.shape
    return x.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def bf16_probs() -> bool:
    """Whether bf16 attention stores its logits and probabilities in bf16:
    true unless RMEM_BF16_PROBS is '0', 'false' or 'False' (the JAX
    package's values), read at each call."""
    return os.environ.get('RMEM_BF16_PROBS', '1') not in ('0', 'false',
                                                          'False')


def _compact(x: torch.Tensor, in_dtype: torch.dtype) -> torch.Tensor:
    """bf16 storage of logits/probs on bf16 inputs (unless bf16_probs()
    is off)."""
    if (in_dtype == torch.bfloat16 and x.dtype != torch.bfloat16
            and bf16_probs()):
        return x.to(torch.bfloat16)
    return x


def qk_logits(q: torch.Tensor, k: torch.Tensor, scale: float
              ) -> torch.Tensor:
    """(q * scale) @ k^T over the last two axes, the scale applied in q's
    dtype. A bf16 matmul accumulates in f32 and rounds once on write; with
    bf16_probs() off the bf16 operands are upcast after the scale, so the
    logits are the same sums emitted in f32 (a bf16 value is exact in f32
    and in TF32, whose 10-bit mantissa is wider than bf16's 7, and the
    product of two is exact in f32)."""
    q = scale_in_dtype(q, scale)
    if q.dtype == torch.bfloat16 and not bf16_probs():
        q, k = q.float(), k.float()
    return q @ k.transpose(-1, -2)


def scaled_dot_attention(q, k, v, num_heads: int,
                         scale: Optional[float] = None, key_bias=None,
                         mass_capacity: Optional[int] = None,
                         dropout_rate: float = 0.0, training: bool = False):
    """q: [B, Lq, H*Dq], k: [B, Lk, H*Dq], v: [B, Lk, H*Dv]. scale
    defaults to Dq**-0.5; key_bias, broadcastable to [B, H, Lq, Lk], is
    added to the logits; in training the probabilities are dropped at
    dropout_rate. Returns (out [B, Lq, H*Dv], mass), where mass is the
    per-slot attention mass [B, Lq, T] (f32, mean over heads, of the
    probabilities before dropout) when mass_capacity=T is given and the
    keys are T slots of Lk/T, else None."""
    qh = split_heads(q, num_heads)
    kh = split_heads(k, num_heads)
    vh = split_heads(v, num_heads)
    if scale is None:
        scale = qh.shape[-1] ** -0.5
    logits = qk_logits(qh, kh, scale)
    if key_bias is not None:
        logits = logits + key_bias.to(logits.dtype)
    probs = _compact(torch.softmax(logits.float(), dim=-1), q.dtype)
    attn = dropout(probs, dropout_rate, training)
    out = merge_heads(attn.to(vh.dtype) @ vh)
    if mass_capacity is None:
        return out, None
    b, h, nq, nk = probs.shape
    mass = probs.float().reshape(b, h, nq, mass_capacity, -1).sum(-1)
    return out, mass.mean(1)


def _split_values(module, world: World) -> None:
    """A gated attention's values split over the model group `world`:
    the rank's part of each half of the value channels."""
    half = module.projection.in_features // 2
    module.tp = world
    module.dw_conv.set_channels(world, ranges_of((half, half), world.rank,
                                                 world.size))


def project_rows(linear: nn.Linear, x: torch.Tensor,
                 tp: World) -> torch.Tensor:
    """linear(x), or, with x the rank's input columns of a row-split
    linear, the rank's partial sum without the bias."""
    if tp.size == 1:
        return linear(x)
    return F.linear(x, linear.weight)


class MultiheadAttention(nn.Module):
    """Reference attention.py:8-86. use_linear controls the Q/K/V
    projections; the output projection always exists. Under tensor
    parallelism a rank holds `heads_here` of the heads (the mass it
    returns is the mean over them) and returns its partial output."""

    def __init__(self, d_model: int, num_heads: int = 8,
                 use_linear: bool = True, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.use_linear = use_linear
        self.dropout = dropout
        self.tp = World()
        self.heads_here = num_heads
        if use_linear:
            self.linear_Q = nn.Linear(d_model, d_model)
            self.linear_K = nn.Linear(d_model, d_model)
            self.linear_V = nn.Linear(d_model, d_model)
        self.projection = nn.Linear(d_model, d_model)

    def set_tp(self, world: World) -> None:
        if self.num_heads % world.size:
            raise ValueError(f'{self.num_heads} heads do not split over a '
                             f'model group of {world.size}')
        self.tp, self.heads_here = world, self.num_heads // world.size

    def forward(self, q, k, v, key_bias=None,
                mass_capacity: Optional[int] = None):
        """Returns (projected out, mass or None); see
        scaled_dot_attention."""
        if self.use_linear:
            q, k, v = self.linear_Q(q), self.linear_K(k), self.linear_V(v)
        out, mass = scaled_dot_attention(q, k, v, self.heads_here,
                                         key_bias=key_bias,
                                         mass_capacity=mass_capacity,
                                         dropout_rate=self.dropout,
                                         training=self.training)
        return project_rows(self.projection, out, self.tp), mass

    def bank_read(self, q, k_bank, v_bank, valid, mem_pe=None):
        """Long-term read over the bank through kernel B1 in its
        multi-head, one-bank mode: k_bank / v_bank [B, T, HW, C], valid
        [B, T] live physical slots, mem_pe optional [B|1, T, C] temporal PE
        (the logit term q.pe_t inside the kernel). Returns (projected out,
        mass [B, HWq, T])."""
        scale = (self.d_model // self.num_heads) ** -0.5
        (raw,), mass = memory_read_fused(q, k_bank, (v_bank,), valid,
                                         self.heads_here, scale,
                                         mem_pe=mem_pe)
        return project_rows(self.projection, raw.to(q.dtype), self.tp), mass


class GatedPropagation(nn.Module):
    """DeAOT gated attention. d_vu is the un-expanded value/gate width;
    values are expanded by expand_ratio and gated with SiLU(U) after
    aggregation."""

    def __init__(self, d_qk: int, d_vu: int, num_heads: int = 8,
                 d_att: Optional[int] = None, expand_ratio: float = 2.0,
                 use_linear: bool = True, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_linear = use_linear
        self.expand_d_vu = int(d_vu * expand_ratio)
        self.hidden = self.expand_d_vu // num_heads
        self.att_dim = d_qk // num_heads if d_att is None else d_att
        self.tp = World()
        if use_linear:
            half = self.hidden * num_heads // 2
            self.linear_QK = nn.Linear(d_qk, self.att_dim * num_heads)
            self.linear_V1 = nn.Linear(d_vu // 2, half)
            self.linear_V2 = nn.Linear(d_vu // 2, half)
            self.linear_U1 = nn.Linear(d_vu // 2, half)
            self.linear_U2 = nn.Linear(d_vu // 2, half)
        self.dw_conv = DWConv2d(self.expand_d_vu)
        self.projection = nn.Linear(self.expand_d_vu, d_vu)

    def set_tp(self, world: World) -> None:
        """Query and keys whole on every rank (the projected query is
        gathered), the values split inside each half."""
        if self.use_linear and self.num_heads != 1:
            raise NotImplementedError(
                f'a gated self-attention of {self.num_heads} heads under '
                f'tensor parallelism (its _cat_half interleaves the heads)')
        _split_values(self, world)

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
        width = self.att_dim * self.num_heads
        q = gather_from_model(q, self.tp, ranges_of(
            (width,), self.tp.rank, self.tp.size), width)
        v1, v2 = v.chunk(2, dim=-1)
        v = F.silu(self._cat_half(self.linear_V1(v1), self.linear_V2(v2)))
        u1, u2 = u.chunk(2, dim=-1)
        u = F.silu(self._cat_half(self.linear_U1(u1), self.linear_U2(u2)))
        return q, v, u

    def _gate_and_project(self, out, u, size_2d):
        return project_rows(self.projection, self.dw_conv(out * u, size_2d),
                            self.tp)

    def forward(self, q, k, v, u, size_2d: Tuple[int, int], key_bias=None,
                mass_capacity: Optional[int] = None):
        """Returns (out, mass or None); see scaled_dot_attention."""
        if self.use_linear:
            q, v, u = self._project_inputs(q, v, u)
            k = q
        out, mass = scaled_dot_attention(
            q, k, v, self.num_heads, scale=self.att_dim ** -0.5,
            key_bias=key_bias, mass_capacity=mass_capacity,
            dropout_rate=self.dropout, training=self.training)
        return self._gate_and_project(out, u, size_2d), mass

    def multi_value_call(self, q, k, vs: Sequence[torch.Tensor], u,
                         size_2d, key_bias=None,
                         mass_capacity: Optional[int] = None):
        """Single-head gated attention sharing one probability matrix
        across several value banks: concat_i(P @ vs[i]), gated and
        projected; equals forward(q, k, concat(vs)) with one head.
        key_bias: [B, 1, 1, Lk] or None. Returns (out, mass [B, Lq, T] of
        the keys' T slots when mass_capacity=T, else None)."""
        if self.num_heads != 1:
            raise ValueError('shared-probs split requires one head')
        logits = qk_logits(q, k, self.att_dim ** -0.5)
        if key_bias is not None:
            logits = logits + key_bias.reshape(
                key_bias.shape[0], 1, -1).to(logits.dtype)
        probs = _compact(torch.softmax(logits.float(), dim=-1), q.dtype)
        attn = dropout(probs, self.dropout, self.training).to(vs[0].dtype)
        out = torch.cat([attn @ v for v in vs], dim=-1)
        mass = None
        if mass_capacity is not None:
            b, nq, _ = probs.shape
            mass = probs.float().reshape(b, nq, mass_capacity, -1).sum(-1)
        return self._gate_and_project(out, u, size_2d), mass

    def bank_read(self, q, k_bank, v_bank, id_v_bank, u, valid, size_2d,
                  mem_pe=None):
        """Long-term read over the bank: kernel B1 with one head, kernel
        B3 with several.

        k_bank [B, T, HW, H*Datt], v_bank / id_v_bank [B, T, HW, E] (DeAOT's
        value and id-value halves, which the reference concatenates
        channel-wise), valid [B, T], mem_pe optional [B|1, T, H*Datt].
        The kernels round their operands to bf16 even on f32 inputs, as the
        reference's bank_read does. Returns (out, mass [B, HWq, T])."""
        scale = self.att_dim ** -0.5
        if self.num_heads == 1:
            # V and ID_V share one probability matrix
            (o_v, o_id), mass = memory_read_fused(
                q, k_bank, (v_bank, id_v_bank), valid, 1, scale,
                mem_pe=mem_pe)
            raw = torch.cat([o_v, o_id], dim=-1)
        else:
            # head i of V||ID_V straddles the halves differently per head
            # count; the PE goes onto the keys, in the bank's dtype
            if mem_pe is not None:
                k_bank = k_bank + mem_pe[:, :, None, :].to(k_bank.dtype)
            if self.num_heads % 2 == 0:
                # each head lies in one half: no bank-sized concatenation
                cat_v = (v_bank, id_v_bank)
            else:
                cat_v = torch.cat([v_bank, id_v_bank], dim=-1)
            raw, mass = memory_read_multihead(q, k_bank, cat_v, valid,
                                              self.num_heads, scale)
        return self._gate_and_project(raw.to(q.dtype), u, size_2d), mass


class LocalGatedPropagation(nn.Module):
    """15x15 windowed gated attention over the short-term memory, without
    input projections (the GPM configuration). The relative position bias
    is a learned grouped 1x1 conv of the query: head i's bias reads only
    head i's query channels (reference attention.py:260-264, 314). One
    head runs kernel B2 in eval mode; training mode and several heads run
    the dense padded-grid form, as the JAX package does, with the
    probabilities dropped at `dropout` in training."""

    def __init__(self, d_qk: int, d_vu: int, num_heads: int = 1,
                 max_dis: int = 7, d_att: Optional[int] = None,
                 expand_ratio: float = 2.0, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.max_dis = max_dis
        self.dropout = dropout
        ws = 2 * max_dis + 1
        self.d_att = d_qk // num_heads if d_att is None else d_att
        self.tp = World()
        expand_d_vu = int(d_vu * expand_ratio)
        self.relative_emb_k = nn.Conv2d(self.d_att * num_heads,
                                        num_heads * ws * ws, kernel_size=1,
                                        groups=num_heads)
        self.dw_conv = DWConv2d(expand_d_vu)
        self.projection = nn.Linear(expand_d_vu, d_vu)

    def set_tp(self, world: World) -> None:
        """Query, keys and the relative bias whole on every rank, the
        values split inside each half (V and ID_V)."""
        _split_values(self, world)

    def forward(self, q, k, v, u, size_2d: Tuple[int, int]) -> torch.Tensor:
        """q, k: [B, HW, H*Datt]; v, u: [B, HW, E] (the rank's channels
        under tensor parallelism)."""
        # the whole bias weights meet each rank's value shard
        w = copy_to_model(self.relative_emb_k.weight, self.tp)
        bias = copy_to_model(self.relative_emb_k.bias, self.tp)
        if self.num_heads == 1 and not self.training:
            rel = F.linear(q, w.reshape(w.shape[0], w.shape[1]),
                           bias)                          # [B, HW, ws*ws]
            out = local_window_attention(
                scale_in_dtype(q, self.d_att ** -0.5), k.contiguous(), v,
                rel.float().contiguous(), size_2d, self.max_dis,
                precise=q.dtype == torch.float32)
        else:
            b, hw, _ = q.shape
            h = self.num_heads
            rel = torch.einsum(
                'blhd,hjd->bhlj', q.reshape(b, hw, h, self.d_att),
                w.reshape(h, -1, self.d_att))
            rel = rel + bias.reshape(h, 1, -1)
            out = self._dense_core(q, k, v, rel, size_2d)
        return project_rows(self.projection, self.dw_conv(out * u, size_2d),
                            self.tp)

    def _dense_core(self, q, k, v, rel, size_2d):
        """One attention over the zero-padded key grid, [HW, Hp*Wp] logits
        per head, with the bias rel [B, H, HW, ws*ws] gathered onto the
        grid and -1e8 outside the window or the image."""
        md = self.max_dis
        b = q.shape[0]
        inside, idx = _window_maps_on(q.device, size_2d[0], size_2d[1], md)

        def padded(x):
            return tokens_from_2d(F.pad(tokens_to_2d(x, size_2d),
                                        (md, md, md, md)))

        kh = split_heads(padded(k), self.num_heads)
        vh = split_heads(padded(v), self.num_heads)
        logits = qk_logits(split_heads(q, self.num_heads), kh,
                           self.d_att ** -0.5)
        bias = torch.gather(F.pad(rel, (0, 1)), 3,          # sentinel -> 0
                            idx.expand(b, self.num_heads, -1, -1))
        extra = bias + torch.where(inside, 0.0, NEG_INF).to(bias.dtype)
        logits = logits + extra.to(logits.dtype)
        probs = _compact(torch.softmax(logits.float(), dim=-1), q.dtype)
        probs = dropout(probs, self.dropout, self.training)
        return merge_heads(probs.to(vh.dtype) @ vh)
