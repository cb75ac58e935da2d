"""Long-Short-Term Transformer (AOT) over the memory bank.

Counterpart of the JAX package's `models/lstt.py` (reference
aot_plus/networks/layers/transformer.py:133-697, LongShortTermTransformer
and SimplifiedTransformerBlock). Memory holds (K, V) per layer. In eval
mode, with more than one bank slot, the long-term read is kernel B1 in its
multi-head, one-bank mode, which also returns the per-slot attention mass
that drives RMem eviction; the reference frame reads only itself through
plain attention. In training mode the long-term read is dense and
differentiable (keys plus the PE, flattened over the slots, free slots
masked by `bank_key_bias`), and the self-attention and feed-forward
residuals take drop-path, as in the JAX package. The id-fusion projections
applied at memory-update time are module methods, called by the engine
once the mask is known.

Under tensor parallelism (`set_tp`, parallel/tp.py) a block splits by
heads: a rank holds its columns of the query, key and value projections
(its heads of the self-attention, the memory's keys and values) and of
the FFN's first linear, and its rows of the output projections and of
the FFN's second linear, whose partial sums the group adds. The bank
holds the rank's heads; the mass a rank returns is the mean over its
heads, which the engine averages over the group. `norm4` normalises over
all features, so the short-term keys and values are gathered whole for
it; the FFN's GroupNorm(32) stays local, a rank holding whole groups.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.models.gru import ConvGRUCellOutput
from rmem_ocu_tpu_torch.ops.attention import MultiheadAttention, project_rows
from rmem_ocu_tpu_torch.ops.layers import (EPS, DropPath, GNActDWConv2d,
                                           dropout)
from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.parallel.layers import (copy_to_model,
                                                gather_from_model,
                                                reduce_from_model,
                                                scatter_to_model)
from rmem_ocu_tpu_torch.parallel.tp import Layout, ranges_of

SLOT_NEG = -1e9


def bank_key_bias(valid: torch.Tensor, hw: int) -> torch.Tensor:
    """[B, 1, 1, T_cap*HW] additive bias masking free physical slots.
    valid: [B, T_cap] bool per physical slot."""
    bias = torch.where(valid, 0.0, SLOT_NEG)
    return bias.repeat_interleave(hw, dim=-1)[:, None, None, :]


def frame_mass_from_probs(probs: torch.Tensor, capacity: int
                          ) -> torch.Tensor:
    """probs: [B, h, HWq, T_cap*HWk] -> mass [B, HWq, T_cap] (mean over
    heads, summed over each slot's keys; reference transformer.py:636-643).
    """
    b, h, q, tk = probs.shape
    m = probs.reshape(b, h, q, capacity, tk // capacity).float()
    return m.mean(dim=1).sum(dim=-1)


class LSTTBlock(nn.Module):
    """One SimplifiedTransformerBlock (reference transformer.py:466-697)."""

    def __init__(self, d_model: int, self_heads: int = 8, att_heads: int = 8,
                 dim_feedforward: int = 1024, linear_q: bool = False,
                 gru_memory: bool = False, droppath: float = 0.1):
        super().__init__()
        d = d_model
        self.d_model = d
        self.linear_q = linear_q
        self.drop_path = DropPath(droppath)
        self.tp = World()
        self.channels = ((0, d),)       # this rank's heads' channels
        self.norm1 = nn.LayerNorm(d, eps=EPS)
        self.self_attn = MultiheadAttention(d, self_heads)
        self.norm2 = nn.LayerNorm(d, eps=EPS)
        self.linear_Q = nn.Linear(d, d)
        self.linear_V = nn.Linear(d, d)
        self.linear_QMem = nn.Linear(d, d)
        self.linear_VMem = nn.Linear(d, d)
        if not linear_q:
            self.norm4 = nn.LayerNorm(d, eps=EPS)
        self.long_term_attn = MultiheadAttention(d, att_heads,
                                                 use_linear=False)
        self.short_term_attn = MultiheadAttention(d, att_heads,
                                                  use_linear=False)
        self.norm3 = nn.LayerNorm(d, eps=EPS)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.activation = GNActDWConv2d(dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d)
        if gru_memory:
            # [K compressor, V compressor] (reference transformer.py:529-545)
            self.memory_grus = nn.ModuleList([
                ConvGRUCellOutput(d, kernel_size=(2, 2)),
                ConvGRUCellOutput(d, kernel_size=(1, 1))])

    def tp_layout(self) -> Layout:
        """The column- and row-split tensors of the block (parameter name
        -> (dimension, segments)), each one contiguous segment."""
        d, ff = self.d_model, self.linear1.out_features
        out = {}
        for name in ('self_attn.linear_Q', 'self_attn.linear_K',
                     'self_attn.linear_V', 'linear_Q', 'linear_V',
                     'linear_QMem', 'linear_VMem', 'linear1'):
            width = ff if name == 'linear1' else d
            out[f'{name}.weight'] = out[f'{name}.bias'] = (0, (width,))
        for name in ('self_attn', 'long_term_attn', 'short_term_attn'):
            out[f'{name}.projection.weight'] = (1, (d,))
        out['linear2.weight'] = (1, (ff,))
        return out

    def set_tp(self, world: World) -> None:
        """Run as this rank's shard of the model group `world` (the
        parameters already cut by parallel/tp.py `shard_model`)."""
        gn = self.activation.gn
        if gn.num_groups % world.size:
            raise ValueError(f'GroupNorm({gn.num_groups}) of the FFN does '
                             f'not split over a model group of '
                             f'{world.size}')
        for attn in (self.self_attn, self.long_term_attn,
                     self.short_term_attn):
            attn.set_tp(world)
        self.tp = world
        self.channels = ranges_of((self.d_model,), world.rank, world.size)
        self.activation.set_channels(world, ranges_of(
            (gn.num_channels,), world.rank, world.size))

    def _rows(self, partial, linear):
        """The whole output of a row-split projection from this rank's
        partial sum: one sum over the group, then the bias (which
        project_rows already added at one process)."""
        if self.tp.size == 1:
            return partial
        return reduce_from_model(partial, self.tp) + linear.bias

    def _norm4(self, whole):
        """norm4 over all features of a whole tensor, this rank's channels
        of the result."""
        n = self.norm4
        out = F.layer_norm(whole, n.normalized_shape,
                           copy_to_model(n.weight, self.tp),
                           copy_to_model(n.bias, self.tp), n.eps)
        return dist.take(out, self.channels)

    def forward(self, tgt, long_mem, short_kv, curr_id_emb, self_pos,
                size_2d: Tuple[int, int], temporal_pe,
                need_mass: bool = False):
        """tgt: [B, HW, C].
        long_mem: (k_bank [B,T,HW,C], v_bank [B,T,HW,C], valid [B,T] live
        physical slots) or None when curr_id_emb is given (reference frame:
        the memory is the current frame).
        short_kv: (k [B,HW,C], v [B,HW,C]) or None (reference frame).
        temporal_pe: (cur_pe [C], mem_pe [B|1, T, C]) or None.
        Under tensor parallelism k and v of the memories are this rank's
        channels, and so are the memories returned, except curr_v and the
        short-term local_v before its fusion (whole).
        Returns (tgt, memories dict, mass [B,HW,T] or None)."""
        tp, mine = self.tp, self.channels
        _tgt = copy_to_model(self.norm1(tgt), tp)
        q = k = _tgt if self_pos is None else _tgt + self_pos
        tgt = tgt + self.drop_path(self._rows(self.self_attn(q, k, _tgt)[0],
                                              self.self_attn.projection))

        _tgt = self.norm2(tgt)
        curr_q = self.linear_Q(copy_to_model(_tgt, tp))
        curr_k = curr_q
        curr_v = _tgt

        mems = {'curr_k': curr_k, 'curr_v': curr_v}
        if curr_id_emb is not None:
            fused_v = self.fuse_curr_value(curr_v, curr_id_emb)
            mem_k, mem_v = curr_k[:, None], fused_v[:, None]
            valid = None
            local_k, local_v = curr_k, fused_v
            mems['global_v_fused'] = fused_v
        else:
            mem_k, mem_v, valid = long_mem
            local_k, local_v = short_kv

        capacity, hw = mem_k.shape[1], mem_k.shape[2]
        if temporal_pe is not None:
            cur_pe, mem_pe = (scatter_to_model(x, tp, mine)
                              for x in temporal_pe)
            mem_pe = mem_pe[..., :capacity, :]
            if mem_pe.dim() == 2:
                mem_pe = mem_pe[None]
            q_time = curr_q + cur_pe
        else:
            mem_pe, q_time = None, curr_q

        if capacity > 1 and not self.training:
            tgt2, mass = self.long_term_attn.bank_read(
                q_time, mem_k, mem_v, valid, mem_pe=mem_pe)
            if not need_mass:
                mass = None
        else:
            # dense: the PE added to the keys, the slots flattened, free
            # slots masked (the reference frame reads only itself)
            if mem_pe is not None:
                mem_k = mem_k + mem_pe[:, :, None, :]
            b = mem_k.shape[0]
            tgt2, mass = self.long_term_attn(
                q_time, mem_k.reshape(b, capacity * hw, -1),
                mem_v.reshape(b, capacity * hw, -1),
                key_bias=None if capacity == 1 else bank_key_bias(valid, hw),
                mass_capacity=capacity if need_mass else None)

        if self.linear_q:
            tgt3, _ = self.short_term_attn(
                curr_q, torch.cat([local_k, curr_k], dim=1),
                torch.cat([local_v, scatter_to_model(curr_v, tp, mine)],
                          dim=1))
        else:
            d = self.d_model
            tgt3, _ = self.short_term_attn(
                curr_q,
                self._norm4(gather_from_model(local_k + curr_k, tp, mine, d)),
                self._norm4(gather_from_model(local_v, tp, mine, d)
                            + copy_to_model(curr_v, tp)))

        if tp.size > 1:
            # the long- and short-term partial sums in one reduce
            both = reduce_from_model(torch.stack([tgt2, tgt3]), tp)
            tgt2 = both[0] + self.long_term_attn.projection.bias
            tgt3 = both[1] + self.short_term_attn.projection.bias
        local_v_new = tgt3
        if curr_id_emb is not None:
            local_v_new = self.fuse_local_value(local_v_new, curr_id_emb)
        mems['local_k'] = self.linear_QMem(copy_to_model(tgt3, tp))
        mems['local_v'] = local_v_new

        tgt = tgt + tgt2 + tgt3
        _tgt = copy_to_model(self.norm3(tgt), tp)
        ff = self.activation(self.linear1(_tgt), size_2d)
        ff = self._rows(project_rows(self.linear2, ff, tp), self.linear2)
        tgt = tgt + self.drop_path(ff)
        return tgt, mems, mass

    def fuse_curr_value(self, curr_v, id_emb):
        """Long-term value fusion at memory-update time (reference
        transformer.py:278-281); this rank's channels."""
        return self.linear_V(copy_to_model(curr_v + id_emb, self.tp))

    def fuse_local_value(self, local_v, id_emb):
        """Short-term value fusion at memory-update time (reference
        transformer.py:283-286); this rank's channels."""
        return self.linear_VMem(copy_to_model(local_v + id_emb, self.tp))

    def compress_evicted(self, k_slot, v_slot, hidden_k, hidden_v, size_2d):
        """ConvGRU compression of an evicted slot (reference
        transformer.py:420-430). Returns ((out_k, out_v), (hidden_k,
        hidden_v)). The GRU mixes every channel: under tensor parallelism
        the rank's slots are gathered whole, the hidden states are whole
        on every rank, and the rank keeps its channels of the outputs."""
        tp, mine, d = self.tp, self.channels, self.d_model
        k_slot = dist.all_gather(k_slot, tp, mine, d)
        v_slot = dist.all_gather(v_slot, tp, mine, d)
        hk, out_k = self.memory_grus[0](k_slot, hidden_k, size_2d)
        hv, out_v = self.memory_grus[1](v_slot, hidden_v, size_2d)
        return (dist.take(out_k, mine), dist.take(out_v, mine)), (hk, hv)


class LSTTStack(nn.Module):
    """LongShortTermTransformer (reference transformer.py:133-267). In
    training the input tokens are dropped at emb_dropout; the drop-path
    rate grows linearly over the layers from 0 with droppath_scaling."""

    def __init__(self, num_layers: int = 3, d_model: int = 256,
                 self_heads: int = 8, att_heads: int = 8,
                 linear_q: bool = False, gru_memory: bool = False,
                 intermediate_norm: bool = True, emb_dropout: float = 0.0,
                 droppath: float = 0.1, droppath_scaling: bool = False):
        super().__init__()
        self.intermediate_norm = intermediate_norm
        self.emb_dropout = emb_dropout
        self.layers = nn.ModuleList([
            LSTTBlock(d_model, self_heads, att_heads, linear_q=linear_q,
                      gru_memory=gru_memory,
                      droppath=(droppath * idx / max(num_layers - 1, 1)
                                if droppath_scaling else droppath))
            for idx in range(num_layers)])
        # the last norm is the final one
        num_norms = (num_layers - 1 if intermediate_norm else 0) + 1
        self.decoder_norms = nn.ModuleList([
            nn.LayerNorm(d_model, eps=EPS) for _ in range(num_norms)])

    def forward(self, tgt, long_mem, short_mem, curr_id_emb, self_pos,
                size_2d, temporal_pe, need_mass: bool = False
                ) -> Tuple[List[torch.Tensor], List[dict],
                           Optional[torch.Tensor]]:
        """long_mem: (k, v per-layer lists of [B,T,HW,C], valid [B,T]) or
        None; short_mem: (k, v per-layer lists of [B,HW,C]) or None.
        Returns (per-layer outputs, normed, per-layer memories, layer-0
        eviction mass or None)."""
        intermediates, memories = [], []
        mass0 = None
        out = dropout(tgt, self.emb_dropout, self.training)
        for idx, block in enumerate(self.layers):
            lm = None if long_mem is None else (
                long_mem[0][idx], long_mem[1][idx], long_mem[2])
            sm = None if short_mem is None else (
                short_mem[0][idx], short_mem[1][idx])
            out, mems, mass = block(out, lm, sm, curr_id_emb, self_pos,
                                    size_2d, temporal_pe,
                                    need_mass=need_mass and idx == 0)
            if idx == 0:
                mass0 = mass
            intermediates.append(out)
            memories.append(mems)
        intermediates[-1] = self.decoder_norms[-1](intermediates[-1])
        if self.intermediate_norm:
            for i in range(len(intermediates) - 1):
                intermediates[i] = self.decoder_norms[i](intermediates[i])
        return intermediates, memories, mass0
