"""Dual-branch Gated Propagation Module (DeAOT) over the memory bank.

Counterpart of the JAX package's `models/gpm.py` (reference
aot_plus/networks/layers/transformer.py:700-1249). The visual branch (tgt)
and the id branch (tgt_id) propagate jointly; memory holds (K, V, ID_V) per
layer. In eval mode, with more than one bank slot, the long-term read is
kernel B1 (one attention head) or B3 (several), which also return the
per-slot attention mass that drives RMem eviction; the short-term read is
kernel B2 with one head and the dense padded-grid attention with several.
In training mode every read is dense and differentiable (keys plus the PE,
flattened over the slots, free slots masked by `bank_key_bias`, as the JAX
package reads when not `deterministic`), and the train-time dropouts and
drop-path of the JAX package apply: the long+short residual's dropout (or
drop-path with `droppath_lst`), the attention-probability dropouts, the
gated attentions' channel dropout and the self-attention's drop-path.

Under tensor parallelism (`set_tp`, parallel/tp.py) the query and keys
stay whole on every rank, and the values split by channel inside each
head: a rank projects its rows of the query segment of `linear_QV` and
gathers the whole query (the only activation that crosses the model
group on the way in), keeps its columns of V, ID_V and the gates, reads
its value shard of the bank through B1 (one head) or B3 (two), and its
shard of the short-term values through B2. Every rank computes the same
probabilities, so the eviction mass is the same on every rank with no
collective. The long- and short-term outputs are row-split partial sums:
they are added first and summed over the group once; the self-attention
takes one more sum.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rmem_ocu_tpu_torch.models.lstt import bank_key_bias
from rmem_ocu_tpu_torch.ops.attention import (GatedPropagation,
                                              LocalGatedPropagation)
from rmem_ocu_tpu_torch.ops.layers import (EPS, DropPath, GroupNorm1D,
                                           dropout)
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.parallel.layers import (copy_to_model,
                                                gather_from_model,
                                                reduce_from_model)
from rmem_ocu_tpu_torch.parallel.tp import Layout, ranges_of


class GPMBlock(nn.Module):
    """GatedPropagationModule (reference transformer.py:1010-1249)."""

    def __init__(self, d_model: int, self_heads: int = 1, att_heads: int = 1,
                 layer_idx: int = 0, expand_ratio: float = 2.0,
                 max_local_dis: int = 7, droppath: float = 0.1,
                 lt_dropout: float = 0.0, st_dropout: float = 0.0,
                 droppath_lst: bool = False):
        super().__init__()
        d = d_model
        self.att_heads = att_heads
        self.lst_dropout = max(lt_dropout, st_dropout)
        self.droppath_lst = droppath_lst
        self.expand_d_model = int(d * expand_ratio)
        # d_att: d/2 for one head, d/heads otherwise (reference :1033)
        self.d_att = d // 2 if att_heads == 1 else d // att_heads
        self.norm1 = nn.LayerNorm(d, eps=EPS)
        self.linear_QV = nn.Linear(d, self.d_att * att_heads
                                   + self.expand_d_model)
        self.linear_U = nn.Linear(d, self.expand_d_model)
        if layer_idx == 0:
            self.linear_ID_V = nn.Linear(d, self.expand_d_model)
        else:
            self.id_norm1 = nn.LayerNorm(d, eps=EPS)
            self.linear_ID_V = nn.Linear(2 * d, self.expand_d_model)
            self.linear_ID_U = nn.Linear(d, self.expand_d_model)
        # the lt / st dropout rates reach the attention probabilities too
        # (reference transformer.py:1053, 1065)
        self.long_term_attn = GatedPropagation(
            d_qk=d, d_vu=d * 2, num_heads=att_heads, use_linear=False,
            d_att=self.d_att, expand_ratio=expand_ratio, dropout=lt_dropout)
        self.short_term_attn = LocalGatedPropagation(
            d_qk=d, d_vu=d * 2, num_heads=att_heads, d_att=self.d_att,
            max_dis=max_local_dis, expand_ratio=expand_ratio,
            dropout=st_dropout)
        self.norm2 = nn.LayerNorm(d, eps=EPS)
        self.id_norm2 = nn.LayerNorm(d, eps=EPS)
        self.self_attn = GatedPropagation(
            d_qk=d * 2, d_vu=d * 2, num_heads=self_heads, d_att=self.d_att,
            expand_ratio=expand_ratio)
        self.drop_path = DropPath(droppath)
        self.tp = World()

    def tp_layout(self) -> Layout:
        """The column- and row-split tensors of the block (parameter name
        -> (dimension, segments)): the query and value segments of
        linear_QV apart, the value channels of each gated attention as
        its two segments."""
        q, e = self.d_att * self.att_heads, self.expand_d_model
        out = {}

        def col(name, segments):
            out[f'{name}.weight'] = out[f'{name}.bias'] = (0, segments)

        col('linear_QV', (q, e))
        for name in ('linear_U', 'linear_ID_V', 'linear_ID_U'):
            if hasattr(self, name):
                col(name, (e,))
        sa = self.self_attn
        col('self_attn.linear_QK', (sa.att_dim * sa.num_heads,))
        for name in ('linear_V1', 'linear_V2', 'linear_U1', 'linear_U2'):
            col(f'self_attn.{name}', (sa.expand_d_vu // 2,))
        for attn in ('long_term_attn', 'short_term_attn', 'self_attn'):
            out[f'{attn}.projection.weight'] = (1, (e, e))
        return out

    def set_tp(self, world: World) -> None:
        """Run as this rank's shard of the model group `world` (the
        parameters already cut by parallel/tp.py `shard_model`)."""
        if self.att_heads not in (1, 2):
            # V || ID_V splits inside each head only while a head is
            # V, ID_V or both
            raise NotImplementedError(
                f'{self.att_heads} attention heads under tensor '
                f'parallelism: the GPM splits 1 or 2')
        self.tp = world
        self.long_term_attn.set_tp(world)
        self.short_term_attn.set_tp(world)
        self.self_attn.set_tp(world)

    def _rows(self, partial, *linears):
        """The whole output of row-split projections from this rank's
        partial sum of theirs: one sum over the group, then the biases
        (which project_rows already added at one process)."""
        if self.tp.size == 1:
            return partial
        out = reduce_from_model(partial, self.tp)
        for linear in linears:
            out = out + linear.bias
        return out

    def forward(self, tgt, tgt_id, long_mem, short_kv, curr_id_emb,
                size_2d: Tuple[int, int], temporal_pe,
                need_mass: bool = False):
        """tgt: [B, HW, C]; tgt_id: [B, HW, C] or None (first layer).
        long_mem: (k [B,T,HW,H*Datt], v [B,T,HW,E], id_v [B,T,HW,E],
        valid [B,T] live physical slots) or None when curr_id_emb is given.
        short_kv: (k, v, id_v) each [B, HW, *] or None.
        temporal_pe: (cur_pe [H*Datt], mem_pe [B|1, T, H*Datt]) or None.
        Returns (tgt, tgt_id, memories dict, mass or None)."""
        b = tgt.shape[0]
        tp = self.tp
        _tgt = copy_to_model(self.norm1(tgt), tp)
        q_width = self.d_att * self.att_heads
        curr_q, curr_v = self.linear_QV(_tgt).split(
            [q_width // tp.size, self.expand_d_model // tp.size], dim=-1)
        curr_q = gather_from_model(
            curr_q, tp, ranges_of((q_width,), tp.rank, tp.size), q_width)
        curr_k = curr_q
        curr_v = F.silu(curr_v)
        curr_u = self.linear_U(_tgt)

        if tgt_id is None:
            cat_curr_u = torch.cat([F.silu(curr_u), torch.ones_like(curr_u)],
                                   dim=-1)
            curr_id_v = None
        else:
            curr_id_v = self.id_norm1(tgt_id)
            curr_id_u = self.linear_ID_U(copy_to_model(curr_id_v, tp))
            cat_curr_u = F.silu(torch.cat([curr_u, curr_id_u], dim=-1))

        mems = {'curr_k': curr_k, 'curr_v': curr_v, 'curr_id_v': curr_id_v}
        if curr_id_emb is not None:
            global_id_v = self.fuse_value_id(curr_id_v, curr_id_emb)
            mem_k, mem_v, mem_id_v = (curr_k[:, None], curr_v[:, None],
                                      global_id_v[:, None])
            valid = torch.ones((b, 1), dtype=torch.bool, device=tgt.device)
            local_k, local_v, local_id_v = curr_k, curr_v, global_id_v
            mems['global_id_v_fused'] = global_id_v
        else:
            mem_k, mem_v, mem_id_v, valid = long_mem
            local_k, local_v, local_id_v = short_kv

        capacity, hw = mem_k.shape[1], mem_k.shape[2]
        if temporal_pe is not None:
            cur_pe, mem_pe = (copy_to_model(x, tp) for x in temporal_pe)
            mem_pe = mem_pe[..., :capacity, :]
            if mem_pe.dim() == 2:
                mem_pe = mem_pe[None]
            q_time = curr_q + cur_pe
        else:
            mem_pe, q_time = None, curr_q

        if capacity > 1 and not self.training:
            cat_tgt2, mass = self.long_term_attn.bank_read(
                q_time, mem_k, mem_v, mem_id_v, cat_curr_u, valid, size_2d,
                mem_pe=mem_pe)
        else:
            # dense: the PE added to the keys, the slots flattened, free
            # slots masked (the reference frame reads only itself)
            if mem_pe is not None:
                mem_k = mem_k + mem_pe[:, :, None, :]
            flat = lambda x: x.reshape(b, capacity * hw, -1)
            bias = None if capacity == 1 else bank_key_bias(valid, hw)
            mass_cap = capacity if need_mass and capacity > 1 else None
            if self.att_heads == 1:
                # V and ID_V share one probability matrix
                cat_tgt2, mass = self.long_term_attn.multi_value_call(
                    q_time, flat(mem_k), (flat(mem_v), flat(mem_id_v)),
                    cat_curr_u, size_2d, key_bias=bias,
                    mass_capacity=mass_cap)
            else:
                cat_tgt2, mass = self.long_term_attn(
                    q_time, flat(mem_k),
                    torch.cat([flat(mem_v), flat(mem_id_v)], dim=-1),
                    cat_curr_u, size_2d, key_bias=bias,
                    mass_capacity=mass_cap)
        if not need_mass:
            mass = None

        cat_local_v = torch.cat([local_v, local_id_v], dim=-1)
        cat_tgt3 = self.short_term_attn(curr_q, local_k, cat_local_v,
                                        cat_curr_u, size_2d)

        lst, lst_id = self._rows(
            cat_tgt2 + cat_tgt3, self.long_term_attn.projection,
            self.short_term_attn.projection).chunk(2, dim=-1)
        # the long+short residual (reference :1215-1220): drop-path with
        # droppath_lst, else dropout at max(lt, st)
        if self.droppath_lst:
            lst, lst_id = self.drop_path(lst), self.drop_path(lst_id)
        else:
            lst = dropout(lst, self.lst_dropout, self.training)
            lst_id = dropout(lst_id, self.lst_dropout, self.training)
        tgt = tgt + lst
        tgt_id = lst_id if tgt_id is None else tgt_id + lst_id

        cat_q = copy_to_model(torch.cat([self.norm2(tgt),
                                         self.id_norm2(tgt_id)], dim=-1), tp)
        cat_tgt2, _ = self.self_attn(cat_q, cat_q, cat_q, cat_q, size_2d)
        tgt2, tgt_id2 = self._rows(cat_tgt2,
                                   self.self_attn.projection).chunk(2, dim=-1)
        return (tgt + self.drop_path(tgt2), tgt_id + self.drop_path(tgt_id2),
                mems, mass)

    def fuse_value_id(self, value, id_emb):
        """ID-value fusion (reference transformer.py:1238-1244); this
        rank's ID_V channels under tensor parallelism."""
        x = id_emb if value is None else torch.cat([value, id_emb], dim=-1)
        return F.silu(self.linear_ID_V(copy_to_model(x, self.tp)))


class GPMStack(nn.Module):
    """DualBranchGPM (reference transformer.py:700-824). DeAOT decodes only
    the last layer, so the only decoder norm is the final GroupNorm(2) over
    the concatenated [tgt, tgt_id] channels. In training the input tokens
    are dropped at emb_dropout; the drop-path rate grows linearly over the
    layers from 0 with droppath_scaling."""

    def __init__(self, num_layers: int = 3, d_model: int = 256,
                 self_heads: int = 1, att_heads: int = 1,
                 emb_dropout: float = 0.0, droppath: float = 0.1,
                 lt_dropout: float = 0.0, st_dropout: float = 0.0,
                 droppath_lst: bool = False, droppath_scaling: bool = False):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.layers = nn.ModuleList([
            GPMBlock(d_model, self_heads, att_heads, layer_idx=idx,
                     droppath=(droppath * idx / max(num_layers - 1, 1)
                               if droppath_scaling else droppath),
                     lt_dropout=lt_dropout, st_dropout=st_dropout,
                     droppath_lst=droppath_lst)
            for idx in range(num_layers)])
        self.decoder_norms = nn.ModuleList([GroupNorm1D(2 * d_model, 2)])

    def forward(self, tgt, long_mem, short_mem, curr_id_emb, size_2d,
                temporal_pe, need_mass: bool = False
                ) -> Tuple[List[torch.Tensor], List[dict],
                           Optional[torch.Tensor]]:
        """long_mem: (k, v, id_v per-layer lists, valid) or None;
        short_mem: (k, v, id_v per-layer lists) or None. Returns
        (per-layer [B, HW, 2C] outputs with the last one normed, per-layer
        memories, layer-0 eviction mass or None)."""
        intermediates, memories = [], []
        mass0 = None
        out, out_id = dropout(tgt, self.emb_dropout, self.training), None
        for idx, block in enumerate(self.layers):
            lm = None if long_mem is None else (
                long_mem[0][idx], long_mem[1][idx], long_mem[2][idx],
                long_mem[3])
            sm = None if short_mem is None else (
                short_mem[0][idx], short_mem[1][idx], short_mem[2][idx])
            out, out_id, mems, mass = block(
                out, out_id, lm, sm, curr_id_emb, size_2d, temporal_pe,
                need_mass=need_mass and idx == 0)
            if idx == 0:
                mass0 = mass
            intermediates.append(torch.cat([out, out_id], dim=-1))
            memories.append(mems)
        intermediates[-1] = self.decoder_norms[-1](intermediates[-1])
        return intermediates, memories, mass0
