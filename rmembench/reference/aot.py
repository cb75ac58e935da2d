"""The AOT family's reference: one R50-AOT-L + RMem inference step in plain
float32 PyTorch, and what the harness counts on it.

Written from AOT's paper (Yang, Wei & Yang, NeurIPS 2021: the
Long-Short-Term Transformer) and the RMem fork's
`SimplifiedTransformerBlock` / `LongShortTermTransformer`
(`networks/layers/transformer.py`, Zhou et al. 2024), on the shared parts
of `model.py`. Each of the `lstt_num` layers, width d with `att_heads`
heads of d / heads and a feed-forward of `dim_feedforward`:

- self-attention: q = k = LN1(tgt) + the 2-D sine position embedding, v =
  LN1(tgt), through `self_attn`'s Q, K, V and output projections;
- curr_q = curr_k = linear_Q(LN2(tgt)), curr_v = LN2(tgt);
- the long-term read of curr_q + the current frame's temporal PE over the
  bank's keys + the bank's resampled temporal PE and its values, every
  live frame's tokens, at scale (d / heads)^-0.5; layer 0 also returns
  each query's mass on each frame, the mean over heads of the probability
  on the frame's tokens (RMem's usage);
- the short-term read of curr_q over the previous frame's entries: with
  `linear_q`, keys [local_k; curr_k] and values [local_v; curr_v] (2 hw
  keys); without it (the VOST stages), keys norm4(local_k + curr_k) and
  values norm4(local_v + curr_v) (hw keys);
- tgt + the two reads' output projections, then the feed-forward: LN3,
  linear1, GroupNorm(32), GELU, a 5x5 depthwise conv, linear2.

Layer i's output, normed by `decoder_norms.i`, feeds the FPN beside the
projected 16x map (`decoder_intermediate_lstt`, on in every AOT model). The id tokens are the id bank's convolution with no
norm. A frame writes K = curr_k and V = linear_V(curr_v + id) to the bank,
and K = linear_QMem(st) and V = linear_VMem(st + id) to the short-term
memory, st being its short-term read's output; the reference frame reads
only itself, its id tokens already in its values. RMem's LSTT scores its
bank only at the writes that put it over budget.

Departures, none of which changes the mathematics: attention runs a block
of queries at a time; the memories are kept per frame in logical order,
not as the fork's [T*HW, B, C] sequence; training's dropout and drop-path
are absent (inference); `gru_memory` is not covered (the configurations
run without it: a model block that sets it is refused).

The family's interface, which the harness reaches it through:

- `Reference(weights, model, operands='float32')`: `propagate`, `write`
  and `scores_every_write`;
- `step_flops(shapes, model, size, bank_frames)`: the operations of one
  frame of one stream;
- `kernel_work(model, streams, grid)`: the bytes, operations and calls a
  step of kernel B1 (the family launches no B2).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from rmembench import flops
from rmembench.reference.model import BANK_CHUNK, ModelParts, grid_of
from rmembench.roofline import b1_work

B1 = 'B1 memory_read'
FFN_GROUPS = 32


def sine_position(h: int, w: int, n_feats: int) -> torch.Tensor:
    """[h*w, 2*n_feats]: the 2-D sine position embedding of an h x w grid
    (y features, then x), coordinates 0 .. side-1 scaled to [0, 2 pi],
    temperature 10000, each pair of features a sine and a cosine of one
    frequency."""
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(h, dtype=torch.float32)
    x = torch.arange(w, dtype=torch.float32)
    y = y / (y[-1] + eps) * scale
    x = x / (x[-1] + eps) * scale
    i = torch.arange(n_feats, dtype=torch.float32)
    freq = 10000.0 ** (2 * torch.div(i, 2, rounding_mode='floor')
                       / n_feats)

    def encode(c):                                   # [n] -> [n, n_feats]
        a = c[:, None] / freq
        return torch.stack([a[:, 0::2].sin(), a[:, 1::2].cos()],
                           dim=-1).reshape(len(c), n_feats)
    ey, ex = encode(y), encode(x)
    return torch.cat([ey[:, None].expand(h, w, n_feats),
                      ex[None].expand(h, w, n_feats)], -1).reshape(h * w, -1)


class Reference(ModelParts):
    """R50-AOT-L's inference step on float32 weights `weights` (state_dict
    keys of the measured package). `model` is the configuration file's
    `model` block; besides the shared keys it reads `self_heads`,
    `att_heads` and `linear_q`."""

    scores_every_write = False

    def __init__(self, weights: Dict[str, torch.Tensor], model: dict,
                 operands: str = 'float32'):
        super().__init__(weights, model, operands)
        if model.get('gru_memory'):
            raise ValueError('the AOT reference does not cover gru_memory')
        self.heads = model['att_heads']
        self.self_heads = model['self_heads']
        self.linear_q = model['linear_q']

    def id_tokens(self, label):
        """label int [B, H, W] -> id tokens [B, hw, d] (no norm)."""
        return self.id_conv(label)

    # ----------------------------------------------------------- attentions
    def attend(self, q, k, v, heads, frames=None):
        """Softmax attention of q [B, Lq, C] over k [B, Lk, C] and v [B, Lk,
        C'] in `heads` heads, at scale (C / heads)^-0.5, a block of queries
        at a time. Returns out [B, Lq, C'] and, with `frames`, the mass [B,
        Lq, frames]: the mean over heads of each query's probability on
        each of `frames` equal runs of keys (one frame's tokens each)."""
        b, lq, c = q.shape
        lk = k.shape[1]
        kh = k.reshape(b, lk, heads, -1).transpose(1, 2)     # [B, H, Lk, D]
        vh = v.reshape(b, lk, heads, -1).transpose(1, 2)
        scale = (c // heads) ** -0.5
        outs, masses = [], []
        for s in range(0, lq, BANK_CHUNK):
            qh = q[:, s:s + BANK_CHUNK].reshape(b, -1, heads, c // heads)
            p = torch.softmax(self.mm(qh.transpose(1, 2) * scale,
                                      kh.transpose(-1, -2)), dim=-1)
            n = p.shape[2]
            outs.append(self.mm(p, vh).transpose(1, 2).reshape(b, n, -1))
            if frames is not None:
                masses.append(p.reshape(b, heads, n, frames, lk // frames)
                              .sum(-1).mean(1))
        out = torch.cat(outs, 1)
        return out, (torch.cat(masses, 1) if frames is not None else None)

    def self_attention(self, x, pos, p):
        qk = x + pos
        out, _ = self.attend(self.linear(qk, p + '.linear_Q'),
                             self.linear(qk, p + '.linear_K'),
                             self.linear(x, p + '.linear_V'),
                             self.self_heads)
        return self.linear(out, p + '.projection')

    def feed_forward(self, x, p, size_2d):
        b, hw, _ = x.shape
        x = self.linear(x, p + '.linear1')
        c = x.shape[-1]
        x = x.transpose(1, 2).reshape(b, c, *size_2d)
        x = F.gelu(self.gn(x, p + '.activation.gn', FFN_GROUPS))
        x = self.conv(x, p + '.activation.conv', 1, 2, groups=c)
        return self.linear(x.flatten(2).transpose(1, 2), p + '.linear2')

    # ----------------------------------------------------------------- LSTT
    def lstt_layer(self, i, tgt, bank, short, id_emb, pos, size_2d, pe):
        """One LSTT layer. bank: (k [B,L,hw,d] with the temporal PE not yet
        added, v [B,L,hw,d]) or None on the reference frame, which reads
        itself; short: (k, v [B,hw,d]) of the previous frame or None; pe:
        (cur [d], mem [L, d]) or None. Returns (tgt, pending, mass [B, hw,
        L]); on the reference frame `pending` is its entries."""
        p = f'LSTT.layers.{i}'
        tgt = tgt + self.self_attention(self.ln(tgt, p + '.norm1'), pos,
                                        p + '.self_attn')
        x = self.ln(tgt, p + '.norm2')
        curr_q = curr_k = self.linear(x, p + '.linear_Q')
        curr_v = x
        if bank is None:
            fused_v = self.linear(curr_v + id_emb, p + '.linear_V')
            bank = (curr_k[:, None], fused_v[:, None])
            short = (curr_k, fused_v)
        mem_k, mem_v = bank
        b, n_frames, hw, _ = mem_k.shape
        q_time = curr_q
        if pe is not None:
            q_time = curr_q + pe[0]
            mem_k = mem_k + pe[1][None, :, None, :]
        long_out, mass = self.attend(
            q_time, mem_k.reshape(b, n_frames * hw, -1),
            mem_v.reshape(b, n_frames * hw, -1), self.heads, n_frames)
        long_out = self.linear(long_out, p + '.long_term_attn.projection')
        if self.linear_q:
            keys = torch.cat([short[0], curr_k], 1)
            values = torch.cat([short[1], curr_v], 1)
        else:
            keys = self.ln(short[0] + curr_k, p + '.norm4')
            values = self.ln(short[1] + curr_v, p + '.norm4')
        st = self.linear(self.attend(curr_q, keys, values, self.heads)[0],
                         p + '.short_term_attn.projection')
        local_k = self.linear(st, p + '.linear_QMem')
        if id_emb is not None:
            local_v = self.linear(st + id_emb, p + '.linear_VMem')
            pending = ((curr_k, fused_v), (local_k, local_v))
        else:
            pending = {'k': curr_k, 'v': curr_v, 'local_k': local_k,
                       'st': st}
        tgt = tgt + long_out + st
        tgt = tgt + self.feed_forward(self.ln(tgt, p + '.norm3'), p,
                                      size_2d)
        return tgt, pending, mass

    def propagate(self, img, bank, short, id_label=None):
        """One frame. bank: per layer (k, v) of the live frames in logical
        order, or None with `id_label` (the reference frame's label map) to
        read the frame itself. Returns (logits [B, O+1, H4, W4] before the
        unused ids are masked, pending, layer 0's mass [B, hw, L], the 16x
        grid): `pending` is what `write` takes, or on the reference frame
        already what it returns, the frame's entries."""
        xs = self.encode(img)
        b, _, h, w = xs[-1].shape
        size_2d = (h, w)
        tgt = xs[-1].flatten(2).transpose(1, 2)
        id_emb = None if id_label is None else self.id_tokens(id_label)
        length = 1 if bank is None else bank[0][0].shape[1]
        pe = self.temporal_pe(length)
        pos = self._cached(('pos', h, w), lambda: sine_position(
            h, w, self.d // 2), img.device)
        pending, outs, mass0 = [], [], None
        for i in range(self.m['lstt_num']):
            tgt, pend, mass = self.lstt_layer(
                i, tgt, None if bank is None else bank[i],
                None if short is None else short[i], id_emb, pos, size_2d,
                pe)
            pending.append(pend)
            outs.append(tgt)
            mass0 = mass if i == 0 else mass0
        feats = [xs[-1].flatten(2).transpose(1, 2)] + [
            self.ln(o, f'LSTT.decoder_norms.{i}') for i, o in enumerate(outs)]
        x = torch.cat(feats, -1).transpose(1, 2).reshape(b, -1, h, w)
        return self.decode(x, xs), pending, mass0, size_2d

    def write(self, pending, label):
        """The entries a frame writes with its label [B, H, W]: per layer
        ((K, V) of the bank, (K, V) of the short-term memory)."""
        id_emb = self.id_tokens(label)
        out = []
        for i, p in enumerate(pending):
            lp = f'LSTT.layers.{i}'
            out.append(((p['k'], self.linear(p['v'] + id_emb,
                                             lp + '.linear_V')),
                        (p['local_k'], self.linear(p['st'] + id_emb,
                                                   lp + '.linear_VMem'))))
        return out


def step_flops(shapes: Dict[str, Tuple[int, ...]], model: dict,
               size: Tuple[int, int], bank_frames: int) -> int:
    """FLOPs of one frame of one stream against `bank_frames` frames: the
    propagation and the write, counted on the reference (`flops.count`),
    every read dense as it is (the short-term read over hw keys, or 2 hw
    with `linear_q`)."""
    meta = torch.device('meta')
    ref = Reference(flops.meta_weights(shapes), model)
    h, w = size
    grid = grid_of(size, model['align_corners'])
    hw = grid[0] * grid[1]
    d = model['encoder_embedding_dim']

    def mem(*shape):
        return torch.empty(shape, device=meta)
    bank = [(mem(1, bank_frames, hw, d), mem(1, bank_frames, hw, d))
            for _ in range(model['lstt_num'])]
    short = [(mem(1, hw, d), mem(1, hw, d))
             for _ in range(model['lstt_num'])]
    img = torch.empty((1, h, w, 3), device=meta)
    label = torch.zeros((1, h, w), dtype=torch.long, device=meta)

    def step():
        _, pending, _, _ = ref.propagate(img, bank, short)
        ref.write(pending, label)
    return flops.count(step)


def kernel_work(model: dict, streams: int, grid: Tuple[int, int]
                ) -> Dict[str, Tuple[float, float, int]]:
    """{census group: (bytes, operations, calls a step)} of the kernels a
    step launches, operands of bf16 (the configurations' served dtype):
    B1, one read of the full bank a layer in `att_heads` heads of d /
    heads with values as wide, all streams in one call. The short-term
    read is dense attention, no kernel of its own."""
    heads = model['att_heads']
    dh = model['encoder_embedding_dim'] // heads
    n_live = model['former_mem_len'] + model['latter_mem_len']
    return {B1: (*b1_work(streams, grid[0] * grid[1], n_live, n_live + 1,
                          dh, (dh,), heads=heads),
                 model['lstt_num'])}
