"""The DeAOT family's reference: one DeAOT-L inference step (R50 or
Swin-B) in plain float32 PyTorch, and what the harness counts on it.

A frozen, self-contained copy of the mathematics of DeAOT-L with RMem
(Yang & Yang 2022, DeAOT; Zhou et al. 2024, RMem) on the shared parts of
`model.py`: the gated propagation module's long-term read and
self-attention as dense softmax attention, the short-term read a softmax
over each query's 15x15 window (a block of query rows at a time against
the key rows their windows reach, every key outside a query's window
masked). A frame writes the same (K, V, fused ID_V) triple to the bank and
to the short-term memory.

The family's interface, which the harness reaches it through:

- `Reference(weights, model, operands='float32')`: `propagate`, `write`
  and `scores_every_write` (RMem's GPM scores its bank at every write);
- `step_flops(shapes, model, size, bank_frames)`: the operations of one
  frame of one stream;
- `kernel_work(model, streams, grid)`: the bytes, operations and calls a
  step of kernels B1 and B2.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from rmembench import flops
from rmembench.reference.model import (BANK_CHUNK, LOCAL_MAX_DIS, LOCAL_ROWS,
                                       ModelParts, grid_of,
                                       local_window_plan)
from rmembench.roofline import b1_work, b2_work

B1 = 'B1 memory_read'
B2 = 'B2 local_attn'


class Reference(ModelParts):
    """DeAOT-L's inference step on float32 weights `weights` (state_dict
    keys of the measured package). `model` is the configuration file's
    `model` block (encoder, widths, id and bank sizes, align_corners)."""

    scores_every_write = True

    def __init__(self, weights: Dict[str, torch.Tensor], model: dict,
                 operands: str = 'float32'):
        super().__init__(weights, model, operands)
        self.d_att = self.d // 2

    def id_tokens(self, label):
        """label int [B, H, W] -> id tokens [B, hw, d]: the id bank's
        tokens, layer-normed."""
        return self.ln(self.id_conv(label), 'id_norm')

    # ----------------------------------------------------------- attentions
    def _gate_project(self, out, u, p, size_2d):
        """The gated attentions' tail: out * u, a 5x5 depthwise conv, the
        output projection."""
        b, hw, c = out.shape
        x = (out * u).transpose(1, 2).reshape(b, c, *size_2d)
        x = self.conv(x, p + '.dw_conv.conv', 1, 2, groups=c)
        return self.linear(x.flatten(2).transpose(1, 2), p + '.projection')

    def bank_read(self, q, keys, values, scale):
        """Softmax attention of q [B, hw, D] over every token of the bank's
        frames, keys [B, L, hw, D] and values [B, L, hw, E]. Returns
        (out [B, hw, E], mass [B, hw, L]: each query's probability on each
        frame)."""
        b, n_frames, hw_k, _ = keys.shape
        k = keys.reshape(b, n_frames * hw_k, -1)
        v = values.reshape(b, n_frames * hw_k, -1)
        outs, masses = [], []
        for s in range(0, q.shape[1], BANK_CHUNK):
            p = torch.softmax(self.mm(q[:, s:s + BANK_CHUNK] * scale,
                                      k.transpose(1, 2)), dim=-1)
            outs.append(self.mm(p, v))
            masses.append(p.reshape(b, p.shape[1], n_frames, hw_k).sum(-1))
        return torch.cat(outs, 1), torch.cat(masses, 1)

    def local_read(self, q, k, v, rel, size_2d, scale):
        """Softmax attention of each query over the keys of its 15x15
        window inside the image, with the relative bias rel [B, hw, 225]
        of each window offset: q, k [B, hw, D], v [B, hw, E]. Computed a
        block of LOCAL_ROWS query rows at a time against the rows of keys
        their windows reach, every other key of the block at -inf."""
        h, w = size_2d
        md = LOCAL_MAX_DIS
        b = q.shape[0]

        def padded(x):
            x2 = x.reshape(b, h, w, -1)
            return F.pad(x2, (0, 0, md, md, md, md))
        kp, vp = padded(k), padded(v)
        qs = (q * scale).reshape(b, h, w, -1)
        rel = rel.reshape(b, h, w, -1)
        outs = []
        for r0 in range(0, h, LOCAL_ROWS):
            rows = min(LOCAL_ROWS, h - r0)
            index, inside = self._cached(
                ('local', rows, h, w, r0),
                lambda: local_window_plan(rows, h, w, r0), q.device)
            inside = inside.bool()
            keys = kp[:, r0:r0 + rows + 2 * md].reshape(b, -1, kp.shape[-1])
            vals = vp[:, r0:r0 + rows + 2 * md].reshape(b, -1, vp.shape[-1])
            bias = torch.full((b, rows * w, keys.shape[1]), float('-inf'),
                              device=q.device)
            window = rel[:, r0:r0 + rows].reshape(b, rows * w, -1)
            bias.scatter_(2, index.expand(b, -1, -1),
                          window.masked_fill(~inside, float('-inf')))
            logits = self.mm(qs[:, r0:r0 + rows].reshape(b, rows * w, -1),
                             keys.transpose(1, 2)) + bias
            outs.append(self.mm(torch.softmax(logits, dim=-1), vals))
        return torch.cat(outs, 1)

    # ------------------------------------------------------------------ GPM
    def gpm_layer(self, i, tgt, tgt_id, bank, short, id_emb, size_2d, pe):
        """One gated propagation layer. bank: (k [B,L,hw,Da] with the
        temporal PE not yet added, v, id_v [B,L,hw,E]) or None on the
        reference frame, which reads itself; short: (k, v, id_v) of the
        previous frame or None; pe: (cur [Da], mem [L, Da]) or None.
        Returns (tgt, tgt_id, memories, mass [B, hw, L])."""
        p = f'LSTT.layers.{i}'
        da = self.d_att
        x = self.ln(tgt, p + '.norm1')
        curr_q, curr_v = self.linear(x, p + '.linear_QV').split(
            [da, 2 * self.d], dim=-1)
        curr_k, curr_v = curr_q, F.silu(curr_v)
        curr_u = self.linear(x, p + '.linear_U')
        if tgt_id is None:
            u = torch.cat([F.silu(curr_u), torch.ones_like(curr_u)], dim=-1)
            curr_id_v = None
        else:
            curr_id_v = self.ln(tgt_id, p + '.id_norm1')
            u = F.silu(torch.cat([curr_u, self.linear(
                curr_id_v, p + '.linear_ID_U')], dim=-1))
        mems = {'k': curr_k, 'v': curr_v, 'id_v': curr_id_v}
        if bank is None:
            fused = self.fuse_id(i, curr_id_v, id_emb)
            mems['fused_id_v'] = fused
            bank = (curr_k[:, None], curr_v[:, None], fused[:, None])
            short = (curr_k, curr_v, fused)
        mem_k, mem_v, mem_id_v = bank
        q_time = curr_q
        if pe is not None:
            q_time = curr_q + pe[0]
            mem_k = mem_k + pe[1][None, :, None, :]
        scale = da ** -0.5
        long_out, mass = self.bank_read(
            q_time, mem_k, torch.cat([mem_v, mem_id_v], dim=-1), scale)
        long_out = self._gate_project(long_out, u, p + '.long_term_attn',
                                      size_2d)
        lp = p + '.short_term_attn.relative_emb_k'
        rel = F.linear(self.q(curr_q), self.q(
            self.w[lp + '.weight'].flatten(1)), self.w[lp + '.bias'])
        short_out = self.local_read(curr_q, short[0],
                                    torch.cat([short[1], short[2]], dim=-1),
                                    rel, size_2d, scale)
        short_out = self._gate_project(short_out, u, p + '.short_term_attn',
                                       size_2d)
        lst, lst_id = (long_out + short_out).chunk(2, dim=-1)
        tgt = tgt + lst
        tgt_id = lst_id if tgt_id is None else tgt_id + lst_id
        cat = torch.cat([self.ln(tgt, p + '.norm2'),
                         self.ln(tgt_id, p + '.id_norm2')], dim=-1)
        tgt2, tgt_id2 = self.self_attention(cat, p + '.self_attn',
                                            size_2d).chunk(2, dim=-1)
        return tgt + tgt2, tgt_id + tgt_id2, mems, mass

    def self_attention(self, x, p, size_2d):
        """The GPM's gated self-attention (one head, query = key)."""
        qk = self.linear(x, p + '.linear_QK')
        x1, x2 = x.chunk(2, dim=-1)
        v = F.silu(torch.cat([self.linear(x1, p + '.linear_V1'),
                              self.linear(x2, p + '.linear_V2')], dim=-1))
        u = F.silu(torch.cat([self.linear(x1, p + '.linear_U1'),
                              self.linear(x2, p + '.linear_U2')], dim=-1))
        scale = self.d_att ** -0.5
        p_attn = torch.softmax(self.mm(qk * scale, qk.transpose(1, 2)), -1)
        return self._gate_project(self.mm(p_attn, v), u, p, size_2d)

    def fuse_id(self, i, value, id_emb):
        """The id value a layer writes to memory: SiLU(linear_ID_V([value,
        id])), of the id tokens alone in layer 0."""
        x = id_emb if value is None else torch.cat([value, id_emb], dim=-1)
        return F.silu(self.linear(x, f'LSTT.layers.{i}.linear_ID_V'))

    def propagate(self, img, bank, short, id_label=None):
        """One frame. bank: per layer (k, v, id_v) of the live frames in
        logical order, or None with `id_label` (the reference frame's
        label map) to read the frame itself. Returns (logits [B, O+1, H4,
        W4] before the unused ids are masked, pending, layer 0's mass [B,
        hw, L], the 16x grid): `pending` is what `write` takes, or on the
        reference frame already what it returns, the frame's entries."""
        xs = self.encode(img)
        b, _, h, w = xs[-1].shape
        size_2d = (h, w)
        tgt = xs[-1].flatten(2).transpose(1, 2)
        tgt_id = None
        id_emb = None if id_label is None else self.id_tokens(id_label)
        length = 1 if bank is None else bank[0][0].shape[1]
        pe = self.temporal_pe(length)
        mems, mass0 = [], None
        for i in range(self.m['lstt_num']):
            tgt, tgt_id, mem, mass = self.gpm_layer(
                i, tgt, tgt_id, None if bank is None else bank[i],
                None if short is None else short[i], id_emb, size_2d, pe)
            mems.append(mem)
            mass0 = mass if i == 0 else mass0
        out = self.gn(torch.cat([tgt, tgt_id], dim=-1).transpose(1, 2),
                      'LSTT.decoder_norms.0.gn', 2)
        if id_label is not None:
            mems = [self._entries(m, m['fused_id_v']) for m in mems]
        return (self.decode(out.reshape(b, -1, h, w), xs), mems, mass0,
                size_2d)

    @staticmethod
    def _entries(pending, fused):
        entry = (pending['k'], pending['v'], fused)
        return entry, entry

    def write(self, pending, label):
        """The entries a frame writes with its label [B, H, W]: per layer
        (bank entry, short-term entry), both (K, V, fused ID_V)."""
        id_emb = self.id_tokens(label)
        return [self._entries(p, self.fuse_id(i, p['id_v'], id_emb))
                for i, p in enumerate(pending)]


def step_flops(shapes: Dict[str, Tuple[int, ...]], model: dict,
               size: Tuple[int, int], bank_frames: int) -> int:
    """FLOPs of one frame of one stream against `bank_frames` frames: the
    propagation and the write, counted on the reference (`flops.count`).
    The reference reads the short-term memory a block of rows at a time,
    which multiplies more than the window needs; that read is counted
    instead by the operations of its 15x15 windows inside the image (the
    work of kernel B2), so that the count is the work the step needs,
    whatever implements it."""
    meta = torch.device('meta')
    ref = Reference(flops.meta_weights(shapes), model)
    # the short-term reads, counted apart
    ref.local_read = lambda q, k, v, rel, size_2d, scale: torch.zeros(
        (q.shape[0], q.shape[1], v.shape[-1]), device=meta)
    h, w = size
    grid = grid_of(size, model['align_corners'])
    hw = grid[0] * grid[1]
    d = model['encoder_embedding_dim']
    e = 2 * d

    def mem(n, c):
        return torch.empty((1, n, hw, c), device=meta)
    bank = [(mem(bank_frames, d // 2), mem(bank_frames, e),
             mem(bank_frames, e)) for _ in range(model['lstt_num'])]
    short = [tuple(x[:, 0] for x in layer) for layer in bank]
    img = torch.empty((1, h, w, 3), device=meta)
    label = torch.zeros((1, h, w), dtype=torch.long, device=meta)

    def step():
        _, pending, _, _ = ref.propagate(img, bank, short)
        ref.write(pending, label)
    local = b2_work(1, grid, d // 2, 4 * d)[1]
    return flops.count(step) + model['lstt_num'] * local


def kernel_work(model: dict, streams: int, grid: Tuple[int, int]
                ) -> Dict[str, Tuple[float, float, int]]:
    """{census group: (bytes, operations, calls a step)} of the kernels a
    step launches, operands of bf16 (the configurations' served dtype):
    B1, one read of the full bank (one head of d/2, values V and ID_V of
    2d each) a layer, all streams in one call, and B2, one 15x15-window
    read (values of 4d) a layer."""
    d = model['encoder_embedding_dim']
    n_live = model['former_mem_len'] + model['latter_mem_len']
    calls = model['lstt_num']
    return {
        B1: (*b1_work(streams, grid[0] * grid[1], n_live, n_live + 1,
                      d // 2, (2 * d, 2 * d)), calls),
        B2: (*b2_work(streams, grid, d // 2, 4 * d), calls),
    }
