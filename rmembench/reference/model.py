"""Plain PyTorch reference of one DeAOT-L inference step (R50 or Swin-B).

A frozen, self-contained copy of the mathematics of DeAOT-L with RMem
(Yang & Yang 2022, DeAOT; Zhou et al. 2024, RMem), written for clarity,
not speed: float32 throughout, every convolution and product a plain
torch call, the long-term read and the self-attention dense softmax
attention, the short-term read a softmax over each query's 15x15 window
(a block of query rows at a time against the key rows their windows
reach, every key outside a query's window masked). It imports nothing of
the program it judges. It reads the weights as a flat dict under the
state_dict keys the measured package uses, so that one set of seeded
weights loads into both.

`operands='float8'` rounds both operands of every product (linear,
convolution, attention) to float8 e4m3 with one scale per tensor (its
largest magnitude maps to 448), and accumulates in float32: the benchmark's
control, one precision below the bfloat16 the configurations state.

Run it with TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`); `check.py` does.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
FP8_MAX = 448.0
UNUSED_ID_LOGIT = -1e10
LOCAL_MAX_DIS = 7          # the short-term window is 15 x 15
LOCAL_ROWS = 8             # query rows per block of the short-term read
BANK_CHUNK = 1024          # queries per block of the long-term read


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor, back
    in float32."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def swin_relative_index(ws: int) -> torch.Tensor:
    """[N*N] index into the (2ws-1)^2 relative-bias table for the N = ws^2
    tokens of a window (Swin, Liu et al. 2021, eq. 4)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return torch.from_numpy((rel[..., 0] * (2 * ws - 1)
                             + rel[..., 1]).reshape(-1).astype(np.int64))


def swin_shift_mask(hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    """[nW, N, N] additive mask of the shifted windows: -100 between tokens
    that come from different regions of the rolled grid."""
    img = np.zeros((hp, wp))
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0)
                            .astype(np.float32))


def memory_pe(mem_pos_emb: torch.Tensor, length: int) -> torch.Tensor:
    """RMem's temporal PE of a bank of `length` frames in logical order
    ([length, C]) from the S learned slots: slot 0 alone for one frame,
    the first `length` slots while they last, a linear resampling of the
    slots to 4 beyond, and beyond 4 frames that resampling flipped,
    stretched by nearest neighbours to `length` and flipped back (the
    newest frames keep the last slots)."""
    s = mem_pos_emb.shape[0]
    if length == 1:
        return mem_pos_emb[:1]
    if length <= s:
        return mem_pos_emb[:length]
    as_signal = mem_pos_emb.t()[None]                        # [1, C, S]
    base = F.interpolate(as_signal, size=min(length, 4), mode='linear',
                         align_corners=True)
    if length <= 4:
        return base[0].t()
    out = F.interpolate(base.flip(-1), size=length, mode='nearest')
    return out.flip(-1)[0].t()


def local_window_plan(rows: int, h: int, w: int, r0: int) -> torch.Tensor:
    """For the queries of image rows [r0, r0 + rows) and the keys of rows
    [r0 - 7, r0 + rows + 7) of the grid padded by 7 on every side: [2,
    rows*w, 225], the index of each query's window key in that block of
    keys, and whether the key lies in the image."""
    md = LOCAL_MAX_DIS
    ws = 2 * md + 1
    qy, qx = torch.meshgrid(torch.arange(rows), torch.arange(w),
                            indexing='ij')
    dy, dx = torch.meshgrid(torch.arange(ws), torch.arange(ws),
                            indexing='ij')
    ky = qy.reshape(-1, 1) + dy.reshape(1, -1)        # rows of the block
    kx = qx.reshape(-1, 1) + dx.reshape(1, -1)        # padded columns
    index = ky * (w + 2 * md) + kx
    gy = ky + r0                                      # padded grid rows
    inside = (gy >= md) & (gy < h + md) & (kx >= md) & (kx < w + md)
    return torch.stack([index, inside.long()])


class DeAOTReference:
    """DeAOT-L's inference step on float32 weights `weights` (state_dict
    keys of the measured package). `model` is the configuration file's
    `model` block (encoder, widths, id and bank sizes, align_corners)."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: dict,
                 operands: str = 'float32'):
        if operands not in ('float32', 'float8'):
            raise ValueError(f'operands {operands!r}')
        self.w = weights
        self.m = model
        self.q = fp8_round if operands == 'float8' else _identity
        self.d = model['encoder_embedding_dim']
        self.d_att = self.d // 2
        self._local = {}

    def _cached(self, key, make, device):
        """A constant table on the device, copied there once (a copy on
        every call would wait for the device)."""
        key = key + (str(device),)
        if key not in self._local:
            self._local[key] = make().to(device)
        return self._local[key]

    # ------------------------------------------------------------ primitives
    def linear(self, x, key, bias=True):
        b = self.w[key + '.bias'] if bias else None
        return F.linear(self.q(x), self.q(self.w[key + '.weight']), b)

    def conv(self, x, key, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(self.w[key + '.weight']),
                        self.w.get(key + '.bias'), stride, padding, 1, groups)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def ln(self, x, key):
        return F.layer_norm(x, (x.shape[-1],), self.w[key + '.weight'],
                            self.w[key + '.bias'], EPS)

    def gn(self, x, key, groups):
        return F.group_norm(x, groups, self.w[key + '.weight'],
                            self.w[key + '.bias'], EPS)

    def frozen_bn(self, x, key):
        scale = self.w[key + '.weight'] * torch.rsqrt(
            self.w[key + '.running_var'] + EPS)
        shift = self.w[key + '.bias'] - self.w[key + '.running_mean'] * scale
        return x * scale[:, None, None] + shift[:, None, None]

    # ------------------------------------------------------------- encoders
    def resnet50(self, x):
        """Stages 1-3 of ResNet-50 (strides 4, 8, 16), frozen BN."""
        p = 'encoder.'
        x = F.relu(self.frozen_bn(self.conv(x, p + 'conv1', 2, 3),
                                  p + 'bn1'))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, (blocks, stride) in enumerate(((3, 1), (4, 2), (6, 2))):
            for i in range(blocks):
                x = self._bottleneck(x, f'{p}layer{stage + 1}.{i}',
                                     stride if i == 0 else 1)
            outs.append(x)
        return outs + [outs[-1]]

    def _bottleneck(self, x, p, stride):
        out = F.relu(self.frozen_bn(self.conv(x, p + '.conv1'), p + '.bn1'))
        out = F.relu(self.frozen_bn(self.conv(out, p + '.conv2', stride, 1),
                                    p + '.bn2'))
        out = self.frozen_bn(self.conv(out, p + '.conv3'), p + '.bn3')
        if p + '.downsample.0.weight' in self.w:
            x = self.frozen_bn(self.conv(x, p + '.downsample.0', stride),
                               p + '.downsample.1')
        return F.relu(out + x)

    def swin_base(self, x, depths=(2, 2, 18), heads=(4, 8, 16), ws=7):
        """Stages 0-2 of Swin-B (embed 128), each stage's output
        layer-normed, as NCHW maps at strides 4, 8, 16."""
        p = 'encoder.'
        x = F.pad(x, (0, (-x.shape[3]) % 4, 0, (-x.shape[2]) % 4))
        x = self.conv(x, p + 'patch_embed.proj', 4)
        b, c, h, w = x.shape
        x = self.ln(x.flatten(2).transpose(1, 2), p + 'patch_embed.norm')
        outs = []
        for i, (depth, n_heads) in enumerate(zip(depths, heads)):
            for j in range(depth):
                x = self._swin_block(x, h, w, f'{p}layers.{i}.blocks.{j}',
                                     n_heads, ws, 0 if j % 2 == 0 else ws // 2)
            out = self.ln(x, f'{p}norm{i}')
            outs.append(out.transpose(1, 2).reshape(b, -1, h, w))
            if i < len(depths) - 1:
                x = self._patch_merge(x, h, w, f'{p}layers.{i}.downsample')
                h, w = (h + 1) // 2, (w + 1) // 2
        return outs + [outs[-1]]

    def _swin_block(self, x, h, w, p, n_heads, ws, shift):
        b, _, c = x.shape
        y = self.ln(x, p + '.norm1').reshape(b, h, w, c)
        pad_b, pad_r = (-h) % ws, (-w) % ws
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))    # padded after the norm
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self._cached(('shift', hp, wp, ws, shift), lambda:
                                swin_shift_mask(hp, wp, ws, shift), y.device)
        win = y.reshape(b, hp // ws, ws, wp // ws, ws, c).transpose(2, 3)
        win = self._window_attention(win.reshape(-1, ws * ws, c), p + '.attn',
                                     n_heads, ws, mask)
        y = win.reshape(b, hp // ws, wp // ws, ws, ws, c).transpose(2, 3)
        y = y.reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w].reshape(b, h * w, c)
        z = self.linear(self.ln(x, p + '.norm2'), p + '.mlp.fc1')
        return x + self.linear(F.gelu(z), p + '.mlp.fc2')

    def _window_attention(self, x, p, n_heads, ws, mask):
        bw, n, c = x.shape
        hd = c // n_heads
        q, k, v = (t.reshape(bw, n, n_heads, hd).transpose(1, 2)
                   for t in self.linear(x, p + '.qkv').chunk(3, dim=-1))
        table = self.w[p + '.relative_position_bias_table']
        index = self._cached(('rel', ws), lambda: swin_relative_index(ws),
                             x.device)
        bias = table[index].reshape(
            n, n, n_heads).permute(2, 0, 1)                  # [H, N, N]
        logits = self.mm(q * hd ** -0.5, k.transpose(-1, -2)) + bias
        if mask is not None:
            n_w = mask.shape[0]
            logits = (logits.reshape(bw // n_w, n_w, n_heads, n, n)
                      + mask[None, :, None]).reshape(bw, n_heads, n, n)
        out = self.mm(torch.softmax(logits, dim=-1), v)
        return self.linear(out.transpose(1, 2).reshape(bw, n, c), p + '.proj')

    def _patch_merge(self, x, h, w, p):
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(b, -1, 4 * c)
        return self.linear(self.ln(x, p + '.norm'), p + '.reduction',
                           bias=False)

    def encode(self, img):
        """img [B, H, W, 3] -> [4x, 8x, 16x maps, the projected 16x map]
        (NCHW)."""
        x = img.permute(0, 3, 1, 2)
        enc = self.m['encoder']
        if enc == 'resnet50':
            xs = self.resnet50(x)
        elif enc == 'swin_base':
            xs = self.swin_base(x)
        else:
            raise ValueError(f'encoder {enc!r} has no reference')
        return xs[:3] + [self.conv(xs[3], 'encoder_projector')]

    # ------------------------------------------------------------ identities
    def id_tokens(self, label):
        """label int [B, H, W] -> id tokens [B, hw, d]: the one-hot of the
        ids (ids 0..max_obj_num, 255 on the ignore channel), a strided conv
        down to the 16x grid, a layer norm."""
        n_ids = self.m['max_obj_num'] + 1
        n_ch = self.m['id_dim']
        raw = label.long()
        lab = torch.where(raw >= n_ids, n_ch, raw)
        lab = torch.where(raw == 255, n_ch - 1, lab)
        one_hot = (lab[..., None] == torch.arange(
            n_ch, device=lab.device)).float()
        pad = 8 if self.m['align_corners'] else 0
        x = self.conv(one_hot.permute(0, 3, 1, 2), 'patch_wise_id_bank', 16,
                      pad)
        return self.ln(x.flatten(2).transpose(1, 2), 'id_norm')

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

    def temporal_pe(self, length: int):
        if 'cur_pos_emb' not in self.w:
            return None
        return (self.w['cur_pos_emb'][0],
                memory_pe(self.w['mem_pos_emb'], length))

    def propagate(self, img, bank, short, id_label=None):
        """One frame. bank: per layer (k, v, id_v) of the live frames in
        logical order, or None with `id_label` (the reference frame's
        label map) to read the frame itself. Returns (logits [B, O+1, H4,
        W4] before the unused ids are masked, per-layer memories, layer
        0's mass [B, hw, L])."""
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
        return (self.decode(out.reshape(b, -1, h, w), xs), mems, mass0,
                size_2d)

    # -------------------------------------------------------------- decoder
    def decode(self, x, xs):
        """The FPN head: the last GPM output with the encoder's 16x, 8x and
        4x maps, to id logits at 4x."""
        ac = self.m['align_corners']
        p = 'decoder.'

        def conv_gn(x, key, k):
            return F.relu(self.gn(self.conv(x, key + '.conv', 1, k // 2),
                                  key + '.gn', 8))

        def up(x, like):
            return F.interpolate(x, size=like.shape[-2:], mode='bilinear',
                                 align_corners=ac)
        x = conv_gn(x, p + 'conv_in', 1)
        x = conv_gn(self.conv(xs[2], p + 'adapter_16x') + x, p + 'conv_16x',
                    3)
        x = up(x, xs[1])
        x = conv_gn(self.conv(xs[1], p + 'adapter_8x') + x, p + 'conv_8x', 3)
        x = up(x, xs[0])
        x = conv_gn(self.conv(xs[0], p + 'adapter_4x') + x, p + 'conv_4x', 3)
        return self.conv(x, p + 'conv_out')


def mask_unused(logits: torch.Tensor, obj_num: int) -> torch.Tensor:
    """Logits [B, C, ...] of ids above obj_num set to -1e10."""
    keep = torch.arange(logits.shape[1], device=logits.device) <= obj_num
    return torch.where(keep.view(1, -1, *([1] * (logits.dim() - 2))),
                       logits, UNUSED_ID_LOGIT)


def upsample(logits: torch.Tensor, size: Sequence[int],
             align_corners: bool) -> torch.Tensor:
    return F.interpolate(logits, size=tuple(size), mode='bilinear',
                         align_corners=align_corners)

