"""The parts of the plain PyTorch references that every family shares.

A frozen, self-contained copy of the mathematics that the families of
`rmembench/reference/<family>.py` build on, written for clarity, not
speed: float32 throughout, every convolution and product a plain torch
call. It holds the encoders (ResNet-50 stages 1-3, Swin-B stages 0-2) and
their projection, the norms, the id bank's strided convolution, RMem's
temporal PE (Zhou et al. 2024), the FPN decoder, the float8 rounding of
the control, the window plan of a 15x15 short-term read, and
`mask_unused` / `upsample`. It imports nothing of the program it judges.
It reads the weights as a flat dict under the state_dict keys the
measured package uses, so that one set of seeded weights loads into both.

`operands='float8'` rounds both operands of every product (linear,
convolution, attention) to float8 e4m3 with one scale per tensor (its
largest magnitude maps to 448), and accumulates in float32: the benchmark's
control, one precision below the bfloat16 the configurations state.

Run it with TF32 off (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`); `check.py` does.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

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


def grid_of(size: Sequence[int], align_corners: bool) -> Tuple[int, int]:
    """The 16x grid of an input of `size` (h, w)."""
    h, w = size
    if align_corners:
        return (h - 1) // 16 + 1, (w - 1) // 16 + 1
    return h // 16, w // 16


class ModelParts:
    """The shared parts of a family's reference on float32 weights
    `weights` (state_dict keys of the measured package). `model` is the
    configuration file's `model` block (encoder, widths, id and bank
    sizes, align_corners)."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: dict,
                 operands: str = 'float32'):
        if operands not in ('float32', 'float8'):
            raise ValueError(f'operands {operands!r}')
        self.w = weights
        self.m = model
        self.q = fp8_round if operands == 'float8' else _identity
        self.d = model['encoder_embedding_dim']
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
    def id_conv(self, label):
        """label int [B, H, W] -> [B, hw, d]: the one-hot of the ids (ids
        0..max_obj_num, 255 on the ignore channel) through the id bank's
        strided conv down to the 16x grid, as tokens."""
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
        return x.flatten(2).transpose(1, 2)

    def temporal_pe(self, length: int):
        """(the current frame's PE, the bank's [length, C]) or None."""
        if 'cur_pos_emb' not in self.w:
            return None
        return (self.w['cur_pos_emb'][0],
                memory_pe(self.w['mem_pos_emb'], length))

    # -------------------------------------------------------------- decoder
    def decode(self, x, xs):
        """The FPN head: the family's features x [B, C, h, w] on the 16x
        grid with the encoder's 16x, 8x and 4x maps, to id logits at 4x."""
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

