"""Flax parameter tree -> the port's state_dict.

The inverse of the JAX package's `utils/torch_convert.py:
convert_torch_params`, for every model of the registry. The input is the
flax `{'params': ...}` tree as nested dicts of numpy arrays (the caller
brings it to numpy, so the port never sees JAX); the output is keyed by
the reference torch names, which are also the port's module paths, so
published `.pth` checkpoints load the same way. The module-path rules are
a copy of torch_convert.py:59-180 (`_flax_key_to_torch`).

Layout transforms (inverse of torch_convert.py:8-14):
- flax Dense kernel [I, O]           -> torch Linear weight [O, I]
- flax Conv kernel [kh, kw, I/g, O]  -> torch Conv2d weight [O, I/g, kh, kw]
- flax ConvTranspose kernel (transpose_kernel=True) [kh, kw, O, I]
                                     -> torch ConvTranspose2d weight
                                        [I, O, kh, kw] (the same axes swap)
- flax norm `scale`                  -> torch `weight`
- frozen-BN leaves, the temporal PE, Swin's relative-position bias tables
  and the TopDown prompt and transform keep their names
- relative_emb_k_w [H, d_att, ws*ws], relative_emb_k_b [H, ws*ws] ->
  the grouped 1x1 conv `relative_emb_k` [H*ws*ws, d_att, 1, 1] + bias
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from rmem_ocu_tpu_torch.config import ModelConfig


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(val)


@functools.lru_cache(maxsize=1)
def _mnv3_no_expand() -> frozenset:
    """MobileNetV3 blocks whose input width equals their hidden width: the
    reference then omits the pw expansion, which shifts the indices of
    their `.conv` Sequential."""
    from rmem_ocu_tpu_torch.models.encoders.mobilenetv2 import (
        make_divisible)
    from rmem_ocu_tpu_torch.models.encoders.mobilenetv3 import _CFGS
    out, inp = set(), make_divisible(16)
    for i, (_, t, c, _, _, _) in enumerate(_CFGS):
        if make_divisible(inp * t) == inp:
            out.add(i)
        inp = make_divisible(c)
    return frozenset(out)


# MBV3Block submodule -> index in the reference's .conv Sequential, with
# and without expansion
_MNV3_SUB = {
    True: {'pw': 'conv.0', 'pw_bn': 'conv.1', 'dw': 'conv.3',
           'dw_bn': 'conv.4', 'se': 'conv.5', 'pw_linear': 'conv.7',
           'pw_linear_bn': 'conv.8'},
    False: {'dw': 'conv.0', 'dw_bn': 'conv.1', 'se': 'conv.3',
            'pw_linear': 'conv.4', 'pw_linear_bn': 'conv.5'},
}

# one flax name -> one torch path, by pattern (first match wins)
_RENAMES = (
    (r'patch_embed', lambda m: 'patch_embed.proj'),              # Swin
    (r'patch_norm', lambda m: 'patch_embed.norm'),
    (r'stage(\d+)_block(\d+)', lambda m: f'layers.{m[1]}.blocks.{m[2]}'),
    (r'mlp_fc(\d)', lambda m: f'mlp.fc{m[1]}'),
    (r'downsample(\d+)', lambda m: f'layers.{m[1]}.downsample'),
    (r'out_norm(\d+)', lambda m: f'norm{m[1]}'),
    (r'stem_conv(\d)', lambda m: f'conv1.{(int(m[1]) - 1) * 3}'),  # ResNeSt
    (r'stem_bn(\d)', lambda m: ('bn1' if m[1] == '3'
                                else f'conv1.{(int(m[1]) - 1) * 3 + 1}')),
    (r'stem', lambda m: 'features.0.0'),                     # MobileNetV3
    (r'stem_bn', lambda m: 'features.0.1'),
    (r'last_conv', lambda m: 'conv.0'),
    (r'last_bn', lambda m: 'conv.1'),
    (r'dec0_up', lambda m: 'decoders.0.0'),                  # TopDown
    (r'dec0', lambda m: 'decoders.0.1'),
    (r'dec(\d)', lambda m: f'decoders.{m[1]}'),
    (r'layer(\d)_(\d+)', lambda m: f'layer{m[1]}.{m[2]}'),
    (r'lstt', lambda m: 'LSTT'),
    # per-layer ConvGRU compressors: ModuleList [K, V]
    (r'memory_gru_k', lambda m: 'memory_grus.0'),
    (r'memory_gru_v', lambda m: 'memory_grus.1'),
)


def _mnv2_key(n: str, rest: Tuple[str, ...]) -> Tuple[str, int]:
    """MobileNetV2 `feat_N/...` (reference mobilenetv2.py:173-206):
    features.N is a ConvBNReLU (stem, last) or an InvertedResidual whose
    .conv Sequential interleaves ConvBNReLU, Conv2d and BN. Returns the
    torch path and the number of flax names it used."""
    if rest and rest[0] in ('conv', 'bn'):
        return f'features.{n}.{0 if rest[0] == "conv" else 1}', 2
    if rest and (m := re.fullmatch(r'conv_(\d+)', rest[0])):
        if len(rest) > 1 and rest[1] in ('conv', 'bn'):
            return (f'features.{n}.conv.{m[1]}.'
                    f'{0 if rest[1] == "conv" else 1}', 3)
        return f'features.{n}.conv.{m[1]}', 2
    if rest and (m := re.fullmatch(r'bn_(\d+)', rest[0])):
        return f'features.{n}.conv.{int(m[1]) + 1}', 2
    return f'features.{n}', 1


def _module_key(parts: Tuple[str, ...], cfg: ModelConfig) -> str:
    """Flax module path -> torch module path."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if (m := re.fullmatch(r'feat_(\d+)', p)):
            key, used = _mnv2_key(m[1], parts[i + 1:])
            out.append(key)
            i += used
            continue
        if (m := re.fullmatch(r'block_(\d+)', p)):
            sub = parts[i + 1] if i + 1 < len(parts) else None
            if sub in _MNV3_SUB[True]:
                # MobileNetV3 block: features.{i+1}.conv.{j}
                bi = int(m[1])
                expand = bi not in _mnv3_no_expand()
                out.append(f'features.{bi + 1}.{_MNV3_SUB[expand][sub]}')
                i += 2
                if sub == 'se' and i < len(parts):
                    # SELayer.fc = Sequential(Linear, ReLU, Linear, h_sig)
                    out.append('fc.0' if parts[i] == 'fc1' else 'fc.2')
                    i += 1
                continue
            out.append(f'layers.{m[1]}')                # GPM / LSTT layer
        elif (m := re.fullmatch(r'decoder_norm_(\d+)', p)):
            out.append(f'decoder_norms.{m[1]}')
            if cfg.vos == 'deaot':
                out.append('gn')      # GroupNorm1D wrapper; LSTT: LayerNorm
        elif p in ('downsample_conv', 'downsample_bn'):
            # ResNeSt's avg-down puts a pool first (resnest/resnet.py:330)
            idx = (p == 'downsample_bn') + ('resnest' in cfg.encoder)
            out.append(f'downsample.{idx}')
        else:
            for pattern, rename in _RENAMES:
                if (m := re.fullmatch(pattern, p)):
                    out.append(rename(m))
                    break
            else:
                out.append(p)
        i += 1
    return '.'.join(out)


def params_from_flax(tree: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Convert a flax parameter tree of the VOS model into a state_dict
    that `VOSModel.load_state_dict(..., strict=True)` accepts."""
    tree = tree.get('params', tree)
    sd = {}
    for path, arr in _flatten(tree):
        *mod, leaf = path
        key = _module_key(tuple(mod), cfg)
        pre = f'{key}.' if key else ''
        if leaf == 'kernel':
            w = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[pre + 'weight'] = w
        elif leaf == 'scale':
            sd[pre + 'weight'] = arr
        elif leaf == 'relative_emb_k_w':
            heads, d_att, ws2 = arr.shape
            sd[pre + 'relative_emb_k.weight'] = arr.transpose(0, 2, 1).reshape(
                heads * ws2, d_att, 1, 1)
        elif leaf == 'relative_emb_k_b':
            sd[pre + 'relative_emb_k.bias'] = arr.reshape(-1)
        elif leaf in ('bias', 'weight', 'running_mean', 'running_var',
                      'cur_pos_emb', 'mem_pos_emb',
                      'relative_position_bias_table', 'prompt',
                      'top_down_transform'):
            sd[pre + leaf] = arr
        else:
            raise KeyError(f'unhandled flax leaf {"/".join(path)}')
    return {k: torch.from_numpy(np.array(v))
            for k, v in sd.items()}
