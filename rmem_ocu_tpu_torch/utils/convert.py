"""Flax parameter tree -> the port's state_dict.

The inverse of the JAX package's `utils/torch_convert.py:
convert_torch_params` for the ResNet / GPM / LSTT / FPN / VOS-model
branches. The
input is the flax `{'params': ...}` tree as nested dicts of numpy arrays
(the caller brings it to numpy, so the port never sees JAX); the output is
keyed by the reference torch names, which are also the port's module
paths, so published `.pth` checkpoints load the same way.

Layout transforms (inverse of torch_convert.py:8-14):
- flax Dense kernel [I, O]           -> torch Linear weight [O, I]
- flax Conv kernel [kh, kw, I/g, O]  -> torch Conv2d weight [O, I/g, kh, kw]
- flax norm `scale`                  -> torch `weight`
- frozen-BN leaves keep their names
- relative_emb_k_w [H, d_att, ws*ws], relative_emb_k_b [H, ws*ws] ->
  the grouped 1x1 conv `relative_emb_k` [H*ws*ws, d_att, 1, 1] + bias
"""
from __future__ import annotations

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


def _module_key(parts: Tuple[str, ...], cfg: ModelConfig) -> str:
    """Flax module path -> torch module path (the ResNet / GPM / LSTT / FPN
    / VOS cases of torch_convert._flax_key_to_torch)."""
    out = []
    for p in parts:
        if (m := re.fullmatch(r'block_(\d+)', p)):
            out.append(f'layers.{m.group(1)}')
        elif (m := re.fullmatch(r'decoder_norm_(\d+)', p)):
            out.append(f'decoder_norms.{m.group(1)}')
            if cfg.vos == 'deaot':
                out.append('gn')      # GroupNorm1D wrapper; LSTT: LayerNorm
        elif (m := re.fullmatch(r'layer(\d)_(\d+)', p)):
            out.append(f'layer{m.group(1)}.{m.group(2)}')
        elif p == 'downsample_conv':
            out.append('downsample.0')
        elif p == 'downsample_bn':
            out.append('downsample.1')
        elif p == 'lstt':
            out.append('LSTT')
        elif p == 'memory_gru_k':
            # per-layer ConvGRU compressors: ModuleList [K, V]
            out.append('memory_grus.0')
        elif p == 'memory_gru_v':
            out.append('memory_grus.1')
        else:
            out.append(p)
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
                      'cur_pos_emb', 'mem_pos_emb'):
            sd[pre + leaf] = arr
        else:
            raise KeyError(f'unhandled flax leaf {"/".join(path)}')
    return {k: torch.from_numpy(np.array(v))
            for k, v in sd.items()}
