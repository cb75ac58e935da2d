"""The system under test, reached through its public entry points only:
`rmem_ocu_tpu_torch.get_config`, `build_vos_model` and `InferEngine`, and
the engine state's bank."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def build_model(config: dict, device):
    """(experiment config, eval-mode model in the served dtype) of the
    configuration file `config`; raises where the package's settings
    differ from what the file states."""
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    exp = get_config(config['stage'], compute_dtype=config['compute_dtype'],
                     model=config['package_model'])
    for key, want in config['model'].items():
        got = getattr(exp.model, key)
        if (list(got) if isinstance(got, tuple) else got) != want:
            raise ValueError(f'{config["name"]}: the package runs {key}='
                             f'{got!r}, the configuration states {want!r}')
    model = build_vos_model(exp.model, device=device)
    return exp, model.to(DTYPES[config['compute_dtype']])


def shapes_of(model) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def engine(model, exp, gap: int):
    from rmem_ocu_tpu_torch import InferEngine
    return InferEngine(model, exp, long_term_mem_gap=gap)


def grid_of(size: Tuple[int, int], align_corners: bool) -> Tuple[int, int]:
    h, w = size
    if align_corners:
        return (h - 1) // 16 + 1, (w - 1) // 16 + 1
    return h // 16, w // 16


def state_bytes(state) -> int:
    """Bytes held by the engine state's long-term bank and short-term
    memory."""
    total = 0
    for mem in (state.bank, state.short):
        for arr in mem.k + mem.v + (mem.id_v or []):
            total += arr.numel() * arr.element_size()
    return total
