"""Typed configuration for the PyTorch port.

A copy of the parts of the JAX package's `config/defaults.py` that
streaming inference reads: the fields of `ModelConfig` / `ExpConfig` it
uses, the `r50_deaotl` (DeAOT) and `r50_aotl` (AOT) registry entries and
the `pre_vost` / `pre_vost_2` stages. Values are the reference's
(aot_plus/configs), so the two packages agree field by field; the CPU tests
hold them to that.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Model family/size/backbone selection + RMem feature flags."""

    model_name: str = 'aott'
    vos: str = 'aot'                      # 'aot' | 'deaot'
    engine: str = 'aotengine'             # 'aotengine' | 'deaotengine'
    align_corners: bool = True
    encoder: str = 'mobilenetv2'
    encoder_dim: Tuple[int, ...] = (24, 32, 96, 1280)  # 4x, 8x, 16x, 16x
    encoder_embedding_dim: int = 256
    decoder_intermediate_lstt: bool = True
    linear_q: bool = True
    max_obj_num: int = 10
    ignore_token: bool = True
    self_heads: int = 8
    att_heads: int = 8
    lstt_num: int = 1
    test_long_term_mem_gap: int = 9999

    # RMem feature flags (reference configs/models/r50_deaotl.py:7-28)
    former_mem_len: int = 1
    latter_mem_len: int = 8
    use_temporal_pe: bool = False
    temporal_pe_slot_4: bool = True       # 4-slot learnable memory PE vs 2
    gru_memory: bool = False
    no_long_memory: bool = False
    no_memory_gap: bool = False
    reverse_loss: float = 0.4

    @property
    def id_dim(self) -> int:
        return self.max_obj_num + (2 if self.ignore_token else 1)

    @property
    def mem_bank_capacity(self) -> int:
        """Static bank capacity: budget + the not-yet-restricted newest
        slot."""
        return self.former_mem_len + self.latter_mem_len + 1


@dataclass(frozen=True)
class ExpConfig:
    """Experiment config composed with a model (the eval-relevant subset
    of the JAX package's ExpConfig)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    exp_name: str = 'default'
    stage_name: str = 'default'
    test_long_term_mem_gap: int = 9999
    test_short_term_mem_skip: int = 1
    compute_dtype: str = 'float32'        # 'float32' | 'bfloat16'


def _deaot_defaults(**kw) -> ModelConfig:
    """Reference: configs/models/default_deaot.py:4-18."""
    base = dict(vos='deaot', engine='deaotengine',
                decoder_intermediate_lstt=False, self_heads=1, att_heads=1)
    base.update(kw)
    return ModelConfig(**base)


_R50 = dict(encoder='resnet50', encoder_dim=(256, 512, 1024, 1024),
            lstt_num=3, test_long_term_mem_gap=5)
_RMEM = dict(former_mem_len=1, latter_mem_len=8, use_temporal_pe=True,
             temporal_pe_slot_4=True)

MODEL_REGISTRY: Dict[str, ModelConfig] = {
    # r50_aotl carries the RMem flags in the reference fork
    'r50_aotl': ModelConfig(model_name='r50_aotl', **_R50, **_RMEM),
    'r50_deaotl': _deaot_defaults(model_name='r50_deaotl', **_R50, **_RMEM),
}


def _couple_no_memory_gap(base: ModelConfig, overrides: dict) -> dict:
    """NO_MEMORY_GAP couples two derived settings in the reference's model
    config (configs/models/r50_deaotl.py:23,27): MODEL_ATT_HEADS becomes 2
    and REVERSE_LOSS is quartered, unless passed explicitly."""
    if overrides.get('no_memory_gap') and not base.no_memory_gap:
        overrides.setdefault('att_heads', 2)
        overrides.setdefault('reverse_loss', 0.1)
    return overrides


def get_model_config(name: str, **overrides) -> ModelConfig:
    cfg = MODEL_REGISTRY[name.lower()]
    overrides = _couple_no_memory_gap(cfg, overrides)
    return replace(cfg, **overrides) if overrides else cfg


def _stage_default(model: ModelConfig, exp_name: str) -> ExpConfig:
    return ExpConfig(model=model, exp_name=exp_name,
                     test_long_term_mem_gap=model.test_long_term_mem_gap)


def _stage_pre_vost(model, exp, stage_name):
    # Reference: configs/pre_vost.py, pre_vost_2.py. The stages differ only
    # in training settings, which the port does not have yet.
    model = replace(model, linear_q=False, ignore_token=True)
    return replace(_stage_default(model, exp), stage_name=stage_name)


STAGE_REGISTRY = {
    'default': _stage_default,
    'pre_vost': lambda m, e: _stage_pre_vost(m, e, 'pre_vost'),
    'pre_vost_2': lambda m, e: _stage_pre_vost(m, e, 'pre_vost_2'),
}


def get_config(stage: str, exp_name: str = 'default',
               model: str = 'r50_deaotl', **overrides) -> ExpConfig:
    """Compose stage + model; overrides naming a ModelConfig field go to
    the model, the rest to the experiment."""
    cfg = STAGE_REGISTRY[stage](get_model_config(model), exp_name)
    model_fields = {f.name for f in dataclasses.fields(ModelConfig)}
    model_overrides = {k: v for k, v in overrides.items()
                       if k in model_fields}
    exp_overrides = {k: v for k, v in overrides.items()
                     if k not in model_fields}
    if model_overrides:
        model_overrides = _couple_no_memory_gap(cfg.model, model_overrides)
        cfg = replace(cfg, model=replace(cfg.model, **model_overrides))
    if exp_overrides:
        cfg = replace(cfg, **exp_overrides)
    return cfg
