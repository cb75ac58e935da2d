"""Typed configuration for the PyTorch port.

A copy of the parts of the JAX package's `config/defaults.py` that
inference and evaluation read: every model field that is not a training
setting (and the TopDown encoder's two, which describe its model), the
eval and directory fields of `ExpConfig`, the whole model registry, every
stage with the model overrides it makes, and the reload of a
`config_to_dict` snapshot. Values
are the reference's (aot_plus/configs), so the two packages agree field by
field; the CPU tests hold them to that.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


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
    use_mask: bool = False                # topdown-encoder mask conditioning
    oracle: bool = False
    # TopDown encoder: weight of its reconstruction loss, and whether
    # training freezes the backbone below its feedback decoders (read by
    # training, which the port does not have yet; ROADMAP item 14)
    var_loss_weight: Optional[float] = None
    top_down_freeze_encoder: bool = False
    # read by no code, here or in the reference; kept so that a snapshot
    # of the JAX package keeps them
    norm_inp: bool = True
    epsilon: float = 1e-5
    time_encode: bool = False
    time_encode_norm: bool = False

    def __post_init__(self):
        # ORACLE implies mask conditioning, and only the TopDown encoder
        # takes a mask (reference configs/models/r50_topdown_aotl.py:13,
        # networks/models/aot.py:23)
        if self.oracle and not self.use_mask:
            object.__setattr__(self, 'use_mask', True)
        if self.use_mask and 'topdown' not in self.encoder:
            raise ValueError(
                f'use_mask/oracle requires the mask-conditioned topdown '
                f'encoder (got encoder={self.encoder!r}); use model '
                f'r50_topdown_aotl')

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
    """Experiment config composed with a model: the JAX package's
    ExpConfig without its training fields (`TRAINING_FIELDS`)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    exp_name: str = 'default'
    stage_name: str = 'default'

    # --- eval ---
    test_dataset: str = 'youtubevos'
    test_dataset_split: str = 'val'
    test_ckpt_path: Optional[str] = None
    test_ckpt_step: Optional[int] = None
    test_ema: bool = True                 # reference cfg.TEST_EMA
    # multi-group logit merge: 'soft' (bg = prod of bg probs,
    # aot_engine.py:650-673) or 'min' (bg = min logit, :630-648)
    test_aggregation: str = 'soft'
    test_flip: bool = False
    test_multiscale: Tuple[float, ...] = (1.0,)
    # DAVIS Full-Resolution vs 480p image root (reference
    # TEST_DATASET_FULL_RESOLUTION, evaluator.py:171-197)
    test_dataset_full_resolution: bool = False
    test_min_size: Optional[int] = None
    test_max_size: float = 800 * 1.3
    test_workers: int = 4                 # read by no code, as in the JAX one
    test_long_term_mem_gap: int = 9999
    test_short_term_mem_skip: int = 1
    # pin the eval write gap to test_long_term_mem_gap instead of the
    # per-sequence adaptive max(round(frames/30), 5) of the reference
    # (evaluator.py:331-335); tools/eval.py --gap sets it
    test_fixed_mem_gap: bool = False

    # --- dirs ---
    dir_data: str = './datasets'
    dir_root: str = './results'

    compute_dtype: str = 'float32'        # 'float32' | 'bfloat16'

    def dir_result(self) -> str:
        import os
        return os.path.join(self.dir_root,
                            f'{self.exp_name}_{self.model.model_name}',
                            self.stage_name)


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

_SWINB = dict(encoder='swin_base', encoder_dim=(128, 256, 512, 512),
              align_corners=False, lstt_num=3, test_long_term_mem_gap=5)

MODEL_REGISTRY: Dict[str, ModelConfig] = {
    # AOT family (reference configs/models/aott.py, aots.py, aotb.py,
    # aotl.py), MobileNetV2
    'aott': ModelConfig(model_name='aott'),
    'aots': ModelConfig(model_name='aots', lstt_num=2),
    'aotb': ModelConfig(model_name='aotb', lstt_num=3),
    'aotl': ModelConfig(model_name='aotl', lstt_num=3,
                        test_long_term_mem_gap=5),
    # ResNet / ResNeSt / Swin AOT-L; r50_aotl carries the RMem flags in the
    # reference fork
    'r50_aotl': ModelConfig(model_name='r50_aotl', **_R50, **_RMEM),
    'r101_aotl': ModelConfig(model_name='r101_aotl',
                             **{**_R50, 'encoder': 'resnet101'}),
    'rs101_aotl': ModelConfig(model_name='rs101_aotl',
                              **{**_R50, 'encoder': 'resnest101'}),
    'swinb_aotl': ModelConfig(model_name='swinb_aotl', **_SWINB),
    'r50_topdown_aotl': ModelConfig(
        model_name='r50_topdown_aotl',
        **{**_R50, 'encoder': 'resnet50_topdown'}, var_loss_weight=0.01),
    # DeAOT family (default_deaot.py, r50_deaotl.py)
    'deaott': _deaot_defaults(model_name='deaott'),
    'deaots': _deaot_defaults(model_name='deaots', lstt_num=2),
    'deaotb': _deaot_defaults(model_name='deaotb', lstt_num=3),
    'deaotl': _deaot_defaults(model_name='deaotl', lstt_num=3,
                              test_long_term_mem_gap=5),
    'r50_deaotl': _deaot_defaults(model_name='r50_deaotl', **_R50, **_RMEM),
    'swinb_deaotl': _deaot_defaults(model_name='swinb_deaotl', **_SWINB,
                                    **_RMEM),
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


def _stage(stage_name: str, **model_overrides):
    """A stage of the reference (configs/*.py): its name and the model
    settings it overrides. The stages differ otherwise only in training
    settings, which the port does not have yet (ROADMAP item 14)."""
    def make(model: ModelConfig, exp_name: str) -> ExpConfig:
        return replace(_stage_default(replace(model, **model_overrides),
                                      exp_name), stage_name=stage_name)
    return make


STAGE_REGISTRY = {
    'default': _stage('default'),
    'pre': _stage('pre', linear_q=True),
    'pre_vost': _stage('pre_vost', linear_q=False, ignore_token=True),
    'pre_vost_2': _stage('pre_vost_2', linear_q=False, ignore_token=True),
    'pre_vost_25q': _stage('pre_vost_25q', linear_q=False,
                           ignore_token=True),
    'pre_ytb': _stage('pre_ytb', linear_q=True),
    'pre_dav': _stage('pre_dav'),
    'pre_ytb_dav': _stage('pre_ytb_dav'),
    'ytb': _stage('ytb'),
}

# Fields of a JAX package snapshot (`config_to_dict`) that only training
# reads; config_from_dict drops them (ROADMAP item 14 ports training).
TRAINING_FIELDS = frozenset((
    'datasets', 'data_workers', 'data_randomcrop', 'data_randomflip',
    'data_max_crop_steps', 'data_short_edge_len', 'data_min_scale_factor',
    'data_max_scale_factor', 'data_random_reverse_seq', 'data_seq_len',
    'data_davis_repeat', 'data_vost_repeat', 'data_vost_ignore_thresh',
    'data_vost_all_frames', 'data_vost_valid_frames',
    'data_random_gap_davis', 'data_random_gap_ytb', 'data_random_gap_vost',
    'data_random_gap_visor', 'data_dynamic_merge_prob', 'ignore_in_merge',
    'enable_prev_frame', 'data_visor_repeat', 'data_visor_ignore_thresh',
    'pretrain', 'pretrain_full', 'pretrain_model',
    'train_total_steps', 'train_start_step', 'train_tblog',
    'train_img_log_step', 'train_weight_decay',
    'train_weight_decay_exemption', 'train_lr', 'train_lr_min',
    'train_lr_power', 'train_lr_encoder_ratio', 'train_lr_warm_up_ratio',
    'train_lr_cosine_decay', 'train_lr_restart', 'train_aux_loss_weight',
    'train_aux_loss_ratio', 'train_opt', 'train_sgd_momentum',
    'train_batch_size', 'train_log_step', 'train_top_k_percent_pixels',
    'train_seq_training_freeze_params', 'train_seq_training_start_ratio',
    'train_hard_mining_ratio', 'train_ema_ratio', 'train_clip_grad_norm',
    'train_save_step', 'train_max_keep_ckpt', 'train_resume',
    'train_auto_resume', 'train_encoder_freeze_at', 'train_lstt_emb_dropout',
    'train_lstt_id_dropout', 'train_lstt_droppath',
    'train_lstt_droppath_scaling', 'train_lstt_droppath_lst',
    'train_lstt_lt_dropout', 'train_lstt_st_dropout',
    'train_long_term_mem_gap', 'train_short_term_mem_skip',
    'train_remat_policy', 'train_encoder_chunk', 'train_amp',
    'train_scan_unroll', 'mesh_shape', 'mesh_axes',
    'train_spatial_sharding', 'train_zero1'))
MODEL_TRAINING_FIELDS = frozenset((
    'freeze_bn', 'freeze_backbone', 'train_long_term_mem_gap',
    'freeze_except_temporal_pe', 'freeze_except_gru', 'reverse_infer'))


def config_from_dict(d: dict) -> ExpConfig:
    """Rebuild an ExpConfig from a snapshot written by the JAX package's
    `config_to_dict` (and read back from JSON), the reload of the
    reference's eval.py:97-102. Every model and eval field is kept; the
    training fields listed in `TRAINING_FIELDS` and `MODEL_TRAINING_FIELDS`
    are dropped. Any other field the port does not know raises."""
    def take(values: dict, cls, dropped: frozenset) -> dict:
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(values) - known - dropped)
        if unknown:
            raise ValueError(f'{cls.__name__} has no fields {unknown}')
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in values.items() if k in known}

    d = dict(d)
    model = ModelConfig(**take(d.pop('model'), ModelConfig,
                               MODEL_TRAINING_FIELDS))
    return ExpConfig(model=model, **take(d, ExpConfig, TRAINING_FIELDS))


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
