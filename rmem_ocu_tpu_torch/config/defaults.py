"""Typed configuration for the PyTorch port.

A copy of the JAX package's `config/defaults.py`: every model and
experiment field (training, data, eval and directories), the whole model
registry, every stage with its training recipe and the model overrides it
makes, and the reload of a `config_to_dict` snapshot. Values are the
reference's (aot_plus/configs), so the two packages agree field by field;
the CPU tests hold them to that. The data, checkpoint and logging fields
are read by the training data and the train CLI; the mesh fields and
`train_zero1`, `train_spatial_sharding`, `train_encoder_chunk`,
`train_scan_unroll` and the `dots` remat policies exist for XLA, and the
port's training raises on any value but their default.
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
    freeze_bn: bool = True
    freeze_backbone: bool = False
    max_obj_num: int = 10
    ignore_token: bool = True
    self_heads: int = 8
    att_heads: int = 8
    lstt_num: int = 1
    train_long_term_mem_gap: int = 9999
    test_long_term_mem_gap: int = 9999

    # RMem feature flags (reference configs/models/r50_deaotl.py:7-28)
    former_mem_len: int = 1
    latter_mem_len: int = 8
    use_temporal_pe: bool = False
    temporal_pe_slot_4: bool = True       # 4-slot learnable memory PE vs 2
    # training freezes all but the temporal PE / the ConvGRU
    freeze_except_temporal_pe: bool = False
    gru_memory: bool = False
    freeze_except_gru: bool = False
    no_long_memory: bool = False
    no_memory_gap: bool = False
    # REVERSE_INFER: a backward-consistency loss in training (AOT only)
    reverse_infer: bool = False
    reverse_loss: float = 0.4
    use_mask: bool = False                # topdown-encoder mask conditioning
    oracle: bool = False
    # TopDown encoder: weight of its reconstruction loss, and whether
    # training freezes the backbone below its feedback decoders (get_config
    # then sets train_encoder_freeze_at = 4)
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
    """Experiment config composed with a model (reference
    aot_plus/configs/default.py:5-151 plus the stage overrides)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    exp_name: str = 'default'
    stage_name: str = 'default'

    # --- data (read by data/train_datasets.py) ---
    datasets: Tuple[str, ...] = ('youtubevos',)
    data_workers: int = 8
    data_randomcrop: Tuple[int, int] = (465, 465)
    data_randomflip: float = 0.5
    data_max_crop_steps: int = 10
    data_short_edge_len: int = 480
    data_min_scale_factor: float = 0.7
    data_max_scale_factor: float = 1.3
    data_random_reverse_seq: bool = True
    data_seq_len: int = 5
    data_davis_repeat: int = 5
    data_vost_repeat: int = 1
    data_vost_ignore_thresh: float = 0.2
    data_vost_all_frames: bool = False
    data_vost_valid_frames: bool = False
    data_random_gap_davis: int = 12
    data_random_gap_ytb: int = 3
    data_random_gap_vost: int = 3
    data_random_gap_visor: int = 1
    data_dynamic_merge_prob: float = 0.2
    ignore_in_merge: bool = True
    enable_prev_frame: bool = False
    data_visor_repeat: int = 1
    data_visor_ignore_thresh: float = 0.2

    pretrain: bool = True
    pretrain_full: bool = False
    pretrain_model: str = ''

    # --- training ---
    train_total_steps: int = 100_000
    train_start_step: int = 0
    train_tblog: bool = False
    train_img_log_step: int = 200
    train_weight_decay: float = 0.07
    train_weight_decay_exemption: Tuple[str, ...] = (
        'absolute_pos_embed', 'relative_position_bias_table',
        'relative_emb_v', 'conv_out')
    train_lr: float = 2e-4
    train_lr_min: float = 1e-5
    train_lr_power: float = 0.9
    train_lr_encoder_ratio: float = 0.1
    train_lr_warm_up_ratio: float = 0.05
    train_lr_cosine_decay: bool = False
    train_lr_restart: int = 1
    train_aux_loss_weight: float = 1.0
    train_aux_loss_ratio: float = 1.0
    train_opt: str = 'adamw'              # 'adamw' | 'sgd'
    train_sgd_momentum: float = 0.9
    train_batch_size: int = 16
    train_log_step: int = 20
    train_top_k_percent_pixels: float = 0.15
    train_seq_training_freeze_params: Tuple[str, ...] = ('patch_wise_id_bank',)
    train_seq_training_start_ratio: float = 0.5
    train_hard_mining_ratio: float = 0.5
    train_ema_ratio: float = 0.1
    train_clip_grad_norm: float = 5.0
    train_save_step: int = 500
    train_max_keep_ckpt: int = 8
    train_resume: bool = False
    train_auto_resume: bool = True
    train_encoder_freeze_at: int = 2
    train_lstt_emb_dropout: float = 0.0
    train_lstt_id_dropout: float = 0.0
    train_lstt_droppath: float = 0.1
    train_lstt_droppath_scaling: bool = False
    train_lstt_droppath_lst: bool = False
    train_lstt_lt_dropout: float = 0.0
    train_lstt_st_dropout: float = 0.0
    train_long_term_mem_gap: int = 9999
    train_short_term_mem_skip: int = 1
    # 'full' checkpoints the encoder and each frame step, 'none' nothing;
    # 'dots' / 'dots_k*' are XLA policies the port does not have
    train_remat_policy: str = 'full'
    train_encoder_chunk: int = 0          # XLA only: 0
    train_amp: bool = False               # bf16 parameters and activations
    train_scan_unroll: int = 1            # XLA only: 1

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
    # the JAX package's device mesh and sharding knobs (ROADMAP item 15)
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ('data',)
    train_spatial_sharding: bool = False
    train_zero1: bool = False

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
            lstt_num=3, train_long_term_mem_gap=2, test_long_term_mem_gap=5)
_RMEM = dict(former_mem_len=1, latter_mem_len=8, use_temporal_pe=True,
             temporal_pe_slot_4=True)

_SWINB = dict(encoder='swin_base', encoder_dim=(128, 256, 512, 512),
              align_corners=False, lstt_num=3, train_long_term_mem_gap=2,
              test_long_term_mem_gap=5)

MODEL_REGISTRY: Dict[str, ModelConfig] = {
    # AOT family (reference configs/models/aott.py, aots.py, aotb.py,
    # aotl.py), MobileNetV2
    'aott': ModelConfig(model_name='aott'),
    'aots': ModelConfig(model_name='aots', lstt_num=2),
    'aotb': ModelConfig(model_name='aotb', lstt_num=3),
    'aotl': ModelConfig(model_name='aotl', lstt_num=3,
                        train_long_term_mem_gap=2, test_long_term_mem_gap=5),
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
                              train_long_term_mem_gap=2,
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
    return ExpConfig(
        model=model, exp_name=exp_name,
        data_randomcrop=(465, 465) if model.align_corners else (464, 464),
        train_lr_min=2e-5 if 'mobilenetv2' in model.encoder else 1e-5,
        train_long_term_mem_gap=model.train_long_term_mem_gap,
        test_long_term_mem_gap=model.test_long_term_mem_gap)


def _stage_pre(model, exp):
    return replace(_stage_default(model, exp), stage_name='pre',
                   datasets=('static',), data_dynamic_merge_prob=1.0,
                   train_lr=4e-4, train_lr_min=2e-5, train_weight_decay=0.03,
                   train_seq_training_start_ratio=1.0,
                   train_aux_loss_ratio=0.1,
                   model=replace(model, linear_q=True))


def _stage_pre_vost(model, exp, stage_name='pre_vost', seq_len=15):
    model = replace(model, linear_q=False, ignore_token=True)
    gap = 1 if model.no_memory_gap else 4
    return replace(_stage_default(model, exp), stage_name=stage_name,
                   datasets=('vost',), train_total_steps=20_000,
                   data_seq_len=seq_len, train_long_term_mem_gap=gap,
                   train_auto_resume=False, pretrain_full=True)


def _stage_pre_ytb(model, exp):
    return replace(_stage_default(model, exp), stage_name='pre_ytb',
                   data_seq_len=10, train_long_term_mem_gap=4,
                   train_total_steps=80_000, pretrain_full=True,
                   model=replace(model, linear_q=True))


def _stage_pre_dav(model, exp):
    return replace(_stage_default(model, exp), stage_name='pre_dav',
                   datasets=('davis2017',), train_total_steps=50_000,
                   pretrain_full=True)


def _stage_pre_ytb_dav(model, exp):
    return replace(_stage_default(model, exp), stage_name='pre_ytb_dav',
                   datasets=('youtubevos', 'davis2017'), pretrain_full=True)


def _stage_ytb(model, exp):
    return replace(_stage_default(model, exp), stage_name='ytb')


# the reference's stages (configs/*.py): each a training recipe and the
# model settings it overrides
STAGE_REGISTRY = {
    'default': _stage_default,
    'pre': _stage_pre,
    'pre_vost': lambda m, e: _stage_pre_vost(m, e, 'pre_vost', 15),
    'pre_vost_2': lambda m, e: _stage_pre_vost(m, e, 'pre_vost_2', 17),
    'pre_vost_25q': lambda m, e: _stage_pre_vost(m, e, 'pre_vost_25q', 25),
    'pre_ytb': _stage_pre_ytb,
    'pre_dav': _stage_pre_dav,
    'pre_ytb_dav': _stage_pre_ytb_dav,
    'ytb': _stage_ytb,
}


def config_to_dict(exp: ExpConfig) -> dict:
    """The JSON-serialisable snapshot the train CLI writes as config.json
    (reference cfg.save_self(), configs/default.py:186-196); the JAX
    package writes the same one."""
    return dataclasses.asdict(exp)


def config_from_dict(d: dict) -> ExpConfig:
    """Rebuild an ExpConfig from a `config_to_dict` snapshot of either
    package (read back from JSON), the reload of the reference's
    eval.py:97-102, training recipe included. A field the port does not
    know raises."""
    def take(values: dict, cls) -> dict:
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(values) - known)
        if unknown:
            raise ValueError(f'{cls.__name__} has no fields {unknown}')
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in values.items()}

    d = dict(d)
    model = ModelConfig(**take(d.pop('model'), ModelConfig))
    return ExpConfig(model=model, **take(d, ExpConfig))


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
    if cfg.model.top_down_freeze_encoder:
        # reference configs/models/r50_topdown_aotl.py:7 and
        # configs/default.py:121; an explicit override still wins
        cfg = replace(cfg, train_encoder_freeze_at=4)
    if exp_overrides:
        cfg = replace(cfg, **exp_overrides)
    return cfg
