"""Optimizer, learning-rate schedule and parameter-group rules.

Counterpart of the JAX package's `train/optim.py` (reference
aot_plus/utils/learning.py:4-95, trainer.py:144-178): pure functions over
name -> tensor dicts keyed by the model's parameter names (the reference
torch names). AdamW is Adam's update plus decoupled weight decay with a
per-group learning rate, `(lr - lr_min) * ratio + lr_min` for the encoder;
SGD adds L2 decay to the gradient before Nesterov momentum. Global-norm
clipping and the Adam and EMA arithmetic follow optax's formulas (f32
scalars), so that one step matches the JAX package's; torch's
`clip_grad_norm_` adds 1e-6 to the norm and would not.

The optimizer's arithmetic is elementwise, so `init_opt_state`,
`adam_update` and `sgd_update` work on a ZeRO-1 slice of each tensor
(parallel/tp.py) as on the whole; the clip comes before them, on the whole
gradients, which under data parallelism are already averaged over the
ranks. Under tensor parallelism the tensors are a rank's shards, the
arithmetic is the same, and the trainer hands the clip the global norm
over every rank's shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def schedule_lr(step, exp) -> float:
    """Linear warm-up, then poly(train_lr_power) or cosine decay
    (reference utils/learning.py:22-34), optionally in train_lr_restart
    equal cycles (learning.py:16-19: each ceil(total / restart) steps with
    the warm-up shrunk by 1 / restart). The JAX package's arithmetic: the
    config's constants combine as Python floats, the step-dependent terms
    in f32."""
    base, mn = exp.train_lr, exp.train_lr_min
    max_itr = exp.train_total_steps
    warm = exp.train_lr_warm_up_ratio * max_itr
    step = torch.tensor(float(step), dtype=torch.float32)
    if exp.train_lr_restart > 1:
        each = float(math.ceil(max_itr / exp.train_lr_restart))
        warm = warm / exp.train_lr_restart
        max_itr = each
        step = torch.remainder(step, each)
    it = step - warm
    mx = max_itr - warm
    if step < warm:
        lr = mn + (base - mn) * step / warm
    elif exp.train_lr_cosine_decay:
        lr = mn + (base - mn) * (torch.cos(math.pi * it / (mx + 1)) + 1.0
                                 ) * 0.5
    else:
        lr = mn + (base - mn) * (1.0 - it / (mx + 1)) ** exp.train_lr_power
    return float(lr)


def _encoder_stage_frozen(name: str, encoder: str, freeze_at: int) -> bool:
    """Stage-level encoder freezing (reference encoders/*/freeze(freeze_at),
    e.g. resnet.py:206-213: freeze_at >= 1 freezes the stem, stage N
    counts from 2 = the 4x stage), read off the torch name's first module
    under 'encoder.'."""
    if freeze_at <= 0 or not name.startswith('encoder.'):
        return False
    parts = name.split('.')[1:]
    mod = parts[0]
    if encoder.startswith(('resnet', 'resnest')):
        # stem: conv1 / bn1 (ResNeSt's conv1 is its three-conv stem);
        # layerN is stage N + 1; TopDown's decoders and prompt never freeze
        if mod in ('conv1', 'bn1'):
            return freeze_at >= 1
        if mod.startswith('layer'):
            return freeze_at >= int(mod[5]) + 1
        return False
    if encoder == 'mobilenetv2':
        # features.j; stages [0:4], [4:7], [7:14], [14:] (reference
        # mobilenetv2.py:210-215, freeze :240-247)
        j = int(parts[1])
        if j == 0 and freeze_at >= 1:
            return True
        return freeze_at >= 2 + sum(j >= b for b in (4, 7, 14))
    if encoder == 'mobilenetv3':
        # features.0 is the stem, features.j block j - 1; stages [0:4],
        # [4:7], [7:13], [13:] (mobilenetv3.py:200-206, :233-240); the last
        # 1x1 conv (`conv`) never freezes
        if mod != 'features':
            return False
        j = int(parts[1])
        if j == 0:
            return freeze_at >= 1
        return freeze_at >= 2 + sum(j >= b for b in (4, 7, 13))
    if encoder.startswith('swin'):
        # patch embedding at >= 1; layers.i (blocks and downsample) at
        # >= i + 2; the output norms never (swin/build.py:21, :637-655)
        if mod == 'patch_embed':
            return freeze_at >= 1
        if mod == 'layers':
            return freeze_at >= int(parts[1]) + 2
        return False
    return False


def _weight_dims(name: str, p: torch.Tensor) -> int:
    """The dimensions of the parameter in the JAX package's layout, which
    its weight-decay rule reads: the windowed attention's relative-bias
    conv keeps a [heads, ws * ws] bias there (decayed), a 1-D bias here."""
    if name.endswith('relative_emb_k.bias'):
        return 2
    return p.dim()


@dataclass(frozen=True)
class ParamMasks:
    """Per parameter name: weight-decay coefficient, encoder group, frozen
    (trained at lr 0, i.e. requires_grad=False)."""
    wd: Dict[str, float]
    is_enc: Dict[str, bool]
    frozen: Dict[str, bool]


def make_masks(params: Tensors, exp, extra_frozen: Sequence[str] = ()
               ) -> ParamMasks:
    """The rules of the JAX package's `make_masks` on the model's
    parameters (buffers never train). Weight decay: none for 1-D
    parameters and names holding an exemption key (reference
    utils/learning.py:70-83). Frozen: the extra_frozen name fragments, and
    the freeze recipes in the reference's order (trainer.py:65-92):
    freeze_except_temporal_pe or freeze_except_gru override the rest;
    otherwise freeze_backbone and the encoder's stage freezing
    (train_encoder_freeze_at)."""
    mcfg = exp.model
    wd, is_enc, frozen = {}, {}, {}
    for name, p in params.items():
        fz = any(f in name for f in extra_frozen)
        enc = name.startswith('encoder.')
        if mcfg.freeze_except_temporal_pe:
            fz = not ('cur_pos_emb' in name or 'mem_pos_emb' in name)
        elif mcfg.freeze_except_gru:
            fz = 'memory_gru' not in name
        else:
            if mcfg.freeze_backbone and enc:
                fz = True
            if enc and _encoder_stage_frozen(name, mcfg.encoder,
                                             exp.train_encoder_freeze_at):
                fz = True
        decay = exp.train_weight_decay
        if _weight_dims(name, p) <= 1 or any(
                ex in name for ex in exp.train_weight_decay_exemption):
            decay = 0.0
        wd[name], is_enc[name], frozen[name] = decay, enc, fz
    return ParamMasks(wd, is_enc, frozen)


def sum_of_squares(tensors: Tensors) -> torch.Tensor:
    """The f32 sum of squares of every element (a 0 tensor for none)."""
    return sum((x.float().square().sum() for x in tensors.values()),
               torch.zeros(()))


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax global_norm)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tensors.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> Tensors:
    """optax's clip: unchanged below max_norm, else g / norm * max_norm.
    `norm` is the gradients' global norm when the caller has it (under
    tensor parallelism, the norm over every rank's shards)."""
    if norm is None:
        norm = global_norm(grads)
    under = norm < max_norm
    return {k: torch.where(under, g, g / norm * max_norm)
            for k, g in grads.items()}


def init_opt_state(params: Tensors, exp) -> dict:
    """Zero moments (AdamW) or zero momentum trace (SGD) per parameter (or
    per slice of one)."""
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
    if exp.train_opt == 'sgd':
        return {'trace': zeros()}
    return {'count': 0, 'mu': zeros(), 'nu': zeros()}


def adam_update(grads: Tensors, state: dict) -> Tuple[Tensors, dict]:
    """optax scale_by_adam(0.9, 0.999, 1e-8): moments, f32 bias
    correction 1 - b**count, update mu_hat / (sqrt(nu_hat) + eps)."""
    count = state['count'] + 1
    mu = {k: (1 - ADAM_B1) * g + ADAM_B1 * state['mu'][k]
          for k, g in grads.items()}
    nu = {k: (1 - ADAM_B2) * (g * g) + ADAM_B2 * state['nu'][k]
          for k, g in grads.items()}
    c1 = float(1 - _f32(ADAM_B1) ** count)
    c2 = float(1 - _f32(ADAM_B2) ** count)
    updates = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
               for k in grads}
    return updates, {'count': count, 'mu': mu, 'nu': nu}


def sgd_update(grads: Tensors, state: dict, params: Tensors,
               masks: ParamMasks, exp) -> Tuple[Tensors, dict]:
    """The JAX package's SGD chain (reference trainer.py:155-161, torch SGD
    semantics) after its clip, which the caller applies to the whole
    gradients: add L2 decay where the decay coefficient is positive, then
    Nesterov momentum (trace = g + m * trace; update = g + m * trace)."""
    m = exp.train_sgd_momentum
    grads = {k: g + exp.train_weight_decay * params[k] if masks.wd[k] > 0.0
             else g for k, g in grads.items()}
    trace = {k: g + m * state['trace'][k] for k, g in grads.items()}
    updates = {k: g + m * trace[k] for k, g in grads.items()}
    return updates, {'trace': trace}


def apply_updates(params: Tensors, updates: Tensors, masks: ParamMasks,
                  now_lr: float, exp) -> Tensors:
    """p - lr_group * (update + wd * p), torch-AdamW style (decoupled decay;
    under SGD the decay is already in the update). lr_group is
    (lr - lr_min) * ratio + lr_min for the encoder, lr elsewhere, 0 where
    frozen (f32 scalars)."""
    lr, mn = _f32(now_lr), _f32(exp.train_lr_min)
    enc_lr = float((lr - mn) * _f32(exp.train_lr_encoder_ratio) + mn)
    decoupled = exp.train_opt != 'sgd'
    out = {}
    for k, p in params.items():
        group_lr = 0.0 if masks.frozen[k] else (
            enc_lr if masks.is_enc[k] else float(lr))
        u = updates[k]
        if decoupled:
            u = u + masks.wd[k] * p
        out[k] = p - group_lr * u
    return out


def ema_update(ema: Tensors, params: Tensors, num_updates: int,
               decay: float) -> Tensors:
    """Reference utils/ema.py:55-67: decay warmed up as
    min(decay, (1 + n) / (10 + n)); s - (1 - d) (s - p)."""
    n = _f32(num_updates)
    d = torch.minimum(_f32(decay), (1.0 + n) / (10.0 + n))
    keep = float(1.0 - d)
    return {k: s - keep * (s - params[k].to(s.dtype)) for k, s in ema.items()}
