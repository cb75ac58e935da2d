"""The train step on one device.

Counterpart of the JAX package's `train/trainer.py` (reference
aot_plus/networks/managers/trainer.py) without its mesh: one step takes the
episode loss and its gradients (engine/train_engine.py), zeroes the frozen
parameters' gradients, clips by the global norm over the trainable ones,
updates with AdamW (or SGD) at the scheduled learning rate, writes the
trainable BatchNorm statistics back and moves the EMA. The model holds the
parameters; `TrainState` holds the optimizer state, the EMA of every
floating parameter and buffer, and the step counters. Frozen parameters
are `requires_grad=False` during the step, as the reference freezes them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from rmem_ocu_tpu_torch.config import ExpConfig
from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
from rmem_ocu_tpu_torch.models.vos_model import VOSModel
from rmem_ocu_tpu_torch.train import optim


@dataclass
class TrainState:
    opt_state: dict
    ema: Dict[str, torch.Tensor]   # floating parameters and buffers
    step: int = 0
    ema_updates: int = 0


class Trainer:
    def __init__(self, model: VOSModel, exp: ExpConfig):
        self.model = model
        self.exp = exp
        self.engine = TrainEngine(model, exp)
        self.ema_decay = 1.0 - 1.0 / (exp.train_total_steps
                                      * exp.train_ema_ratio)
        self._masks = {}

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _floating_state(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.state_dict().items()
                if v.is_floating_point()}

    def masks(self, extra_frozen: Tuple[str, ...] = ()) -> optim.ParamMasks:
        if extra_frozen not in self._masks:
            self._masks[extra_frozen] = optim.make_masks(
                self._params(), self.exp, extra_frozen)
        return self._masks[extra_frozen]

    def init_state(self) -> TrainState:
        with torch.no_grad():
            params = {k: p.detach() for k, p in self._params().items()}
            return TrainState(
                opt_state=optim.init_opt_state(params, self.exp),
                ema={k: v.detach().clone()
                     for k, v in self._floating_state().items()})

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, dict]:
        """batch: frames [B, T, H, W, 3], masks [B, T, H, W], obj_nums [B].
        From train_seq_training_start_ratio of training on, the memory
        takes the previous prediction and the seq-training parameters
        (the id bank) freeze (reference trainer.py:469-474). The masks'
        randomness comes from `generator`. Returns (new state, metrics:
        loss, aux_loss, pred_loss, iou, frame_losses, frame_ious, lr,
        grad_norm, pred_mask, and var_loss for TopDown)."""
        exp = self.exp
        use_prev_pred = (state.step >= exp.train_seq_training_start_ratio
                         * exp.train_total_steps)
        extra_frozen = (tuple(exp.train_seq_training_freeze_params)
                        if use_prev_pred else ())
        masks = self.masks(extra_frozen)
        params = self._params()
        for name, p in params.items():
            p.requires_grad_(not masks.frozen[name])
            p.grad = None
        self.model.train()
        loss, aux = self.engine.episode_loss(
            batch['frames'], batch['masks'], batch['obj_nums'], state.step,
            generator, use_prev_pred=use_prev_pred)
        loss.backward()

        with torch.no_grad():
            # frozen gradients are zero, so the clip and the optimizer see
            # only the trainable ones (reference trainer.py:552)
            grads = {k: (torch.zeros_like(p) if masks.frozen[k]
                         or p.grad is None else p.grad)
                     for k, p in params.items()}
            grad_norm = optim.global_norm(grads)
            now_lr = optim.schedule_lr(state.step, exp)
            current = {k: p.detach() for k, p in params.items()}
            if exp.train_opt == 'sgd':
                updates, opt_state = optim.sgd_update(
                    grads, state.opt_state, current, masks, exp)
            else:
                updates, opt_state = optim.adam_update(
                    optim.clip_by_global_norm(grads,
                                              exp.train_clip_grad_norm),
                    state.opt_state)
            new = optim.apply_updates(current, updates, masks, now_lr, exp)
            for k, p in params.items():
                p.copy_(new[k])
                p.grad = None
            # the trainable BN statistics of the episode, stored at the
            # buffers' f32
            for name, (mean, var) in aux.pop('batch_stats', {}).items():
                bn = self.model.get_submodule(name)
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)
            ema = optim.ema_update(state.ema, self._floating_state(),
                                   state.ema_updates + 1, self.ema_decay)
        metrics = {
            'loss': loss.detach(), 'aux_loss': aux['aux_loss'].detach(),
            'pred_loss': aux['pred_loss'].detach(), 'iou': aux['iou'],
            'frame_losses': aux['frame_losses'].detach(),
            'frame_ious': aux['frame_ious'], 'lr': now_lr,
            'grad_norm': grad_norm, 'pred_mask': aux['final_pred_mask']}
        if 'var_loss' in aux:
            metrics['var_loss'] = aux['var_loss'].detach()
        return TrainState(opt_state=opt_state, ema=ema, step=state.step + 1,
                          ema_updates=state.ema_updates + 1), metrics
