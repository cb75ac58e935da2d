"""The train step, on one device or data-parallel over processes.

Counterpart of the JAX package's `train/trainer.py` (reference
aot_plus/networks/managers/trainer.py): one step takes the episode loss
and its gradients (engine/train_engine.py), zeroes the frozen parameters'
gradients, clips by the global norm over the trainable ones, updates with
AdamW (or SGD) at the scheduled learning rate, writes the trainable
BatchNorm statistics back and moves the EMA. The model holds the
parameters; `TrainState` holds the optimizer state, the EMA of every
floating parameter and buffer, and the step counters. Frozen parameters
are `requires_grad=False` during the step, as the reference freezes them.

Data-parallel (`world`, parallel/dist.py), the step is the JAX package's
one program over a `data` mesh (its :78-110, :214-245), run as one process
per card: each rank takes its rows of the world's batch, the gradients are
averaged over the ranks by one all-reduce of a flat buffer after the
backward (not torch's DistributedDataParallel, whose bucket hooks would
meet the non-reentrant checkpoint and the frozen parameters), and the
metrics by another. With `train_zero1` each rank keeps and updates its
ZeRO-1 slice of the optimizer's moments (parallel/tp.py) and the slices
of the update are gathered. Every rank then holds the same parameters.
The loss is a mean over samples, so with equal batches on every rank the
mean over the ranks is the world's mean.

On a D x M world (tensor parallelism, the JAX package's ('data', 'model')
mesh, its :52-60, :219-233) the trainer cuts the model into this rank's
shard of its model group (parallel/tp.py `shard_model`). The M ranks of a
model group take the same rows of the batch and draw the same masks; the
metrics are averaged over the data group only. The gradients fall in
three classes:

- a split parameter of the transformer: its gradient is whole on its
  rank; averaged over the data group;
- a parameter kept whole and used alike by every rank: its gradient is
  alike on every rank of the group (the modules sum the parts of it that
  the ranks' shards produce); averaged over the whole world, so that
  every rank of a model group keeps the same copy even where the card's
  backward is not deterministic;
- under `train_spatial_sharding` (the model group splits the image's
  rows, engine/train_engine.py), a parameter of the encoder, the decoder,
  the encoder's projector or the id bank, used on the rank's band only:
  its gradient on a rank is its band's part, so it is summed over the
  model group and averaged over the data group.

The clip takes the norm over every rank's shards. ZeRO-1 splits each
moment over the data group, along a dimension the model group does not
split. `state_dict` gathers both, so a checkpoint has the layout of one
process whatever the mesh, and `load_state_dict` cuts it again:
checkpoints restore at any mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from rmem_ocu_tpu_torch.config import ExpConfig
from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
from rmem_ocu_tpu_torch.models.vos_model import VOSModel
from rmem_ocu_tpu_torch.parallel import dist, spatial, tp
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.parallel.tp import OPT_MOMENTS, Zero1
from rmem_ocu_tpu_torch.train import optim

# the metrics that are means over the samples of the batch; iou and
# frame_ious are means over the samples that hold an object
MEAN_METRICS = ('loss', 'aux_loss', 'pred_loss', 'frame_losses', 'var_loss')
IOU_METRICS = ('iou', 'frame_ious')


@dataclass
class TrainState:
    opt_state: dict
    ema: Dict[str, torch.Tensor]   # floating parameters and buffers
    step: int = 0
    ema_updates: int = 0


class Trainer:
    def __init__(self, model: VOSModel, exp: ExpConfig,
                 world: World = World()):
        self.model = model
        self.exp = exp
        self.world = world
        mesh = tuple(exp.mesh_shape)
        want = ((1,), (world.size,)) if world.tp == 1 else (
            (world.data.size, world.tp),)
        if mesh not in want:
            raise ValueError(f'mesh_shape={mesh} but the world has '
                             f'{world.data.size} x {world.tp} processes')
        if world.tp > 1 and model.tp.size == 1:
            tp.shard_model(model, world.model)
        self.layout = model.tp_layout
        self.engine = TrainEngine(model, exp, world)
        self.ema_decay = 1.0 - 1.0 / (exp.train_total_steps
                                      * exp.train_ema_ratio)
        self._masks = {}
        # ZeRO-1 at one process keeps the moments whole (the JAX package's
        # `zero1 and dp > 1`), but a process group of one still gathers
        self.zero1 = (Zero1({k: p.shape for k, p in
                             self._params().items()}, world.data,
                            {k: (d,) for k, (d, _) in self.layout.items()})
                      if exp.train_zero1 and world.data.group is not None
                      else None)

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

    def _shard(self, tensors: Dict[str, torch.Tensor]):
        return tensors if self.zero1 is None else self.zero1.shard(tensors)

    def _whole(self, tensors: Dict[str, torch.Tensor]):
        """The tensors with their model-split ones gathered whole."""
        return tp.gather_tensors(tensors, self.layout, self.world.model)

    def _cut(self, tensors: Dict[str, torch.Tensor]):
        """This rank's model shards of whole tensors."""
        return tp.shard_tensors(tensors, self.layout, self.world.model)

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients of every rank's shards."""
        if not self.layout:
            return optim.global_norm(grads)
        split = {k: g for k, g in grads.items() if k in self.layout}
        sq = optim.sum_of_squares(split).to(self.world.device).reshape(1)
        dist.all_reduce_([sq], self.world.model)
        whole = {k: g for k, g in grads.items() if k not in self.layout}
        return torch.sqrt(sq[0] + optim.sum_of_squares(whole))

    def _map_moments(self, opt_state: dict, fn) -> dict:
        return {k: fn(v) if k in OPT_MOMENTS else v
                for k, v in opt_state.items()}

    def _broadcast_model(self, ema: Dict[str, torch.Tensor]) -> None:
        """Rank 0's weights, floating buffers and EMA on every rank (the
        reference's DDP broadcast of the module, trainer.py:107-113): the
        shards over the data group, the whole tensors over the model group
        too."""
        parts = [self._floating_state(), ema]
        dist.broadcast_([v for p in parts for v in p.values()],
                        self.world.data)
        dist.broadcast_([v for p in parts for k, v in p.items()
                         if k not in self.layout], self.world.model)

    def init_state(self) -> TrainState:
        """Zero optimizer state (this rank's slices under ZeRO-1) and the
        EMA at the model's weights, after rank 0's model is broadcast."""
        with torch.no_grad():
            self._broadcast_model({})
            params = {k: p.detach() for k, p in self._params().items()}
            return TrainState(
                opt_state=optim.init_opt_state(self._shard(params),
                                               self.exp),
                ema={k: v.detach().clone()
                     for k, v in self._floating_state().items()})

    def restart_ema(self, state: TrainState) -> TrainState:
        """The EMA set to the model's current weights, as after a
        pretrained load (the JAX CLI's tools/train.py:264-267)."""
        return replace(state, ema={k: v.detach().clone() for k, v
                                   in self._floating_state().items()})

    def state_dict(self, state: TrainState) -> dict:
        """The checkpoint of the model and `state`: tensors and plain
        containers only, the model's weights under the reference keys, the
        optimizer's moments whole whatever the world (collective under
        ZeRO-1: every rank calls it)."""
        opt_state = state.opt_state
        if self.zero1 is not None:
            opt_state = self._map_moments(opt_state, self.zero1.gather)
        return {'state_dict': self._whole(self.model.state_dict()),
                'opt_state': self._map_moments(opt_state, self._whole),
                'ema': self._whole(state.ema),
                'step': state.step, 'ema_updates': state.ema_updates}

    def ema_state_dict(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The EMA, whole (collective under tensor parallelism)."""
        return self._whole(state.ema)

    def load_state_dict(self, ckpt: dict) -> TrainState:
        """Load a `state_dict` checkpoint, of any world, into the model
        (strictly) and return its TrainState with this rank's slices of
        the moments. Restore the checkpoint onto the model's device first
        (`restore_checkpoint(root, target=...)`); every rank calls it."""
        tp.load_whole_state_dict(self.model, ckpt['state_dict'])
        opt_state = self._map_moments(ckpt['opt_state'], self._cut)
        if self.zero1 is not None:
            opt_state = self._map_moments(opt_state, lambda m: {
                k: v.clone() for k, v in self.zero1.shard(m).items()})
        state = TrainState(opt_state=opt_state, ema=self._cut(ckpt['ema']),
                           step=int(ckpt['step']),
                           ema_updates=int(ckpt['ema_updates']))
        with torch.no_grad():
            self._broadcast_model(state.ema)
        return state

    def _reduce_metrics(self, metrics: dict, obj_nums: torch.Tensor
                        ) -> None:
        """The world's means in place of this rank's: one all-reduce.
        The ious weigh each rank by its samples that hold an object."""
        world = self.world.data
        if world.group is None:
            return
        has = (obj_nums > 0).sum().to(torch.float32)
        names = [k for k in MEAN_METRICS + IOU_METRICS if k in metrics]
        flat = torch.cat([
            (metrics[k].float() * (has if k in IOU_METRICS else 1.0)
             ).reshape(-1) for k in names] + [has.reshape(1)])
        dist.all_reduce_([flat], world)
        total = flat[-1]
        parts = flat[:-1].split([metrics[k].numel() for k in names])
        for k, part in zip(names, parts):
            value = (torch.where(total > 0, part / total.clamp_min(1), 1.0)
                     if k in IOU_METRICS else part / world.size)
            metrics[k] = value.reshape(metrics[k].shape)

    @torch.no_grad()
    def _update(self, state: TrainState, masks: optim.ParamMasks,
                aux: dict):
        """After the backward: reduce, clip and apply the gradients, write
        back the trainable BatchNorm statistics of the episode (`aux`'s
        batch_stats) and move the EMA. Returns (the optimizer state, the
        EMA, the gradient norm, the learning rate)."""
        exp = self.exp
        params = self._params()
        # frozen gradients are zero, so the clip and the optimizer see
        # only the trainable ones (reference trainer.py:552)
        grads = {k: (torch.zeros_like(p) if masks.frozen[k]
                     or p.grad is None else p.grad)
                 for k, p in params.items()}
        # the split gradients average over the data group; the whole
        # parameters' over the world, so that their copies in a model
        # group stay bitwise alike even where the backward is not
        # deterministic on the card (cuDNN's weight gradients); the
        # band-local ones sum over the model group
        trainable = [k for k in grads if not masks.frozen[k]]
        band = [k for k in trainable if self.engine.spatial
                and k.split('.')[0] in spatial.BAND_LOCAL]
        dist.all_reduce_([grads[k] for k in trainable
                          if k in self.layout], self.world.data,
                         mean=True)
        dist.all_reduce_([grads[k] for k in trainable
                          if k not in self.layout and k not in band],
                         self.world, mean=True)
        dist.all_reduce_([grads[k] for k in band], self.world)
        for k in band:
            grads[k] /= self.world.data.size
        grad_norm = self._grad_norm(grads)
        now_lr = optim.schedule_lr(state.step, exp)
        current = {k: p.detach() for k, p in params.items()}
        clipped = optim.clip_by_global_norm(
            grads, exp.train_clip_grad_norm, norm=grad_norm)
        if exp.train_opt == 'sgd':
            updates, opt_state = optim.sgd_update(
                self._shard(clipped), state.opt_state,
                self._shard(current), masks, exp)
        else:
            updates, opt_state = optim.adam_update(
                self._shard(clipped), state.opt_state)
        if self.zero1 is not None:
            updates = self.zero1.gather(updates)
        new = optim.apply_updates(current, updates, masks, now_lr, exp)
        for k, p in params.items():
            p.copy_(new[k])
            p.grad = None
        # the trainable BN statistics of the episode (the world's
        # under data parallelism), stored at the buffers' f32
        for name, (mean, var) in aux.pop('batch_stats', {}).items():
            bn = self.model.get_submodule(name)
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        ema = optim.ema_update(state.ema, self._floating_state(),
                               state.ema_updates + 1, self.ema_decay)
        return opt_state, ema, grad_norm, now_lr

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, dict]:
        """batch: frames [B, T, H, W, 3], masks [B, T, H, W], obj_nums [B]
        (this rank's rows of the world's batch). From
        train_seq_training_start_ratio of training on, the memory takes
        the previous prediction and the seq-training parameters (the id
        bank) freeze (reference trainer.py:469-474). The masks' randomness
        comes from `generator` (seeded alike on every rank). Returns (new
        state, metrics: loss, aux_loss, pred_loss, iou, frame_losses,
        frame_ious, lr, grad_norm, pred_mask, and var_loss for TopDown;
        the world's means, except pred_mask, this rank's)."""
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
        opt_state, ema, grad_norm, now_lr = self._update(state, masks,
                                                         aux)
        metrics = {
            'loss': loss.detach(), 'aux_loss': aux['aux_loss'].detach(),
            'pred_loss': aux['pred_loss'].detach(), 'iou': aux['iou'],
            'frame_losses': aux['frame_losses'].detach(),
            'frame_ious': aux['frame_ious'], 'lr': now_lr,
            'grad_norm': grad_norm, 'pred_mask': aux['final_pred_mask']}
        if 'var_loss' in aux:
            metrics['var_loss'] = aux['var_loss'].detach()
        self._reduce_metrics(metrics, batch['obj_nums'].to(loss.device))
        return TrainState(opt_state=opt_state, ema=ema, step=state.step + 1,
                          ema_updates=state.ema_updates + 1), metrics
