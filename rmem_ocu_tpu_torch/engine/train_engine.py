"""The training episode: loss of one batch of clips, for autograd.

Counterpart of the JAX package's `engine/train_engine.py` (reference
aot_plus/networks/engines/aot_engine.py:40-128, AOTEngine.forward). The
encoder runs once over all B*T frames; the reference frame (t = 0) is
added; then a Python loop over frames 1..T-1 (the JAX package's
`lax.scan`) propagates each frame against the memory, takes its loss at
input resolution and updates the memory: the short-term push every frame,
the long-term write on the gap schedule, and, over budget, the eviction of
the training's default drop slot. The memory ops are the bank's functional
ones, so that autograd sees every write.

The model runs in training mode: every attention read is the dense
differentiable one (the CUDA kernels have no backward and are never
called), and dropout and drop-path act. `train_remat_policy='full'` wraps
the encoder and each frame step in `torch.utils.checkpoint`. A checkpoint
restores torch's global RNG for its recompute, but not an explicit
generator, so each checkpointed call takes a seed drawn from the episode's
generator outside it and draws its masks from a generator made from that
seed inside it: the recompute draws the same masks.

`train_amp` casts the parameters, the floating buffers and the frames to
bf16 inside the loss, as the JAX package's `episode_loss` does: the model
runs on the bf16 copies through `torch.func.functional_call`, the losses
upcast to f32, and the gradients reach the f32 parameters in f32. (Not
`torch.autocast`, which picks per op what runs in bf16.)
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from rmem_ocu_tpu_torch.config import ExpConfig
from rmem_ocu_tpu_torch.memory import bank as membank
from rmem_ocu_tpu_torch.models.vos_model import VOSModel
from rmem_ocu_tpu_torch.ops.layers import BatchNorm2d, noise_from
from rmem_ocu_tpu_torch.ops.losses import segmentation_loss
from rmem_ocu_tpu_torch.ops.masks import (generate_permute_matrix,
                                          one_hot_mask, shuffle_one_hot,
                                          unshuffle_logits)
from rmem_ocu_tpu_torch.ops.position import interpolated_memory_pe
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
from rmem_ocu_tpu_torch.utils.metric import batched_iou
from rmem_ocu_tpu_torch.utils.precision import cast_floating

UNUSED_ID_LOGIT = -1e10

# knobs of the JAX package that exist for XLA and its device mesh; the
# port raises on any value but the default rather than ignore them
XLA_ONLY_DEFAULTS = (('train_scan_unroll', 1), ('train_encoder_chunk', 0),
                     ('train_spatial_sharding', False),
                     ('train_zero1', False))


def check_port_knobs(exp: ExpConfig) -> None:
    if exp.train_remat_policy not in ('full', 'none'):
        raise NotImplementedError(
            f'train_remat_policy={exp.train_remat_policy!r} is an XLA '
            f'rematerialisation policy; the port checkpoints with '
            f"torch.utils.checkpoint: 'full' or 'none'")
    for name, default in XLA_ONLY_DEFAULTS:
        if getattr(exp, name) != default:
            raise NotImplementedError(
                f'{name}={getattr(exp, name)!r}: an XLA knob of the JAX '
                f'package, not ported (ROADMAP item 15); leave it at '
                f'{default!r}')


def _new_seed(generator: Optional[torch.Generator]) -> int:
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


class TrainEngine:
    """Binds a model and its experiment config to the episode loss. The
    model's trainable BatchNorm layers (freeze_bn off) leave their running
    statistics to the caller: `episode_loss` returns them as
    aux['batch_stats'] and the trainer writes them back."""

    def __init__(self, model: VOSModel, exp: ExpConfig):
        check_port_knobs(exp)
        self.model = model
        self.cfg = model.cfg
        self.exp = exp
        self.gap = exp.train_long_term_mem_gap
        self.skip = exp.train_short_term_mem_skip
        self.remat = exp.train_remat_policy == 'full'
        self.bns = {name: m for name, m in model.named_modules()
                    if isinstance(m, BatchNorm2d)}
        for m in self.bns.values():
            m.defer_stats = True

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -------------------------------------------------------------- #
    def _call(self, params, method: str, *args, **kwargs):
        """model.<method>(...), on `params` (name -> tensor) when given."""
        if params is None:
            return getattr(self.model, method)(*args, **kwargs)
        return functional_call(self.model, params, (method,) + args, kwargs)

    def _noise(self, seed: Optional[int]):
        """The train-time masks of a call, from a generator made from
        `seed` (torch's global generator when None)."""
        if seed is None:
            return nullcontext()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return noise_from(gen)

    def _dims(self):
        """(key width, value width, the bank holds ID_V)."""
        cfg = self.cfg
        d = cfg.encoder_embedding_dim
        if cfg.vos != 'deaot':
            return d, d, False
        d_att = d // 2 if cfg.att_heads == 1 else d // cfg.att_heads
        return d_att * cfg.att_heads, 2 * d, True

    def _episode_capacity(self, t_total: int) -> int:
        """The tight bank capacity of a T-frame episode: the write schedule
        (t = gap, 2 gap, ... <= T-1) keeps at most 1 + (T-1) // gap frames
        live, which needs no eviction while within former + latter; else
        the full ring."""
        cfg = self.cfg
        live_total = 1 + max(t_total - 1, 0) // max(self.gap, 1)
        if cfg.no_long_memory:
            live_total = 1
        if live_total <= cfg.former_mem_len + cfg.latter_mem_len:
            return max(live_total, 1)
        return cfg.mem_bank_capacity

    def _id_emb(self, params, one_hot, ignore, shuffle, freeze_id: bool):
        """Reference engines/aot_engine.py:208-232."""
        if self.cfg.ignore_token:
            bg = one_hot[..., :1] * (ignore == 0).to(one_hot.dtype)
            one_hot = torch.cat([bg, one_hot[..., 1:]], dim=-1)
        if shuffle is not None:
            one_hot = shuffle_one_hot(one_hot, shuffle)
        if self.cfg.ignore_token:
            one_hot = torch.cat([one_hot, ignore], dim=-1)
        id_emb = self._call(params, 'get_id_emb', one_hot)
        return id_emb.detach() if freeze_id else id_emb

    def _temporal_pe(self, params, length, cap: int, pos=None):
        """(cur_pe [C], mem_pe [B, cap, C]) interpolated to the live
        length and permuted onto the physical slots by `pos`."""
        if not self.cfg.use_temporal_pe:
            return None
        cur, mem = self._call(params, 'temporal_pe')
        mem_i = interpolated_memory_pe(mem, length, cap)
        if pos is not None:
            gathered = torch.gather(
                mem_i, 1, pos.clamp_min(0)[..., None].expand_as(mem_i))
            mem_i = torch.where((pos >= 0)[..., None], gathered, 0.0)
        return cur[0], mem_i

    def _mask_unused(self, logits, obj_nums):
        c = logits.shape[-1]
        keep = torch.arange(c, device=logits.device)[None] <= obj_nums[:, None]
        return torch.where(keep[:, None, None, :], logits, UNUSED_ID_LOGIT)

    def _upsample(self, logits_4x, input_size):
        return interpolate_bilinear(logits_4x.permute(0, 3, 1, 2), input_size,
                                    self.cfg.align_corners).permute(0, 2, 3, 1)

    def _frame_loss(self, logits_4x, gt, obj_nums, step, input_size):
        """Per-sample loss of a frame at input resolution (reference
        aot_engine.py:485-508)."""
        exp = self.exp
        return segmentation_loss(
            self._upsample(logits_4x, input_size), gt, step,
            exp.train_total_steps, exp.train_hard_mining_ratio,
            exp.train_top_k_percent_pixels, obj_nums)

    # -------------------------------------------------------------- #
    def episode_loss(self, frames: torch.Tensor, masks: torch.Tensor,
                     obj_nums: torch.Tensor, step,
                     generator: Optional[torch.Generator] = None,
                     use_prev_pred: bool = False,
                     enable_id_shuffle: bool = True):
        """frames: [B, T, H, W, 3]; masks: int [B, T, H, W]; obj_nums: [B];
        step: the training step (hard-mining and aux-loss ramps). The id
        shuffle and the masks' seeds come from `generator` (a CPU
        generator; torch's global one when None). Returns (scalar loss,
        aux dict: aux_loss, pred_loss, frame_losses [T-1], frame_ious [T],
        iou, final_pred_mask [B, H, W], var_loss (TopDown), batch_stats
        (trainable BN: module name -> (running_mean, running_var)))."""
        cfg, exp = self.cfg, self.exp
        dev = self.device
        frames, masks = frames.to(dev), masks.to(dev)
        obj_nums = obj_nums.to(dev)
        b, t_total, h, w, _ = frames.shape
        input_size = (h, w)
        params = None
        if exp.train_amp:
            model = self.model
            params = {**cast_floating(dict(model.named_parameters()),
                                      torch.bfloat16),
                      **cast_floating(dict(model.named_buffers()),
                                      torch.bfloat16)}
            frames = frames.to(torch.bfloat16)
        seed = lambda: _new_seed(generator)

        # --- the offline encode of all B*T frames (aot_engine.py:174-196)
        var_loss_on = cfg.var_loss_weight is not None
        enc_mask = (masks.reshape(b * t_total, h, w)[..., None].long()
                    if cfg.use_mask else None)

        def encode(p, imgs, m):
            return self._call(p, 'encode_image', imgs, m,
                              var_loss=var_loss_on)
        flat = frames.reshape(b * t_total, h, w, 3)
        out = (checkpoint(encode, params, flat, enc_mask, use_reentrant=False)
               if self.remat else encode(params, flat, enc_mask))
        xs, var_loss = out if var_loss_on else (out, None)
        xs = [x.reshape(b, t_total, *x.shape[1:]) for x in xs]  # NCHW
        size_2d = tuple(xs[-1].shape[-2:])
        hw = size_2d[0] * size_2d[1]

        one_hot_all, ignore_all = one_hot_mask(
            masks.reshape(b * t_total, h, w), cfg.max_obj_num)
        one_hot_all = one_hot_all.to(frames.dtype).reshape(
            b, t_total, h, w, -1)
        ignore_all = ignore_all.to(frames.dtype).reshape(b, t_total, h, w, 1)
        shuffle = (generate_permute_matrix(cfg.max_obj_num + 1, b, generator,
                                           dev)
                   if enable_id_shuffle else None)
        self_pos = (None if cfg.vos == 'deaot' else
                    self.model.get_pos_emb(size_2d).to(dev, frames.dtype))
        ck, cv, with_id = self._dims()
        n_layers = cfg.lstt_num
        cap = self._episode_capacity(t_total)
        budget = cfg.former_mem_len + cfg.latter_mem_len

        def lstt(p, emb16, long_mem, short_mem, id_emb, tpe):
            return self._call(p, 'lstt_forward', emb16, long_mem, short_mem,
                              id_emb, self_pos, size_2d, temporal_pe=tpe)

        def decode(p, inters, shortcuts):
            logits = self._call(p, 'decode_id_logits', inters, shortcuts)
            if shuffle is not None:
                logits = unshuffle_logits(logits, shuffle)
            return self._mask_unused(logits, obj_nums)

        def frame_xs(t):
            return [x[:, t] for x in xs]

        def memories(bank, short):
            k, v, id_v = short.read()
            if cfg.vos == 'deaot':
                return ((bank.k, bank.v, bank.id_v, bank.slot_valid),
                        (k, v, id_v))
            return (bank.k, bank.v, bank.slot_valid), (k, v)

        def predict(logits):
            return self._upsample(logits.detach(), input_size).argmax(dim=-1)

        # --- the reference frame (t = 0)
        with self._noise(seed()):
            id_emb0 = self._id_emb(params, one_hot_all[:, 0],
                                   ignore_all[:, 0], shuffle,
                                   freeze_id=use_prev_pred)
            tpe_ref = self._temporal_pe(
                params, torch.ones(b, dtype=torch.long, device=dev), cap)
            if tpe_ref is not None:
                tpe_ref = (tpe_ref[0], tpe_ref[1][:, :1])
            inters0, mems0, _ = lstt(params, xs[-1][:, 0], None, None,
                                     id_emb0, tpe_ref)
            logits0 = decode(params, inters0, frame_xs(0))
        aux_loss = self._frame_loss(logits0, masks[:, 0], obj_nums, step,
                                    input_size)
        pred0 = predict(logits0)
        iou0 = batched_iou(pred0, masks[:, 0], obj_nums, cfg.max_obj_num)

        stack = lambda ms, key: [m[key] for m in ms]
        long_k0 = stack(mems0, 'curr_k')
        if cfg.vos == 'deaot':
            long_v0, long_id0 = (stack(mems0, 'curr_v'),
                                 stack(mems0, 'global_id_v_fused'))
            short0 = (long_k0, long_v0, long_id0)
        else:
            long_v0, long_id0 = stack(mems0, 'global_v_fused'), None
            short0 = (stack(mems0, 'local_k'), stack(mems0, 'local_v'), None)
        bank = membank.init_bank(n_layers, b, cap, hw, ck, cv, frames.dtype,
                                 dev, with_id=with_id)
        bank = membank.append_frame_functional(bank, long_k0, long_v0,
                                               long_id0, 0)
        short = membank.init_short_term(n_layers, b, self.skip, hw, ck, cv,
                                        frames.dtype, dev, with_id=with_id)
        short = membank.push_short_term_functional(short, *short0)
        reverse = cfg.reverse_infer and cfg.vos == 'aot'

        # --- frames 1..T-1
        def frame_step(p, step_seed, t_idx, do_long, rev_gate, bank, short,
                       first_short, emb16, shortcuts, oh, ig, gt):
            with self._noise(step_seed):
                tpe = self._temporal_pe(p, bank.length, cap, bank.pos)
                long_mem, short_mem = memories(bank, short)
                inters, mems, _ = lstt(p, emb16, long_mem, short_mem, None,
                                       tpe)
                logits = decode(p, inters, shortcuts)
                loss = self._frame_loss(logits, gt, obj_nums, step,
                                        input_size)
                pred_mask = predict(logits)
                iou = batched_iou(pred_mask, gt, obj_nums, cfg.max_obj_num)
                # the memory takes the GT identities, or the prediction
                # with use_prev_pred (reference aot_engine.py:91-99)
                if use_prev_pred:
                    oh, ig = (x.to(oh.dtype) for x in one_hot_mask(
                        pred_mask, cfg.max_obj_num))
                id_emb = self._id_emb(p, oh, ig, shuffle,
                                      freeze_id=use_prev_pred)
                per_layer = []
                for m in mems:
                    keep = ('curr_k', 'curr_v') + (
                        ('curr_id_v',) if cfg.vos == 'deaot'
                        else ('local_k', 'local_v'))
                    per_layer.append({key: m[key] for key in keep})
                fused = self._call(p, 'fuse_memory_values', per_layer,
                                   id_emb)
                fstack = lambda key: [f[key] for f in fused]
                short = membank.push_short_term_functional(
                    short, fstack('short_k'), fstack('short_v'),
                    fstack('short_id_v') if with_id else None)
                if do_long:
                    bank = membank.append_frame_functional(
                        bank, fstack('long_k'), fstack('long_v'),
                        fstack('long_id_v') if with_id else None, t_idx)
                    bank = membank.evict_frame_functional(
                        bank, membank.default_drop_index(
                            bank, cfg.former_mem_len, cfg.gru_memory),
                        enabled=bank.length > budget)
                # REVERSE_INFER (reference aot_engine.py:371-396): after a
                # long write, segment the reference frame again against
                # the latter memory (logical slot 0 masked) and the frame-1
                # short memory, captured detached (the reference's
                # first_short_memories .detach().clone()). AOT only: the
                # reference's DualBranchGPM ignores outer memories
                # (transformer.py:765-798), so DeAOT's reverse pass is
                # broken upstream and not reproduced.
                rev_loss = torch.zeros_like(loss)
                if reverse and t_idx == 1:
                    first_short = membank.ShortTermMemory(
                        k=[x.detach() for x in short.k],
                        v=[x.detach() for x in short.v], id_v=None,
                        count=short.count)
                if rev_gate:
                    outer_valid = bank.slot_valid & (bank.pos != 0)
                    tpe_r = self._temporal_pe(
                        p, (bank.length - 1).clamp_min(1), cap,
                        pos=torch.where(bank.pos >= 1, bank.pos - 1, -1))
                    k0, v0, _ = first_short.read()
                    inters_r, _, _ = lstt(p, xs[-1][:, 0],
                                          (bank.k, bank.v, outer_valid),
                                          (k0, v0), None, tpe_r)
                    rev_loss = cfg.reverse_loss * self._frame_loss(
                        decode(p, inters_r, frame_xs(0)), masks[:, 0],
                        obj_nums, step, input_size)
            return bank, short, first_short, loss, rev_loss, iou, pred_mask

        frame_losses, rev_losses, frame_ious = [], [], []
        n_fired = 0
        first_short = None
        pred_mask = pred0
        last_mem_step = 0
        for t_idx in range(1, t_total):
            do_long = t_idx - last_mem_step >= self.gap and \
                not cfg.no_long_memory
            # fires on every long write but one after the last frame (the
            # reference's loop updates the memory T-2 times)
            rev_gate = reverse and do_long and t_idx < t_total - 1
            args = (params, seed(), t_idx, do_long, rev_gate, bank, short,
                    first_short, xs[-1][:, t_idx], frame_xs(t_idx),
                    one_hot_all[:, t_idx], ignore_all[:, t_idx],
                    masks[:, t_idx])
            out = (checkpoint(frame_step, *args, use_reentrant=False)
                   if self.remat else frame_step(*args))
            bank, short, first_short, loss, rev_loss, iou, pred_mask = out
            frame_losses.append(loss)
            rev_losses.append(rev_loss)
            frame_ious.append(iou)
            n_fired += int(rev_gate)
            if do_long:
                last_mem_step = t_idx

        # --- aggregation (reference aot_engine.py:108-113): the aux weight
        # falls linearly to 0 over train_aux_loss_ratio of training; each
        # reverse loss joins the prediction losses as one more entry
        f32 = lambda x: torch.tensor(float(x), dtype=torch.float32)
        aux_step = f32(exp.train_total_steps * exp.train_aux_loss_ratio
                       + 1e-5)
        aux_w = float(f32(exp.train_aux_loss_weight)
                      * torch.clamp(aux_step - f32(step), min=0.0)
                      / aux_step)
        losses = (torch.stack(frame_losses) if frame_losses
                  else torch.zeros((0, b), device=dev))
        n_entries = losses.numel() + n_fired * b
        pred_loss = (losses.sum() + sum(r.sum() for r in rev_losses)
                     ) / max(n_entries, 1)
        total = aux_w * aux_loss.mean() + pred_loss
        all_ious = torch.stack([iou0] + frame_ious)
        aux = {
            'aux_loss': aux_loss.mean(),
            'pred_loss': pred_loss,
            'frame_losses': losses.mean(dim=-1),
            'frame_ious': all_ious,
            'iou': all_ious.mean(),
            'final_pred_mask': pred_mask,
        }
        if var_loss is not None:
            total = total + cfg.var_loss_weight * var_loss
            aux['var_loss'] = var_loss
        if self.bns:
            aux['batch_stats'] = {name: m.pending
                                  for name, m in self.bns.items()}
        return total, aux
