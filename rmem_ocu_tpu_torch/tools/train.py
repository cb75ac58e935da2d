"""Training CLI of the port.

Counterpart of the JAX package's `tools/train.py` (reference
aot_plus/tools/train.py): the same arguments, the same result directory
(`print.log`, `code_snapshot/`, `config.json`, `metrics.jsonl`, `ckpt/`
and `ema_ckpt/` of `step_<N>` checkpoints), plus `--device`. One process
trains on one device, the card unless `--device cpu` is given; the device
mesh, ZeRO-1 and multi-host training wait for ROADMAP item 15.

Example:
    python -m rmem_ocu_tpu_torch.tools.train --stage pre_vost \
        --model r50_deaotl --exp_name rmem --batch_size 8
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

from rmem_ocu_tpu_torch.config import config_to_dict, get_config
from rmem_ocu_tpu_torch.data.eval_datasets import IMAGENET_MEAN, IMAGENET_STD
from rmem_ocu_tpu_torch.data.train_datasets import (TrainDataLoader,
                                                    build_train_dataset)
from rmem_ocu_tpu_torch.engine.train_engine import check_port_knobs
from rmem_ocu_tpu_torch.models import build_vos_model
from rmem_ocu_tpu_torch.ops.masks import label2colormap
from rmem_ocu_tpu_torch.train.trainer import Trainer
from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
from rmem_ocu_tpu_torch.utils.device import resolve_device
from rmem_ocu_tpu_torch.utils.run_utils import Tee, copy_codes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train VOS (PyTorch port)')
    p.add_argument('--exp_name', type=str, default='default')
    p.add_argument('--stage', type=str, default='pre_vost')
    p.add_argument('--model', type=str, default='r50_deaotl')
    p.add_argument('--batch_size', type=int, default=None)
    p.add_argument('--total_steps', type=int, default=None)
    p.add_argument('--lr', type=float, default=None)
    p.add_argument('--datasets', nargs='+', default=None)
    p.add_argument('--data_root', type=str, default=None)
    p.add_argument('--pretrained_path', type=str, default=None)
    p.add_argument('--log_step', type=int, default=None)
    p.add_argument('--save_step', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--crop_size', type=int, default=None)
    p.add_argument('--seq_len', type=int, default=None,
                   help='training episode length (reference --seq_len / '
                        'DATA_SEQ_LEN; the notebook fine-tune recipe uses '
                        '5)')
    p.add_argument('--mem_gap', type=int, default=None,
                   help='train long-term memory write gap (reference '
                        'TRAIN_LONG_TERM_MEM_GAP)')
    p.add_argument('--freeze_at', type=int, default=None,
                   help='encoder stage freezing (reference FREEZE_AT / '
                        'encoders freeze(freeze_at)); 0 trains the whole '
                        'encoder — required when training from scratch, '
                        'where freezing would pin a random stem')
    p.add_argument('--no_freeze_bn', action='store_true',
                   help='train encoder BatchNorm statistics (reference '
                        'MODEL_FREEZE_BN=False); the default frozen BN '
                        'assumes an ImageNet-pretrained encoder and is an '
                        'identity affine at random init')
    p.add_argument('--fix_random', action='store_true',
                   help='deterministic seeding of python/numpy/torch '
                        '(reference tools/train.py:20-37: seed = 1 << '
                        'rank); overrides --seed')
    p.add_argument('--tblog', action='store_true',
                   help='TensorBoard scalar + pred/GT image logging '
                        '(reference trainer.py:687-804); needs '
                        'tensorboardX')
    p.add_argument('--mesh', type=str, default=None,
                   help='device mesh as DATAxMODEL; the port trains on one '
                        'device (1), the mesh waits for ROADMAP item 15')
    p.add_argument('--zero1', action='store_true',
                   help='ZeRO stage 1; waits for ROADMAP item 15')
    p.add_argument('--multihost', action='store_true',
                   help='one process per host; waits for ROADMAP item 15')
    p.add_argument('--amp', action='store_true',
                   help='mixed-precision training: bf16 forward/backward, '
                        'fp32 params/optimizer (reference --amp autocast + '
                        'GradScaler, trainer.py:170-176; no loss scaling '
                        'needed for bf16)')
    p.add_argument('--enc_chunk', type=int, default=0,
                   help="the JAX package's chunked encoder pass; the port "
                        'takes only 0 (engine/train_engine.py:'
                        'check_port_knobs)')
    p.add_argument('--remat', type=str, default=None,
                   choices=['full', 'dots', 'none'],
                   help='episode rematerialization: full = recompute each '
                        'frame step in backward (torch.utils.checkpoint), '
                        "none = save everything; 'dots' is an XLA policy "
                        'the port does not take')
    p.add_argument('--device', type=str, default=None,
                   help="torch device; the card by default, 'cpu' only "
                        'when asked')
    return p.parse_args(argv)


def _fix_random() -> int:
    """The determinism harness of the JAX CLI (tools/train.py:127-146, after
    the reference's tools/train.py:20-37) on rank 0: python and numpy take
    seeds from 1 << rank, and the run's --seed becomes 4."""
    import random
    seed = 1 << 0
    print(f'[0] fix random seed {seed}')
    os.environ['PYTHONHASHSEED'] = str(seed)
    random.seed(seed + 1)
    np.random.seed(seed + 2)
    return 4


def _exp_from_args(args):
    exp = get_config(args.stage, args.exp_name, args.model)
    overrides = {}
    for flag, field in (('batch_size', 'train_batch_size'),
                        ('total_steps', 'train_total_steps'),
                        ('lr', 'train_lr'), ('data_root', 'dir_data'),
                        ('pretrained_path', 'pretrain_model'),
                        ('log_step', 'train_log_step'),
                        ('save_step', 'train_save_step'),
                        ('seq_len', 'data_seq_len'),
                        ('mem_gap', 'train_long_term_mem_gap'),
                        ('enc_chunk', 'train_encoder_chunk'),
                        ('remat', 'train_remat_policy')):
        if getattr(args, flag):
            overrides[field] = getattr(args, flag)
    if args.datasets:
        overrides['datasets'] = tuple(args.datasets)
    if args.crop_size:
        overrides['data_randomcrop'] = (args.crop_size, args.crop_size)
    if args.freeze_at is not None:
        overrides['train_encoder_freeze_at'] = args.freeze_at
    if args.no_freeze_bn:
        exp = replace(exp, model=replace(exp.model, freeze_bn=False))
    if args.tblog:
        overrides['train_tblog'] = True
    if args.amp:
        overrides['train_amp'] = True
    return replace(exp, **overrides) if overrides else exp


def _tb_log_images(tb, step: int, batch, metrics):
    """Pred/GT overlay image logs for the episode's final frame
    (reference trainer.py:712-761)."""
    img = np.asarray(batch['frames'][0, -1])
    img = np.clip((img * IMAGENET_STD + IMAGENET_MEAN) * 255, 0,
                  255).astype(np.uint8)
    gt = np.asarray(batch['masks'][0, -1]).astype(np.uint8)
    pred = metrics['pred_mask'][0].cpu().numpy().astype(np.uint8)
    if pred.shape != gt.shape:           # pred is at 4x decoder resolution
        from PIL import Image
        pred = np.asarray(Image.fromarray(pred).resize(
            (gt.shape[1], gt.shape[0]), Image.NEAREST))

    def overlay(mask):
        return (0.5 * img + 0.5 * label2colormap(mask)).astype(np.uint8)

    tb.add_image('train/image', img, step, dataformats='HWC')
    tb.add_image('train/gt_overlay', overlay(gt), step, dataformats='HWC')
    tb.add_image('train/pred_overlay', overlay(pred), step,
                 dataformats='HWC')


def metrics_row(step: int, metrics: dict, it_per_s: float) -> dict:
    """A metrics.jsonl row under the JAX CLI's keys (iou in percent),
    values unrounded."""
    row = {'step': step,
           'loss': float(metrics['loss']),
           'aux_loss': float(metrics['aux_loss']),
           'pred_loss': float(metrics['pred_loss']),
           'iou': float(metrics['iou']) * 100,
           'lr': float(metrics['lr']),
           'grad_norm': float(metrics['grad_norm']),
           # per-frame-position meters (reference trainer.py:577-595,
           # 619-635)
           'frame_losses': [float(v) for v in metrics['frame_losses']],
           'frame_ious': [float(v) * 100 for v in metrics['frame_ious']],
           'it_per_s': it_per_s}
    if 'var_loss' in metrics:
        row['var_loss'] = float(metrics['var_loss'])
    return row


def main(argv=None):
    args = parse_args(argv)
    if args.mesh and any(int(d) != 1 for d in args.mesh.lower().split('x')):
        raise SystemExit(f'--mesh {args.mesh}: the port trains on one '
                         f'device; the mesh waits for ROADMAP item 15')
    if args.zero1 or args.multihost:
        raise SystemExit('--zero1 and --multihost wait for ROADMAP item 15 '
                         '(multi-GPU); the port trains on one device')
    if args.fix_random:
        args.seed = _fix_random()
    exp = _exp_from_args(args)
    check_port_knobs(exp)
    device = resolve_device(args.device)

    result_dir = exp.dir_result()
    for sub in ('ckpt', 'ema_ckpt'):
        os.makedirs(os.path.join(result_dir, sub), exist_ok=True)
    # stdout tee + source snapshot (reference tools/train.py:40-41, 78-79)
    # and the reloadable config snapshot (reference cfg.save_self())
    tee = Tee(os.path.join(result_dir, 'print.log'))
    try:
        copy_codes(result_dir)
        with open(os.path.join(result_dir, 'config.json'), 'w') as f:
            json.dump(config_to_dict(exp), f, indent=2)
        _train(args, exp, device, result_dir)
    finally:
        tee.close()


def _train(args, exp, device, result_dir):
    ckpt_dir = os.path.join(result_dir, 'ckpt')
    ema_dir = os.path.join(result_dir, 'ema_ckpt')
    loader = TrainDataLoader(build_train_dataset(exp), exp.train_batch_size,
                             seed=args.seed, num_workers=exp.data_workers)
    data_iter = iter(loader)
    batch = next(data_iter)

    # the model's init draws from --seed, the episodes' randomness from
    # --seed + 1 (the JAX CLI's PRNGKey(seed) and PRNGKey(seed + 1))
    model = build_vos_model(exp.model, device=device, seed=args.seed,
                            exp=exp)
    trainer = Trainer(model, exp)
    state = trainer.init_state()

    # pretrained / resume (reference trainer.py:186-284)
    restored, step0 = (ckpt.restore_checkpoint(ckpt_dir,
                                               trainer.state_dict(state))
                       if exp.train_auto_resume else (None, None))
    if restored is not None:
        state = trainer.load_state_dict(restored)
        print(f'resumed from step {step0}')
    else:
        # stage chaining composes both: load the previous stage's weights
        # and offset the schedule (reference trainer.py:189, 266-284)
        if exp.pretrain and exp.pretrain_model:
            ckpt.load_torch_pretrained(exp.pretrain_model, model)
            state = trainer.restart_ema(state)
            print(f'loaded pretrained {exp.pretrain_model}')
        if exp.train_start_step > 0:
            state = replace(state, step=exp.train_start_step)
            print(f'starting from step {exp.train_start_step}')

    generator = torch.Generator().manual_seed(args.seed + 1)
    metrics_path = os.path.join(result_dir, 'metrics.jsonl')
    tb = None
    if exp.train_tblog:
        # reference trainer.py:181-184 (tensorboardX SummaryWriter)
        from tensorboardX import SummaryWriter
        tb = SummaryWriter(os.path.join(result_dir, 'tblogs'))
    log_t0 = time.time()
    step = state.step
    while step < exp.train_total_steps:
        on_device = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
        state, metrics = trainer.train_step(state, on_device, generator)
        # the next batch loads after the step is dispatched, as in the JAX
        # CLI (nothing is prefetched)
        batch_used, batch = batch, next(data_iter)
        step = state.step
        if step % exp.train_log_step == 0:
            dt = time.time() - log_t0
            log_t0 = time.time()
            row = metrics_row(step, metrics, exp.train_log_step
                              / max(dt, 1e-9))
            print(f'step {step}/{exp.train_total_steps} '
                  f'loss {row["loss"]:.4f} iou {row["iou"]:.1f} '
                  f'lr {row["lr"]:.2e} ({row["it_per_s"]:.2f} it/s)',
                  flush=True)
            with open(metrics_path, 'a') as f:
                f.write(json.dumps(row) + '\n')
            if tb is not None:
                # scalar logging (reference trainer.py:763-775)
                for k in ('loss', 'aux_loss', 'pred_loss', 'iou', 'lr',
                          'grad_norm'):
                    tb.add_scalar(f'train/{k}', row[k], step)
                for i, v in enumerate(row['frame_ious']):
                    tb.add_scalar(f'train/iou_frame_{i}', v, step)
        if tb is not None and step % exp.train_img_log_step == 0:
            _tb_log_images(tb, step, batch_used, metrics)
        if step % exp.train_save_step == 0:
            ckpt.save_checkpoint(ckpt_dir, step, trainer.state_dict(state),
                                 exp.train_max_keep_ckpt)
            # EMA weights in a parallel dir (reference trainer.py:659-676)
            ckpt.save_checkpoint(ema_dir, step, {'state_dict': state.ema},
                                 exp.train_max_keep_ckpt)
            print(f'saved step {step}')
    if tb is not None:
        tb.close()


if __name__ == '__main__':
    main()
