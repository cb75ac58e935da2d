"""Training CLI of the port.

Counterpart of the JAX package's `tools/train.py` (reference
aot_plus/tools/train.py): the same arguments, the same result directory
(`print.log`, `code_snapshot/`, `config.json`, `metrics.jsonl`, `ckpt/`
and `ema_ckpt/` of `step_<N>` checkpoints), plus `--device`. One process
trains on one device, the card unless `--device cpu` is given.

Data-parallel training runs one process per card under torchrun, with
`--multihost --mesh N` (N the number of processes) and, optionally,
`--zero1`. One port process stands for one JAX host with one device:
`--batch_size` is per process, as `per_host_batch` is in the JAX CLI, and
rank r trains on the samples that host r of a JAX run of the same world
sees. The JAX CLI's `--mesh D` in one process over D local chips has no
exact counterpart here, because torch runs one process per card. Rank 0
writes print.log, config.json, metrics.jsonl, the code snapshot, the
TensorBoard logs and the checkpoints; every rank logs the world's loss.

Tensor parallelism runs `--multihost --mesh DxM` under torchrun with
WORLD_SIZE = D*M: D data ranks of M model ranks each (the JAX package's
('data', 'model') mesh), rank r being data rank r // M and model rank
r % M. The M ranks of a model group load the same batch (the loader's
rank and world are the data rank and D, `--batch_size` is per data rank)
and each holds its shard of the transformer's projections
(parallel/tp.py); `--zero1` splits the moments over the D data ranks on
top. Checkpoints hold the whole model whatever the mesh, and restore at
any mesh. `--backend gloo` runs the group over gloo on CUDA tensors (two
ranks on one card, which NCCL refuses).

Examples:
    python -m rmem_ocu_tpu_torch.tools.train --stage pre_vost \
        --model r50_deaotl --exp_name rmem --batch_size 8
    torchrun --nproc_per_node 8 -m rmem_ocu_tpu_torch.tools.train \
        --multihost --mesh 8 --zero1 --stage pre_vost --model r50_deaotl \
        --exp_name rmem --batch_size 1
    torchrun --nproc_per_node 8 -m rmem_ocu_tpu_torch.tools.train \
        --multihost --mesh 4x2 --zero1 --stage pre_vost --model r50_deaotl \
        --exp_name rmem --batch_size 1
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
from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.train.trainer import Trainer
from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
from rmem_ocu_tpu_torch.utils.device import resolve_device
from rmem_ocu_tpu_torch.utils.run_utils import Tee, copy_codes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train VOS (PyTorch port)')
    p.add_argument('--exp_name', type=str, default='default')
    p.add_argument('--stage', type=str, default='pre_vost')
    p.add_argument('--model', type=str, default='r50_deaotl')
    p.add_argument('--batch_size', type=int, default=None,
                   help='samples a step in each process (per card, as the '
                        "JAX CLI's per-host batch)")
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
                   help='data-parallel processes N, one per card, launched '
                        'by torchrun with --multihost; it must equal '
                        "torchrun's world size. DATAxMODEL: tensor "
                        'parallelism over model groups of MODEL ranks, '
                        "DATA*MODEL = torchrun's world size")
    p.add_argument('--backend', type=str, default=None,
                   choices=['nccl', 'gloo'],
                   help='the process group\'s backend with --multihost; '
                        'NCCL on the card and gloo on the CPU by default')
    p.add_argument('--zero1', action='store_true',
                   help="ZeRO stage 1: the optimizer's moments sharded over "
                        'the data-parallel processes')
    p.add_argument('--multihost', action='store_true',
                   help="form the process group from torchrun's "
                        'environment (RANK, WORLD_SIZE, LOCAL_RANK, '
                        'MASTER_ADDR, MASTER_PORT); each process trains on '
                        'cuda:LOCAL_RANK')
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


def _fix_random(rank: int) -> int:
    """The determinism harness of the JAX CLI (tools/train.py:127-146, after
    the reference's tools/train.py:20-37): python and numpy take seeds from
    1 << rank, and the run's --seed becomes 4 on every rank (the initial
    weights and the loader's permutation must be the same on all)."""
    import random
    seed = 1 << rank
    print(f'[{rank}] fix random seed {seed}')
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


def _mesh_of(args):
    """(data ranks, model ranks) that --mesh and --multihost ask for,
    checked against torchrun's world before any group forms: exits with
    the torchrun line to use."""
    module = 'rmem_ocu_tpu_torch.tools.train'
    world = dist.env_rank_and_size()[1]
    if args.mesh and 'x' in args.mesh.lower():
        d, m = (int(x) for x in args.mesh.lower().split('x'))
        if (not args.multihost or 'WORLD_SIZE' not in os.environ
                or d * m != world):
            raise SystemExit(
                f'--mesh {args.mesh}: torchrun\'s world size is '
                f'{os.environ.get("WORLD_SIZE", "unset")}; tensor-parallel '
                f'training (ROADMAP item 15b) runs one process per card, '
                f'{d * m} of them: '
                f'{dist.torchrun_line(d * m, module, args.mesh)}')
        return d, m
    n = int(args.mesh) if args.mesh else (world if args.multihost else 1)
    if not args.multihost:
        if n > 1 or world > 1:
            raise SystemExit(
                f'--mesh {n} in {world} process(es) without --multihost: '
                f'data-parallel training (ROADMAP item 15a) runs one '
                f'process per card, e.g. '
                f'{dist.torchrun_line(max(n, world), module)}')
        return 1, 1
    if 'WORLD_SIZE' not in os.environ or n != world:
        raise SystemExit(
            f'--multihost --mesh {n}: torchrun\'s world size is '
            f'{os.environ.get("WORLD_SIZE", "unset")}; data-parallel '
            f'training (ROADMAP item 15a) runs one process per card: '
            f'{dist.torchrun_line(n, module)}')
    return n, 1


def main(argv=None):
    args = parse_args(argv)
    n_data, n_model = _mesh_of(args)
    exp = _exp_from_args(args)
    if n_model > 1:
        exp = replace(exp, mesh_shape=(n_data, n_model),
                      mesh_axes=('data', 'model'))
    elif args.mesh:
        exp = replace(exp, mesh_shape=(n_data,), mesh_axes=('data',))
    if args.zero1:
        exp = replace(exp, train_zero1=True)
    check_port_knobs(exp)
    world = (dist.init_from_env(args.device, backend=args.backend,
                                tp=n_model) if args.multihost
             else World(device=resolve_device(args.device)))
    try:
        if args.fix_random:
            # the ranks of a model group seed alike
            args.seed = _fix_random(world.data.rank)
        result_dir = exp.dir_result()
        for sub in ('ckpt', 'ema_ckpt'):
            os.makedirs(os.path.join(result_dir, sub), exist_ok=True)
        # stdout tee + source snapshot (reference tools/train.py:40-41,
        # 78-79) and the reloadable config snapshot (reference
        # cfg.save_self()), on rank 0 only
        tee = (Tee(os.path.join(result_dir, 'print.log')) if world.is_main
               else None)
        try:
            if world.is_main:
                copy_codes(result_dir)
                with open(os.path.join(result_dir, 'config.json'),
                          'w') as f:
                    json.dump(config_to_dict(exp), f, indent=2)
            _train(args, exp, world, result_dir)
        finally:
            if tee is not None:
                tee.close()
    finally:
        dist.destroy(world)


def _train(args, exp, world, result_dir):
    device = world.device
    ckpt_dir = os.path.join(result_dir, 'ckpt')
    ema_dir = os.path.join(result_dir, 'ema_ckpt')
    # the ranks of a model group load the same batch
    loader = TrainDataLoader(build_train_dataset(exp), exp.train_batch_size,
                             seed=args.seed, rank=world.data.rank,
                             world=world.data.size,
                             num_workers=exp.data_workers)
    data_iter = iter(loader)
    batch = next(data_iter)

    # the model's init draws from --seed, the episodes' randomness from
    # --seed + 1 (the JAX CLI's PRNGKey(seed) and PRNGKey(seed + 1)), the
    # same on every rank; init_state broadcasts rank 0's weights all the
    # same. Under tensor parallelism the trainer cuts the model into the
    # rank's shard
    model = build_vos_model(exp.model, device=device, seed=args.seed,
                            exp=exp)
    trainer = Trainer(model, exp, world)
    state = trainer.init_state()

    # pretrained / resume (reference trainer.py:186-284), on every rank
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
    if exp.train_tblog and world.is_main:
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
            if world.is_main:
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
            # collective: every rank gathers and saves, rank 0 writes
            ckpt.save_checkpoint(ckpt_dir, step, trainer.state_dict(state),
                                 exp.train_max_keep_ckpt, world=world)
            # EMA weights in a parallel dir (reference trainer.py:659-676)
            ckpt.save_checkpoint(ema_dir, step,
                                 {'state_dict': trainer.ema_state_dict(state)},
                                 exp.train_max_keep_ckpt, world=world)
            if world.is_main:
                print(f'saved step {step}')
    if tb is not None:
        tb.close()


if __name__ == '__main__':
    main()
