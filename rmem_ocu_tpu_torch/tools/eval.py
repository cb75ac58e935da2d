"""Evaluation CLI of the port.

Counterpart of the JAX package's `tools/eval.py` (reference
aot_plus/tools/eval.py): the same arguments and the same output layout,
plus `--device`. Runs on the card unless `--device cpu` is given.

Example:
    python -m rmem_ocu_tpu_torch.tools.eval --stage pre_vost_2 \
        --model r50_deaotl --dataset vost --data_root ./datasets/VOST \
        --ckpt_path model.pth

Checkpoints: a reference `.pth`, or the `step_<N>` directories that the
port's train CLI writes (`ckpt/`, `ema_ckpt/`).
"""
from __future__ import annotations

import argparse
import os
from dataclasses import replace

from rmem_ocu_tpu_torch.utils import checkpoint as ckpt


def parse_args():
    p = argparse.ArgumentParser(description='Evaluate VOS (PyTorch port)')
    p.add_argument('--exp_name', type=str, default='default')
    p.add_argument('--stage', type=str, default='pre_vost_2')
    p.add_argument('--model', type=str, default='r50_deaotl')
    p.add_argument('--dataset', type=str, default=None,
                   choices=['davis2016', 'davis2017', 'youtubevos', 'vost',
                            'long_videos', 'test'],
                   help='defaults to exp.test_dataset')
    p.add_argument('--split', type=str, default=None,
                   help='defaults to exp.test_dataset_split')
    p.add_argument('--data_root', type=str, default=None)
    p.add_argument('--ckpt_path', type=str, default=None,
                   help="a .pth file (a reference checkpoint or a step's "
                        "file) or a directory of the port's step_<N> "
                        'checkpoints (the train CLI\'s ckpt/ or ema_ckpt/); '
                        "defaults to the experiment's ema_ckpt/ or ckpt/")
    p.add_argument('--ckpt_step', type=int, default=None,
                   help='step to load from a step_<N> checkpoint directory '
                        '(reference TEST_CKPT_STEP); the newest by default')
    p.add_argument('--no_ema', action='store_true',
                   help='load raw train params instead of EMA weights '
                        '(reference TEST_EMA=False)')
    p.add_argument('--aggregation', type=str, default=None,
                   choices=['soft', 'min'],
                   help='multi-group logit merge (reference soft/min '
                        'aggregation, aot_engine.py:630-673); defaults to '
                        'exp.test_aggregation')
    p.add_argument('--output', type=str, default=None)
    p.add_argument('--max_size', type=float, default=None,
                   help='defaults to exp.test_max_size')
    p.add_argument('--flip', action='store_true',
                   help='also exp.test_flip enables it')
    p.add_argument('--ms', nargs='+', type=float, default=None,
                   help='defaults to exp.test_multiscale')
    p.add_argument('--former_mem_len', type=int, default=None)
    p.add_argument('--latter_mem_len', type=int, default=None)
    p.add_argument('--vanilla', action='store_true',
                   help='RMem-off configuration (no temporal memory PE), '
                        'for the reference-published vanilla checkpoints')
    p.add_argument('--gap', type=int, default=None,
                   help='pin the long-term write gap; default is the '
                        "reference's per-sequence adaptive "
                        'max(round(frames/30), 5) (evaluator.py:331-335)')
    p.add_argument('--full_resolution', action='store_true',
                   help='DAVIS Full-Resolution image root instead of 480p '
                        '(reference TEST_DATASET_FULL_RESOLUTION); also '
                        'exp.test_dataset_full_resolution enables it')
    p.add_argument('--frame_log', action='store_true',
                   help='print per-frame latency (reference TEST_FRAME_LOG)')
    p.add_argument('--probe', action='store_true',
                   help='print first-7-channel logits at a fixed pixel each '
                        'frame, after aggregation and before flip-back, '
                        'for run-to-run determinism comparison (reference '
                        '--debug_fix_random, evaluator.py:424)')
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 weights and activations')
    p.add_argument('--oracle', action='store_true',
                   help='VOST oracle mode: GT label per frame conditions '
                        'the mask encoder (reference ORACLE flag); needs '
                        'the TopDown encoder')
    p.add_argument('--no_config_reload', action='store_true',
                   help='ignore the training config.json snapshot '
                        '(reference eval.py:97-102 prefers the snapshot)')
    p.add_argument('--mesh', type=int, default=0,
                   help='model-parallel serving over N devices; the port '
                        'runs on one device (0/1)')
    p.add_argument('--device', type=str, default=None,
                   help="torch device; the card by default, 'cpu' only "
                        'when asked')
    return p.parse_args()


def main():
    args = parse_args()
    import torch
    from rmem_ocu_tpu_torch.config import get_config
    from rmem_ocu_tpu_torch.models import build_vos_model

    if args.mesh and args.mesh > 1:
        raise SystemExit(f'--mesh {args.mesh}: model-parallel serving is '
                         f'not ported yet (ROADMAP item 15)')
    exp = get_config(args.stage, args.exp_name, args.model)
    # prefer the training run's saved config snapshot, like the reference
    # (tools/eval.py:97-102 re-imports result_path/config.py)
    snap = os.path.join(exp.dir_result(), 'config.json')
    if not args.no_config_reload and os.path.isfile(snap):
        import json
        from rmem_ocu_tpu_torch.config import config_from_dict
        with open(snap) as f:
            exp = config_from_dict(json.load(f))
        print(f'reloaded config snapshot {snap}')
    if args.bf16:
        exp = replace(exp, compute_dtype='bfloat16')
    model_overrides = {}
    if args.oracle:
        model_overrides['oracle'] = True
    if args.vanilla:
        model_overrides['use_temporal_pe'] = False
    if args.former_mem_len is not None:
        model_overrides['former_mem_len'] = args.former_mem_len
    if args.latter_mem_len is not None:
        model_overrides['latter_mem_len'] = args.latter_mem_len
    if model_overrides:
        exp = replace(exp, model=replace(exp.model, **model_overrides))
    if args.gap is not None:
        exp = replace(exp, test_long_term_mem_gap=args.gap,
                      test_fixed_mem_gap=True)
    if args.no_ema:
        exp = replace(exp, test_ema=False)
    if args.aggregation is not None:
        exp = replace(exp, test_aggregation=args.aggregation)

    if args.dataset is None:
        args.dataset = exp.test_dataset
    if args.split is None:
        args.split = exp.test_dataset_split

    cfg = exp.model
    model = build_vos_model(cfg, device=args.device)
    load_checkpoint(args, exp, model)
    if args.bf16:
        model = model.to(torch.bfloat16)

    output = args.output or os.path.join(exp.dir_result(), 'eval',
                                         args.dataset)
    if args.output is None and args.dataset in ('davis2016', 'davis2017'):
        # keep 480p and Full-Resolution results apart, like the
        # reference's 'Annotations/<resolution>' result_root segment
        output = os.path.join(
            output, 'Full-Resolution'
            if (args.full_resolution or exp.test_dataset_full_resolution)
            else '480p')
    os.makedirs(output, exist_ok=True)
    from rmem_ocu_tpu_torch.utils.run_utils import Tee
    tee = Tee(os.path.join(output, 'print.log'))
    try:
        _evaluate(args, exp, model, output)
    finally:
        tee.close()


def load_checkpoint(args, exp, model) -> None:
    """Checkpoint selection (reference evaluator.py:59-110, the JAX CLI's
    tools/eval.py:150-185): an explicit path wins, else the experiment's
    ema_ckpt/ (or ckpt/ without test_ema) when it holds steps. A `.pth`
    loads as a reference checkpoint; a directory of step_<N> checkpoints
    gives the requested (or newest) step, from which a train state gives
    its EMA under test_ema and its model weights otherwise."""
    ckpt_path = args.ckpt_path or exp.test_ckpt_path
    if not ckpt_path:
        sub = 'ema_ckpt' if exp.test_ema else 'ckpt'
        candidate = os.path.join(exp.dir_result(), sub)
        if ckpt.list_checkpoint_steps(candidate):
            ckpt_path = candidate
    if not ckpt_path:
        print('warning: no checkpoint found; evaluating random init')
        return
    if ckpt_path.endswith('.pth'):
        ckpt.load_torch_pretrained(ckpt_path, model)
        print(f'loaded {ckpt_path}')
        return
    step = (args.ckpt_step if args.ckpt_step is not None
            else exp.test_ckpt_step)
    try:
        state, step = ckpt.restore_checkpoint(ckpt_path, step=step)
    except FileNotFoundError as e:
        raise SystemExit(
            f'{e}: the port reads only its own step_<N> directories '
            f'(rmem_ocu_tpu_torch.tools.train) and .pth files, not the JAX '
            f"package's Orbax checkpoints") from e
    if state is None:
        raise SystemExit(f'no step_<N> checkpoints in {ckpt_path}')
    # the dir may hold full train states (ckpt/) or bare weights
    # (ema_ckpt/); duck-type both, loudly
    if isinstance(state, dict) and 'ema' in state and 'state_dict' in state:
        which = 'ema' if exp.test_ema else 'state_dict'
        weights = state[which]
    elif isinstance(state, dict) and 'state_dict' in state:
        which, weights = 'state_dict', state['state_dict']
    else:
        keys = (list(state.keys()) if isinstance(state, dict)
                else type(state).__name__)
        raise SystemExit(
            f'{ckpt_path} step {step} is not a train state or weights '
            f'(found {keys}); point --ckpt_path at a train ckpt/ or '
            f'ema_ckpt/ directory')
    ckpt.load_state_dict(weights, model)
    print(f'loaded {which} from step {step} ({ckpt_path})')


def _evaluate(args, exp, model, output):
    from rmem_ocu_tpu_torch.data import eval_datasets as ds
    from rmem_ocu_tpu_torch.eval.evaluator import Evaluator
    cfg = exp.model
    # CLI overrides win; otherwise the config's TEST_* fields apply
    # (reference tools/eval.py:108-135)
    seq_kw = dict(
        max_size=(args.max_size if args.max_size is not None
                  else exp.test_max_size),
        min_size=exp.test_min_size,
        align_corners=cfg.align_corners,
        multi_scale=(tuple(args.ms) if args.ms is not None
                     else tuple(exp.test_multiscale)),
        flip=args.flip or exp.test_flip)
    root = args.data_root or exp.dir_data
    if args.dataset in ('davis2016', 'davis2017'):
        year = 2016 if args.dataset == 'davis2016' else 2017
        full_res = (args.full_resolution
                    or exp.test_dataset_full_resolution)
        dataset = ds.build_davis_dataset(root, args.split, year,
                                         full_res=full_res,
                                         result_root=output, **seq_kw)
    elif args.dataset == 'vost':
        dataset = ds.build_vost_dataset(root, args.split, oracle=args.oracle,
                                        result_root=output, **seq_kw)
    elif args.dataset == 'youtubevos':
        # the dense every-frame split is selected by the '_all_frames'
        # suffix of the split (reference evaluator.py:145-147)
        split = args.split
        all_frames = '_all_frames' in split
        if all_frames:
            split = split.replace('_all_frames', '')
        dataset = ds.build_youtubevos_dataset(root, split=split,
                                              all_frames=all_frames,
                                              result_root=output, **seq_kw)
    elif args.dataset == 'long_videos':
        dataset = ds.build_long_videos_dataset(root, result_root=output,
                                               **seq_kw)
    else:
        dataset = ds.build_synthetic_dataset(num_seqs=2)

    ev = Evaluator(model, exp, output, frame_log=args.frame_log,
                   probe=args.probe)
    stats = ev.evaluate(dataset)
    print(f'done: {stats.total_frames} frames, '
          f'p50 {stats.p50_latency_ms:.1f}ms, '
          f'max mem {stats.max_mem_mb:.0f}MB, results in {output}')


if __name__ == '__main__':
    main()
