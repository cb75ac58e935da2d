"""One-command train -> eval -> score pipeline of the port.

Counterpart of the JAX package's `tools/pipeline.py` (reference
aot_plus/train_vost.sh:18-79 chains tools/train.py, tools/eval.py and
evaluation/evaluation_method.py). The three stages run in-process,
forwarding the shared flags and `--device`.

`--data_root` means two directories, as in the JAX package: training
reads `<data_root>/VOST/{JPEGImages,Annotations,ImageSets/train.txt}`
(the train datasets live under their own names in `dir_data`), while eval
and the scorer read `<data_root>/{JPEGImages_10fps,Annotations,
ImageSets/val.txt}`.

Example:
    python -m rmem_ocu_tpu_torch.tools.pipeline --stage pre_vost_2 \
        --model r50_deaotl --dataset vost --data_root ./datasets \
        --total_steps 20000 --batch_size 8
"""
from __future__ import annotations

import argparse
import os
import sys

from rmem_ocu_tpu_torch.config import get_config
from rmem_ocu_tpu_torch.eval import scorer
from rmem_ocu_tpu_torch.tools import eval as eval_tool
from rmem_ocu_tpu_torch.tools import train as train_tool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='train -> eval -> score')
    p.add_argument('--exp_name', type=str, default='default')
    p.add_argument('--stage', type=str, default='pre_vost_2')
    p.add_argument('--model', type=str, default='r50_deaotl')
    p.add_argument('--dataset', type=str, default='vost')
    p.add_argument('--split', type=str, default='val')
    p.add_argument('--data_root', type=str, default=None,
                   help='train + eval dataset root (see the module doc)')
    p.add_argument('--batch_size', type=int, default=None)
    p.add_argument('--total_steps', type=int, default=None)
    p.add_argument('--pretrained_path', type=str, default=None)
    p.add_argument('--crop_size', type=int, default=None)
    p.add_argument('--save_step', type=int, default=None)
    p.add_argument('--max_size', type=float, default=None)
    p.add_argument('--flip', action='store_true')
    p.add_argument('--ms', nargs='+', type=float, default=[1.0])
    p.add_argument('--skip_train', action='store_true')
    p.add_argument('--skip_eval', action='store_true')
    p.add_argument('--device', type=str, default=None,
                   help="torch device of both legs; the card by default, "
                        "'cpu' only when asked")
    return p.parse_args(argv)


def _run(module_main, argv):
    """Run a tool's main() under a substitute sys.argv."""
    old = sys.argv
    sys.argv = argv
    try:
        module_main()
    finally:
        sys.argv = old


def main(argv=None):
    args = parse_args(argv)
    exp = get_config(args.stage, args.exp_name, args.model)
    result_dir = exp.dir_result()
    output = os.path.join(result_dir, 'eval', args.dataset)
    device = ['--device', args.device] if args.device else []

    if not args.skip_train:
        argv = ['train', '--exp_name', args.exp_name, '--stage', args.stage,
                '--model', args.model] + device
        for flag in ('data_root', 'batch_size', 'total_steps',
                     'pretrained_path', 'crop_size', 'save_step'):
            if getattr(args, flag):
                argv += [f'--{flag}', str(getattr(args, flag))]
        if args.dataset in ('vost', 'test'):
            argv += ['--datasets', args.dataset]
        _run(train_tool.main, argv)

    if not args.skip_eval:
        argv = ['eval', '--exp_name', args.exp_name, '--stage', args.stage,
                '--model', args.model, '--dataset', args.dataset,
                '--split', args.split, '--output', output,
                '--ckpt_path', os.path.join(result_dir, 'ckpt'),
                '--ms'] + [str(m) for m in args.ms] + device
        if args.data_root:
            argv += ['--data_root', args.data_root]
        if args.flip:
            argv += ['--flip']
        if args.max_size:
            argv += ['--max_size', str(args.max_size)]
        _run(eval_tool.main, argv)

    # score (reference train_vost.sh:77-79 -> evaluation_method.py)
    if args.dataset in ('vost', 'long_videos', 'davis2017', 'davis2016'):
        csv = scorer.score_results(
            results_path=output,
            dataset_root=args.data_root or exp.dir_data,
            split=args.split)
        print(f'pipeline done: scores in {csv}')
    else:
        print(f'pipeline done: results in {output} (no scorer for '
              f'{args.dataset})')


if __name__ == '__main__':
    main()
