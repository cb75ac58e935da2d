"""Turnkey accuracy acceptance: ckpt + data root -> J / J_tr + delta vs
the reference's published VOST table.

One command replaces the reference's eval half of train_vost.sh:63-79
(eval.py -> evaluation_method.py -> CSVs -> hand-comparison against
README.md:50-53):

    python -m rmem_ocu_tpu_torch.tools.accept \
        --ckpt pretrain_models/deaot_rmem.pth --vost_root datasets/VOST

The port's counterpart of the JAX package's `tools/accept.py`, plus
`--device`. It loads a reference .pth (or a `step_<N>` directory of the
port's train CLI), evaluates the VOST val split, scores the saved masks
(J mean + J_last == VOST's J_tr, the final-25% tracked metric;
eval/scorer.py), prints both in the table's percent units, and diffs
against the published row for the model/variant. Exit code 0 iff
scoring completed (the printed deltas are the acceptance evidence;
thresholds are the caller's policy).
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

from rmem_ocu_tpu_torch.config import get_config
from rmem_ocu_tpu_torch.eval.scorer import score_results
from rmem_ocu_tpu_torch.tools import eval as eval_cli

# Reference README.md:50-53 — VOST val, (J_tr, J) in percent.
PUBLISHED = {
    ('r50_aotl', 'vanilla'): (37.0, 49.2),
    ('r50_deaotl', 'vanilla'): (37.6, 51.0),
    ('r50_aotl', 'rmem'): (39.8, 50.5),
    ('r50_deaotl', 'rmem'): (40.4, 51.8),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Evaluate a checkpoint on VOST and diff J/J_tr '
                    'against the reference-published table')
    p.add_argument('--ckpt', required=True,
                   help="reference .pth file or a directory of the port's "
                        'step_<N> checkpoints (ckpt/ or ema_ckpt/)')
    p.add_argument('--vost_root', required=True,
                   help='VOST root (JPEGImages_10fps/, Annotations/, '
                        'ImageSets/)')
    p.add_argument('--model', default='r50_deaotl',
                   help='model registry name; r50_aotl / r50_deaotl have '
                        'published rows to diff against, others just score')
    p.add_argument('--variant', default='rmem',
                   choices=['rmem', 'vanilla'],
                   help='which published row to compare against; vanilla '
                        'additionally disables the temporal memory PE '
                        '(the RMem-off reference configuration)')
    p.add_argument('--split', default='val')
    p.add_argument('--output', default=None,
                   help='mask/CSV output dir (default '
                        '<dir_result>/accept/vost)')
    p.add_argument('--gap', type=int, default=None,
                   help='pin the long-term memory write gap (default: '
                        'adaptive, like the reference eval)')
    p.add_argument('--latter_mem_len', type=int, default=None)
    p.add_argument('--max_size', type=float, default=None)
    p.add_argument('--flip', action='store_true')
    p.add_argument('--ms', nargs='+', type=float, default=None)
    p.add_argument('--device', type=str, default=None,
                   help="torch device; the card by default, 'cpu' only "
                        'when asked')
    return p.parse_args(argv)


def run(argv=None) -> dict:
    args = parse_args(argv)
    exp = get_config('pre_vost_2', model=args.model)
    output = args.output or os.path.join(exp.dir_result(), 'accept', 'vost')

    eval_argv = ['--stage', 'pre_vost_2', '--model', args.model,
                 '--dataset', 'vost', '--split', args.split,
                 '--data_root', args.vost_root,
                 '--ckpt_path', args.ckpt,
                 '--output', output,
                 # published-checkpoint acceptance must run the registry
                 # config, not a local training run's snapshot
                 '--no_config_reload']
    if args.variant == 'vanilla':
        # reference RMem-off configuration: no temporal PE; memory length
        # flags stay at their registry values unless overridden below
        eval_argv += ['--vanilla']
    if args.gap is not None:
        eval_argv += ['--gap', str(args.gap)]
    if args.latter_mem_len is not None:
        eval_argv += ['--latter_mem_len', str(args.latter_mem_len)]
    if args.max_size is not None:
        eval_argv += ['--max_size', str(args.max_size)]
    if args.flip:
        eval_argv += ['--flip']
    if args.ms is not None:
        eval_argv += ['--ms'] + [str(s) for s in args.ms]
    if args.device is not None:
        eval_argv += ['--device', args.device]

    print(f'accept: evaluating {args.ckpt} on VOST {args.split} '
          f'({args.model}, {args.variant}) -> {output}')
    old_argv = sys.argv
    sys.argv = ['eval.py'] + eval_argv
    try:
        eval_cli.main()
    finally:
        sys.argv = old_argv

    gpath = score_results(output, args.vost_root, args.split)
    with open(gpath) as f:
        rows = list(csv.reader(f))
    summary = dict(zip(rows[0], map(float, rows[1])))
    j = summary['J_mean'] * 100
    j_tr = summary['J_last_mean'] * 100

    row = PUBLISHED.get((args.model, args.variant))
    print('\n=== acceptance: VOST val ===')
    print(f'{"":18s} {"J_tr":>8s} {"J":>8s}')
    print(f'{"this run":18s} {j_tr:8.1f} {j:8.1f}')
    out = {'J': j, 'J_tr': j_tr, 'csv': gpath}
    if row is not None:
        ref_j_tr, ref_j = row
        print(f'{"reference":18s} {ref_j_tr:8.1f} {ref_j:8.1f}   '
              f'({args.model} {args.variant}, reference README.md:50-53)')
        print(f'{"delta":18s} {j_tr - ref_j_tr:+8.1f} {j - ref_j:+8.1f}')
        out.update(ref_J=ref_j, ref_J_tr=ref_j_tr, delta_J=j - ref_j,
                   delta_J_tr=j_tr - ref_j_tr)
    else:
        print(f'(no published reference row for {args.model} '
              f'{args.variant}; scores above stand alone)')
    return out


def main():
    run()


if __name__ == '__main__':
    main()
