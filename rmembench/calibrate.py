"""Readings for a cell's limits: the sound program's over many seeds, and
the float8 control's on some of them.

    python3 rmembench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11 12 ... --control-seeds 11 12 13 --out FILE.jsonl

Runs the cell in one process once per seed, as `run.py --trace 0` runs it
(same window, same check), and writes one JSON line a seed: the readings
of every number compared, with the control's beside them on the control
seeds, each side's verdict under the cell's limits (`correct`,
`control_correct`: a sound limit gives True and False), the card and the
window's throughput. The limits (`limits/<cell>.json`) are set from these
readings by hand, as PERF.md records: above the largest sound reading,
below the smallest control reading.
"""
import json
import os
import sys
import time


def main(argv=None) -> int:
    import argparse
    from pathlib import Path

    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control-seeds', type=int, nargs='*', default=())
    p.add_argument('--out', required=True)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    from rmembench import harness
    from rmembench.check import control_verdict

    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = harness.load_cell(Path(root), args.workload)
    t0 = time.perf_counter()
    with open(args.out, 'a') as out:
        for seed in args.seeds:
            res = harness.run(cell, seed, args.seconds, False, 'cuda:0',
                              lambda: time.perf_counter() - t0,
                              control=seed in args.control_seeds)
            readings = res.get('control_readings') or {
                k: v['value'] for k, v in res['checks'].items()}
            line = {'workload': args.workload, 'seed': seed,
                    'readings': readings, 'correct': res['correct'],
                    'metrics': {k: v['value']
                                for k, v in res['metrics'].items()},
                    'device': res['device']}
            if 'control_readings' in res:
                line['control_correct'] = control_verdict(readings,
                                                          cell['limits'])
            out.write(json.dumps(line) + '\n')
            out.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
