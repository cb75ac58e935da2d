"""The bf16 main path of two checkouts of this repo on one card, in turns.

    python -m rmem_ocu_tpu_torch.tools.ab_main_path TREE_A TREE_B

Runs each tree's own `chip_smoke.phase_main_path` (every path at 1 and 8
streams), then its `main_path_census` of each where the tree has one (in
older trees phase_main_path profiles each path itself), in a fresh process
from that tree, in the order A, B, B, A, so
that both trees share the card, its host and its drift. Prints each run's
lines and then, per tree, path and stream count, the frames/s, the p50
frame latency and the device time per frame of the two turns. Needs a CUDA
device.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

RUN = '''
import torch, chip_smoke as cs
runs = [(path, batch) for path in cs.PATHS for batch in (1, 8)]
for run in runs:
    cs.phase_main_path(torch, *run)
for run in runs if hasattr(cs, 'main_path_census') else ():
    cs.main_path_census(torch, *run)
'''
MAIN = re.compile(r'main path .* (\w+) streams=(\d+): ([\d.]+) frames/s '
                  r'aggregate, p50 frame latency ([\d.]+) ms')
BUSY = re.compile(r'profile (\w+) streams=(\d+): .* device busy ([\d.]+) '
                  r'ms/frame')


def run_tree(tree: Path) -> dict:
    """{(path, streams): [frames/s, p50 ms, device ms/frame]} of one run."""
    out = subprocess.run([sys.executable, '-c', RUN], cwd=tree,
                         capture_output=True, text=True)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        sys.stderr.write(out.stderr)
        raise RuntimeError(f'the main path of {tree} failed')
    rows = {}
    for line in out.stdout.splitlines():
        m = MAIN.search(line)
        if m:
            rows[(m[1], int(m[2]))] = [float(m[3]), float(m[4]), None]
        m = BUSY.search(line)
        if m:
            rows[(m[1], int(m[2]))][2] = float(m[3])
    return rows


def main(argv) -> int:
    trees = {'A': Path(argv[1]).resolve(), 'B': Path(argv[2]).resolve()}
    runs = {'A': [], 'B': []}
    for label in 'ABBA':
        print(f'== run of {label}: {trees[label]}', flush=True)
        runs[label].append(run_tree(trees[label]))
    print('tree path streams: frames/s, p50 ms, device ms/frame (two turns)')
    for label, tree in trees.items():
        for key in runs[label][0]:
            turns = '; '.join(', '.join(f'{x}' for x in r[key])
                              for r in runs[label])
            print(f'{label} {key[0]} {key[1]}: {turns}  ({tree.name})')
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
