"""Run one cell of the benchmark once and print its result line.

    python3 rmembench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `rmembench/` and
the package `rmem_ocu_tpu_torch`. Needs an NVIDIA GPU; without one it
exits 2 and prints no result. The last line of standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`: each number compared
with its limit); the last lines of standard error are the same checks.
"""
import os
import sys

# the seconds since this process started, from the kernel's clock
_TICKS = os.sysconf('SC_CLK_TCK')


def process_age() -> float:
    with open('/proc/self/stat') as f:
        start = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        up = float(f.read().split()[0])
    return up - start / _TICKS


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX must not come in with anything the program loads
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'rmem_ocu_tpu')


def forbidden_modules():
    return sorted({name.split('.', 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault('USE_FLAX', '0')
    sys.path.insert(0, ROOT)
    import torch
    from rmembench import check, harness

    cell = harness.load_cell(Path(ROOT), args.workload)
    chips = cell['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload}: needs {chips} CUDA device(s); '
              f'{torch.cuda.device_count()} available', file=sys.stderr)
        return 2
    # one host thread: the loop's CPU work is the Python that enqueues
    # kernels, and idle intra-op workers only compete with it
    torch.set_num_threads(1)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         'cuda:0', process_age)
    found = forbidden_modules()
    if found:
        print(f'the run loaded {found}: the benchmark runs without JAX and '
              f'without the JAX package', file=sys.stderr)
        return 3
    readings = {k: v['value'] for k, v in result['checks'].items()}
    for line in check.lines(readings, cell['limits']):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
