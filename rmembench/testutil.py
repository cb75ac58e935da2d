"""Small cells for the folder's CPU tests: a cell's own configuration at a
few tokens a side, two streams, a short fill; and a copy of the benchmark
with one more configuration and its cell, added as files and entries
alone."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from rmembench import harness

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(streams=2, source_height=97, source_width=161, pool_frames=6,
            fill_frames=20, gap=2, traced_steps=3)

def tiny_cell(workload: str = 'r50_deaotl.vost_b8', **traffic) -> dict:
    cell = harness.load_cell(ROOT, workload)
    cell['traffic'] = dict(cell['traffic'], **dict(TINY, **traffic))
    return cell


def checkout_with(tmp: Path, config: dict, traffic: str = 'vost_b8',
                  limits: dict = None) -> Path:
    """A copy of the benchmark under tmp with the configuration `config`
    and its cell `<name>.<traffic>` added as files and entries only (the
    limits default to the first cell's)."""
    root = tmp / 'checkout'
    shutil.copytree(ROOT / 'rmembench', root / 'rmembench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    spec = benchmark_json()
    bench = root / 'rmembench'
    name, cell = config['name'], f'{config["name"]}.{traffic}'
    (bench / 'configs' / f'{name}.json').write_text(json.dumps(config))
    first = spec['workloads'][0]['name']
    (bench / 'limits' / f'{cell}.json').write_text(json.dumps(
        limits or json.loads((bench / 'limits' / f'{first}.json')
                             .read_text())))
    spec['configs'].append({'name': name, 'source': config['source'],
                            'file': f'rmembench/configs/{name}.json',
                            'reduced': [], 'why': 'test'})
    spec['workloads'].append({'name': cell, 'config': name,
                              'traffic': traffic, 'chips': 1, 'why': 'test'})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return root


def run_cpu(cell: dict, seed: int = 5, seconds: float = 0.0,
            traced: bool = False, control: bool = False) -> dict:
    t0 = time.perf_counter()
    return harness.run(cell, seed, seconds, traced, 'cpu',
                       lambda: time.perf_counter() - t0, log=lambda s: None,
                       control=control)


def benchmark_json() -> dict:
    return json.loads((ROOT / 'BENCHMARK.json').read_text())
