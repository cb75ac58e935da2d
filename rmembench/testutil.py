"""Small cells for the folder's CPU tests: a cell's own configuration at a
few tokens a side, two streams, a short fill."""
from __future__ import annotations

import json
import time
from pathlib import Path

from rmembench import harness

ROOT = Path(__file__).resolve().parents[1]


def tiny_cell(workload: str = 'r50_deaotl.vost_b8', **traffic) -> dict:
    cell = harness.load_cell(ROOT, workload)
    cell['traffic'] = dict(cell['traffic'], streams=2, source_height=97,
                           source_width=161, pool_frames=6, fill_frames=20,
                           gap=2, traced_steps=3, **traffic)
    return cell


def run_cpu(cell: dict, seed: int = 5, seconds: float = 0.0,
            traced: bool = False, control: bool = False) -> dict:
    t0 = time.perf_counter()
    return harness.run(cell, seed, seconds, traced, 'cpu',
                       lambda: time.perf_counter() - t0, log=lambda s: None,
                       control=control)


def benchmark_json() -> dict:
    return json.loads((ROOT / 'BENCHMARK.json').read_text())
