"""On the card: each cell runs end to end through `run.py` for a short
window and comes out correct, its last line what the driver reads; and at
the first cell's own size a run with the timed path broken underneath,
and the float8 control in the program's place, come out not correct.
Run there with `python -m pytest rmembench -m cuda`; skipped without a
card."""
import json
import subprocess
import sys
import time

import pytest
import torch

from rmem_ocu_tpu_torch import InferEngine
from rmembench import check, harness
from rmembench.test_rmembench_faults import FAULTS
from rmembench.testutil import ROOT, benchmark_json

CELLS = [w['name'] for w in benchmark_json()['workloads']]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('traced', [0, 1])
def test_cell_runs_on_the_card(workload, traced):
    _needs_card()
    out = subprocess.run(
        [sys.executable, 'rmembench/run.py', '--workload', workload,
         '--seed', '2147483999', '--seconds', '2', '--trace', str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'] is True, res['checks']
    assert res['device']['platform'] == 'gpu'
    assert list(res)[-1] == 'checks'


def _run_on_card(control=False):
    torch.set_num_threads(1)
    cell = harness.load_cell(ROOT, CELLS[0])
    t0 = time.perf_counter()
    res = harness.run(cell, 2147483901, 3.0, False, 'cuda:0',
                      lambda: time.perf_counter() - t0, log=lambda s: None,
                      control=control)
    return cell, res


@pytest.mark.cuda
@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct_at_the_cells_size(
        fault, monkeypatch):
    _needs_card()
    name, fn = FAULTS[fault]
    monkeypatch.setattr(InferEngine, name, fn)
    _, res = _run_on_card()
    assert res['correct'] is False, res['checks']


@pytest.mark.cuda
def test_the_control_is_not_correct_at_the_cells_size():
    _needs_card()
    cell, res = _run_on_card(control=True)
    assert res['correct'] is True, res['checks']
    assert check.control_verdict(res['control_readings'],
                                 cell['limits']) is False, \
        res['control_readings']
