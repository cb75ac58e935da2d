"""A new cell, traffic mix and per-layer metric come in as files and
entries alone: a copy of the benchmark gains them, and the unchanged
harness runs the new cell (on the CPU, traced) and reports the new
metric."""
import json
import shutil

from rmembench import harness
from rmembench.testutil import ROOT, run_cpu

NEW_METRIC = '''"""The slowest step's host time in the engine calls, ms."""


def read(run):
    return max(run.host_ms) if run.host_ms else None
'''


def test_a_cell_defined_by_files_alone_runs(tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(ROOT / 'rmembench', root / 'rmembench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench = root / 'rmembench'
    traffic = json.loads((bench / 'traffic' / 'vost_b8.json').read_text())
    traffic.update(streams=2, source_height=97, source_width=161,
                   pool_frames=6, fill_frames=12, gap=2, traced_steps=3,
                   why='a tiny mix for the test')
    (bench / 'traffic' / 'tiny_b2.json').write_text(json.dumps(traffic))
    shutil.copy(bench / 'limits' / 'r50_deaotl.vost_b8.json',
                bench / 'limits' / 'r50_deaotl.tiny_b2.json')
    (bench / 'metrics' / 'engine.host_ms_max.py').write_text(NEW_METRIC)
    spec['workloads'].append({'name': 'r50_deaotl.tiny_b2',
                              'config': 'r50_deaotl', 'traffic': 'tiny_b2',
                              'chips': 1, 'why': 'test'})
    spec['per_layer'].append({
        'name': 'engine.host_ms_max', 'unit': 'ms', 'better': 'lower',
        'source': 'host_clock', 'layer': 'engine loop',
        'moves': 'frames_per_s', 'workloads': ['r50_deaotl.tiny_b2']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))

    cell = harness.load_cell(root, 'r50_deaotl.tiny_b2')
    assert cell['traffic']['streams'] == 2
    res = run_cpu(cell, traced=True)
    assert res['correct'] is True
    assert res['metrics']['engine.host_ms_max']['value'] > 0
    assert res['metrics']['bank.mib']['unit'] == 'MiB'
    # the card's metrics find nothing to read on the CPU and are left out
    assert 'b1_roofline' not in res['metrics']
    res = run_cpu(cell, traced=False)
    assert set(res['metrics']) == {'frames_per_s', 'peak_mem_gib',
                                   'setup_s'}
