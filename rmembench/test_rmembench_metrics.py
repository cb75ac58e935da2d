"""The benchmark's own arithmetic, on the CPU: the census copy and the
device timeline on synthetic profiler events, the roofline bounds against
the kernel table's, and each family's FLOP count and kernel work."""
import json
from types import SimpleNamespace

import pytest

from rmembench import census, harness, program, roofline, trace, traffic
from rmembench.test_rmembench_families import R50_AOTL
from rmembench.testutil import ROOT


class Ev:
    """A profiler event: CPU (device_type CPU) or device (CUDA)."""

    def __init__(self, name, start, end, cuda=False, id=0, parent=None):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = 'DeviceType.CUDA' if cuda else 'DeviceType.CPU'
        self.id = id
        self.cpu_parent = parent


def _events():
    """Two steps: an encoder conv, a B1 read (split and combine kernels)
    under the GPM's long-term attention, a copy outside every range."""
    evs = []
    for step, t in enumerate((0, 1000)):
        win = Ev('bench: window', 0, 2000) if step == 0 else None
        if win:
            evs.append(win)
        stage = Ev('stage: propagate', t, t + 900, parent=win)
        enc = Ev('module: encoder', t + 10, t + 300, parent=stage)
        lt = Ev('module: LSTT.layers.0.long_term_attn', t + 300, t + 600,
                parent=stage)
        l1 = Ev('cudaLaunchKernel', t + 20, t + 25, id=10 * step + 1,
                parent=enc)
        l2 = Ev('cudaLaunchKernel', t + 310, t + 315, id=10 * step + 2,
                parent=lt)
        l3 = Ev('cudaLaunchKernel', t + 320, t + 325, id=10 * step + 3,
                parent=lt)
        evs += [stage, enc, lt, l1, l2, l3]
        evs += [Ev('cudnn_conv_fprop', t + 100, t + 250, True, 10 * step + 1),
                Ev('memory_read_wide', t + 400, t + 700, True,
                   10 * step + 2),
                Ev('memory_read_combine', t + 700, t + 750, True,
                   10 * step + 3),
                Ev('Memcpy HtoD', t + 800, t + 820, True, 99)]
    return evs


def test_census_places_kernels_under_their_components():
    c = census.census(_events(), 2)
    assert c['components']['encoder'] == pytest.approx(0.150)
    assert c['components']['long_term_attn'] == pytest.approx(0.350)
    assert c['components']['unmatched'] == pytest.approx(0.020)
    assert c['groups']['B1 memory_read'] == pytest.approx(0.350)
    assert c['launches'] == 3 and c['copies'] == 1
    assert c['parts']['encoder'] == pytest.approx(0.150)


def test_census_refuses_a_profile_without_kernels():
    with pytest.raises(RuntimeError):
        census.census([e for e in _events() if not e.device_type.endswith(
            'CUDA')], 2)


def test_timeline_busy_idle_and_gaps():
    t = trace.device_timeline(_events())
    # per step: 100-250, 400-750, 800-820 busy
    assert t['busy_s'] == pytest.approx(2 * 520e-6)
    assert t['trace_window_s'] == pytest.approx(2000e-6)
    gap, seconds = t['idle_gaps'][0]
    assert seconds == pytest.approx(280e-6)       # 820 -> 1100
    assert t['device_ops'][0] == ['memory_read_wide', pytest.approx(600e-6)]
    names = {g[0] for g in t['idle_gaps']}
    assert 'module: encoder' in names and 'stage: propagate' in names


def test_roofline_matches_the_kernel_table():
    # PERF.md's kernel table: B1 at 23x40 (T=10, 9 live), B2 at 23x40
    s, by = roofline.bound_s(*roofline.b1_work(8, 920, 9, 10, 128,
                                               (512, 512)), 'bfloat16')
    assert round(s * 1e3, 4) == 0.1420 and by == 'operations'
    s, _ = roofline.bound_s(*roofline.b1_work(1, 858, 9, 10, 128,
                                              (512, 512)), 'bfloat16')
    assert round(s * 1e3, 4) == 0.0154
    s, by = roofline.bound_s(*roofline.b2_work(1, (23, 40), 128, 1024),
                             'bfloat16')
    assert round(s * 1e3, 5) == 0.00151 and by == 'bytes'
    s, _ = roofline.bound_s(*roofline.b2_work(8, (22, 39), 128, 1024),
                            'bfloat16')
    assert round(s * 1e3, 4) == 0.0113


def _config(name):
    if name == 'r50_aotl':
        return R50_AOTL
    return json.loads((ROOT / 'rmembench' / 'configs'
                       / f'{name}.json').read_text())


# what each family's step multiplies per key token of a bank frame, q.k
# and p.v together: DeAOT one head of d/2 and values V, ID_V of 2d each,
# AOT heads of d in all and values of d
PER_KEY = {'deaot': lambda d: d // 2 + 4 * d, 'aot': lambda d: 2 * d}


@pytest.mark.parametrize('name', ['r50_deaotl', 'swinb_deaotl', 'r50_aotl'])
def test_flops_of_a_bank_frame_are_the_read_of_its_tokens(name):
    config = _config(name)
    mc = config['model']
    family = harness.load_family(config)
    _, model = program.build_model(config, 'meta')
    shapes = program.shapes_of(model)
    size = (65, 97) if mc['align_corners'] else (64, 96)
    grid = program.grid_of(size, mc['align_corners'])
    hw = grid[0] * grid[1]
    f8, f9 = (family.step_flops(shapes, mc, size, n) for n in (8, 9))
    d = mc['encoder_embedding_dim']
    # one more frame in the bank: q.k and p.v over its hw tokens, in each
    # layer
    per_key = PER_KEY[config['reference']](d)
    assert f9 - f8 == mc['lstt_num'] * 2 * hw * hw * per_key
    assert f9 > 10 * (f9 - f8)


# the parent tree's numbers at the cells' shapes (577x1041 and 592x1040, 8
# streams, a bank of 9 live frames in 10 slots): `flops.step_flops` and
# what `metrics/b1_roofline.py` and `metrics/b2_roofline.py` computed
# before the count and the kernels' work moved behind the family
PARENT = {
    'r50_deaotl.vost_b8': (570190653568, {
        'B1 memory_read': (450909632, 989295538176, 3),
        'B2 local_attn': (107604288, 8590528512, 3)}),
    'swinb_deaotl.vost_b8': (840814433280, {
        'B1 memory_read': (444077952, 959544668160, 3),
        'B2 local_attn': (105973920, 8452564992, 3)}),
}


@pytest.mark.parametrize('workload', sorted(PARENT))
def test_the_family_counts_what_the_harness_counted_before(workload):
    cell = harness.load_cell(ROOT, workload)
    config, tr = cell['config'], cell['traffic']
    mc = config['model']
    size = traffic.input_size(tr, mc['align_corners'])
    grid = program.grid_of(size, mc['align_corners'])
    _, model = program.build_model(config, 'meta')
    family = cell['family']
    flops, work = PARENT[workload]
    assert family.step_flops(program.shapes_of(model), mc, size,
                             mc['former_mem_len'] + mc['latter_mem_len']) \
        == flops
    assert family.kernel_work(mc, tr['streams'], grid) == work
