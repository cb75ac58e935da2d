"""The traffic generator: deterministic for a seed, three objects and the
background in every stream's first frame, every cell's files found."""
import pytest
import torch

from rmembench import harness, traffic
from rmembench.testutil import ROOT, benchmark_json

SIZES = {'r50_deaotl.vost_b8': (577, 1041),
         'swinb_deaotl.vost_b8': (592, 1040)}


def _clips(seed, size=(97, 161), streams=3, frames=4):
    tr = dict(streams=streams, objects=3, pool_frames=frames)
    return traffic.Clips(tr, size, seed, 'cpu')


def test_same_seed_same_clips_other_seed_other_clips():
    a, b, c = _clips(2 ** 31 + 7), _clips(2 ** 31 + 7), _clips(2 ** 31 + 8)
    assert torch.equal(a.pool, b.pool) and torch.equal(a.label0, b.label0)
    assert not torch.equal(a.pool, c.pool)


@pytest.mark.parametrize('seed', [0, 1, 2 ** 31 + 5, 987654321])
def test_first_frame_holds_three_objects_and_background(seed):
    clips = _clips(seed, streams=8)
    for label in clips.label0:
        assert sorted(label.unique().tolist()) == [0, 1, 2, 3]
        assert (label > 0).float().mean() > 0.05


@pytest.mark.parametrize('workload', sorted(SIZES))
def test_every_cell_resolves_to_its_files(workload):
    cell = harness.load_cell(ROOT, workload)
    mc = cell['config']['model']
    size = traffic.input_size(cell['traffic'], mc['align_corners'])
    assert size == SIZES[workload]
    assert set(cell['limits']) == {'mask_gap', 'bank_mismatch'}
    assert cell['limits']['bank_mismatch']['limit'] == 0
    assert {m['name'] for m in cell['end_to_end']} >= {'frames_per_s',
                                                       'setup_s'}
    for m in cell['per_layer']:
        assert callable(harness.load_reader(ROOT, m['name']))
    # the full-size first frame, of two streams
    tr = dict(cell['traffic'], streams=2, pool_frames=2)
    clips = traffic.Clips(tr, size, 11, 'cpu')
    for label in clips.label0:
        assert sorted(label.unique().tolist()) == [0, 1, 2, 3]


def test_benchmark_names_only_files_that_exist():
    spec = benchmark_json()
    for c in spec['configs']:
        assert (ROOT / c['file']).is_file()
    for w in spec['workloads']:
        assert (ROOT / 'rmembench' / 'traffic' / f'{w["traffic"]}.json'
                ).is_file()


def test_ping_pong_plays_forward_and_back():
    assert [traffic.ping_pong(t, 4) for t in range(9)] == [0, 1, 2, 3, 2,
                                                            1, 0, 1, 2]
