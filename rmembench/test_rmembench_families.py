"""A configuration names its reference family, and a family the harness
has not run before comes in as files and entries alone: a copy of the
benchmark gains R50-AOT-L's configuration, limits and cell, and the
unchanged harness runs that cell on the CPU through the AOT family's
check, FLOP count and kernel work. A configuration that names no family,
or one that does not exist, fails when its cell is loaded."""
import math
from types import SimpleNamespace

import pytest

from rmembench import harness, program, traffic
from rmembench.testutil import TINY, checkout_with, run_cpu

# R50-AOT-L + RMem as its configuration file would state it: the package's
# `r50_aotl` at the VOST stage (which turns `linear_q` off)
R50_AOTL = {
    'name': 'r50_aotl',
    'title': 'R50-AOT-L + RMem (AOT\'s LSTT: 8 heads of 32, no ID_V)',
    'source': 'https://github.com/Restricted-Memory/RMem',
    'defined_by': 'configs/models/r50_aotl.py of the RMem code',
    'reference': 'aot',
    'package_model': 'r50_aotl',
    'stage': 'pre_vost_2',
    'compute_dtype': 'bfloat16',
    'model': {
        'encoder': 'resnet50', 'encoder_dim': [256, 512, 1024, 1024],
        'encoder_embedding_dim': 256, 'lstt_num': 3, 'self_heads': 8,
        'att_heads': 8, 'linear_q': False, 'decoder_intermediate_lstt': True,
        'gru_memory': False, 'max_obj_num': 10, 'id_dim': 12,
        'align_corners': True, 'former_mem_len': 1, 'latter_mem_len': 8,
        'use_temporal_pe': True, 'temporal_pe_slot_4': True,
    },
    'reduced': [],
}

CELL = 'r50_aotl.vost_b8'


def test_an_aot_cell_defined_by_files_alone_runs(tmp_path):
    root = checkout_with(tmp_path, R50_AOTL)
    cell = harness.load_cell(root, CELL)
    assert cell['family'].__name__ == 'rmembench.reference.aot'
    cell['traffic'] = dict(cell['traffic'], **TINY)
    res = run_cpu(cell, traced=True)
    assert res['correct'] is True, res['checks']
    assert res['metrics']['bank.mib']['value'] > 0
    # the kernels' rooflines read a census, which only the card's traced
    # steps give: here the AOT family's work meets a census that holds
    # time for both kernel groups, and only B1 reads, since the family
    # launches no B2
    mc = cell['config']['model']
    tr = traffic.load(root, 'vost_b8')
    size = traffic.input_size(tr, mc['align_corners'])
    grid = program.grid_of(size, mc['align_corners'])
    run = SimpleNamespace(
        config=cell['config'],
        census={'groups': {'B1 memory_read': 3 * 5.5,
                           'B2 local_attn': 3 * 1.0}},
        kernel_work=lambda: cell['family'].kernel_work(
            mc, tr['streams'], grid))
    b1 = harness.load_reader(root, 'b1_roofline')(run)
    assert math.isfinite(b1) and 0 < b1 < 100
    assert harness.load_reader(root, 'b2_roofline')(run) is None


@pytest.mark.parametrize('reference, error, names', [
    ('no_such_family', ModuleNotFoundError,
     'rmembench.reference.no_such_family'),
    (None, KeyError, '"reference" key'),
    ('model', AttributeError, 'no Reference, step_flops, kernel_work'),
])
def test_a_configuration_without_a_family_fails_at_load(
        tmp_path, reference, error, names):
    config = {k: v for k, v in R50_AOTL.items() if k != 'reference'}
    if reference is not None:
        config['reference'] = reference
    root = checkout_with(tmp_path, config)
    with pytest.raises(error, match=names):
        harness.load_cell(root, CELL)
