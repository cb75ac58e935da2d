"""Spatial sharding of the port's training on the CPU
(`train_spatial_sharding`, parallel/spatial.py): D x M worlds over gloo
whose model groups split the image's rows, against one process, and
against the JAX package's spatially sharded (data, model) mesh.

Worlds of 1 x 2 and 2 x 2 ranks (tests/torch_dp_worker.py) train 49x49
clips (4 rows of the 16x grid: bands of 32 + 17 px at M=2), T=3, while
this process trains the same cases alone. Cases: `aott`; `deaott` with
trainable BatchNorm (its moments over the world); `deaott` past the
seq-training switch (`use_prev_pred`: the band's prediction feeds the id
bank) with remat; `r50_deaotl` (the 7x7 stem, the max pool, the id bank's
8-row halo). Bars: losses within 1e-5 at every step; each averaged
gradient leaf within 2e-3 of its largest magnitude (or of 1e-6, for the
leaves whose gradient is zero but for rounding), checked for the encoder,
decoder, LSTT split and LSTT whole leaves, each class present; weights and
EMA within 1e-4 after 2 steps; every rank alike. The trainable-BN case
runs in float64: in float32 one process against itself, its frames
nudged by 1e-7, already moves some leaves' gradients past 2e-3 (ReLU6
kinks behind batch-normalised maps), so no other order of sums could
meet the bar. The
2 x 2 world's first step, ZeRO-1 on top, equals the JAX package's Trainer
with `train_spatial_sharding` on Mesh((2, 2), ('data', 'model')) handed
the world's averaged gradient, within JAX's TP bars (rtol 5e-4, atol
2e-5). Unit cases: the band arithmetic, `halo_rows` against slicing the
whole tensor, forward and backward, and a rank's encoder and decoder maps
holding its band's rows only.
"""
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.train.trainer import Trainer as JaxTrainer
from rmem_ocu_tpu.train.trainer import TrainState as JaxTrainState
from rmem_ocu_tpu.utils.torch_convert import convert_torch_params

import torch_threads  # noqa: F401
import torch_dp_worker as worker
from rmem_ocu_tpu_torch import build_vos_model
from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

WORLD_TIMEOUT, GROUP_TIMEOUT = 300, 120
LOSSES = ('loss', 'aux_loss', 'pred_loss', 'frame_losses')
SPATIAL = dict(train_spatial_sharding=True)


def _cases():
    one_by_two = [
        dict(kind='halo', name='halo'),
        dict(kind='maps', name='maps_r50', model='r50_deaotl'),
        dict(kind='maps', name='maps_deaot', model='deaott'),
        dict(name='sp_aot', model='aott', steps=2, batch=2, capture=True,
             overrides=SPATIAL),
        dict(name='sp_deaot_bn', model='deaott', steps=2, batch=2,
             capture=True, dtype='float64',
             overrides=dict(SPATIAL, freeze_bn=False, train_opt='sgd')),
        dict(name='sp_r50', model='r50_deaotl', steps=2, batch=2,
             capture=True, overrides=SPATIAL),
    ]
    two_by_two = [
        dict(name='sp22_deaot_prev', model='deaott', steps=2, batch=2,
             capture=True, zero1=True, remat='full',
             overrides=dict(SPATIAL, train_seq_training_start_ratio=0.0)),
        dict(name='sp22_aot', model='aott', steps=2, batch=2, capture=True,
             remat='full', overrides=SPATIAL),
    ]
    return one_by_two, two_by_two


TRAIN_CASES = [c['name'] for w in _cases() for c in w
               if c.get('kind', 'train') == 'train']


def _spec(root, name, cases):
    path = os.path.join(root, f'{name}.json')
    with open(path, 'w') as f:
        json.dump(dict(device='cpu', backend='gloo', timeout=GROUP_TIMEOUT,
                       out=root, cases=cases, tp=2), f)
    return path


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """{case name: (one process, the world's digest)}; per-rank digests
    of the unit cases as lists. Both worlds run while this process trains
    the cases alone."""
    root = str(tmp_path_factory.mktemp('spatial'))
    one_by_two, two_by_two = _cases()
    procs = (worker.spawn(2, [worker.__file__,
                              _spec(root, 'w12', one_by_two)])
             + worker.spawn(4, [worker.__file__,
                                _spec(root, 'w22', two_by_two)]))
    try:
        alone = {c['name']: worker.run_case(c, World())
                 for c in one_by_two + two_by_two if 'kind' not in c}
    finally:
        worker.wait(procs, WORLD_TIMEOUT)
    out = {}
    for cases, n in ((one_by_two, 2), (two_by_two, 4)):
        for c in cases:
            if 'kind' in c:
                out[c['name']] = [torch.load(worker.digest_path(
                    root, f'{c["name"]}_r{r}', n)) for r in range(2)]
            else:
                out[c['name']] = (alone[c['name']], torch.load(
                    worker.digest_path(root, c['name'], n)))
    return out


def _leaf_class(name, split):
    if name in split:
        return 'lstt_split'
    if name.startswith('LSTT.'):
        return 'lstt_whole'
    return name.split('.')[0]


@pytest.mark.parametrize('name', TRAIN_CASES)
def test_world_trains_as_one_process(worlds, name):
    one, sp = worlds[name]
    assert sp['same_on_ranks'] and sp['whole_grads_alike']
    for a, b in zip(one['steps'], sp['steps']):
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert b['lr'] == a['lr']
    # each leaf of the first step's averaged gradient, whole: a band's
    # part not summed over the group, or a whole part summed twice, is
    # off by ~1/M or ~M of the leaf
    split = set(sp['split'])
    seen = set()
    for k, g in one['grads'].items():
        seen.add(_leaf_class(k, split))
        torch.testing.assert_close(
            sp['grads'][k], g, rtol=0,
            atol=2e-3 * max(float(g.abs().max()), 1e-6), msg=k)
    assert {'encoder', 'decoder', 'lstt_split', 'lstt_whole'} <= seen
    torch.testing.assert_close(sp['weights'], one['weights'], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(sp['ema'], one['ema'], rtol=0, atol=1e-4)
    assert torch.equal(sp['weights0'], one['weights0'])
    assert float((one['weights'] - one['weights0']).norm()) > 0


def test_halo_rows_are_the_neighbours_rows(worlds):
    """Each rank's band with its halo equals the whole map's rows around
    the band, the edge filled as asked; the gradient of its band is the
    band's part of the whole map's, each halo row's gradient added at
    the rank that owns the row."""
    x, starts, weights = worker.halo_operands(2)
    for i, (top, bottom, fill, edge) in enumerate(worker.HALO_CASES):
        edge = edge or (top, bottom)
        whole = x.clone().requires_grad_()
        fill_rows = lambda n: torch.full((2, 3, n, 5), fill, dtype=x.dtype)
        # rank 0: the image's top edge, its rows and `bottom` of rank 1's;
        # rank 1: `top` of rank 0's rows, its own and the bottom edge
        wants = [torch.cat([fill_rows(edge[0]),
                            whole[..., :starts[1] + bottom, :]], dim=-2),
                 torch.cat([whole[..., starts[1] - top:, :],
                            fill_rows(edge[1])], dim=-2)]
        total = 0
        for r, got in enumerate(worlds['halo']):
            torch.testing.assert_close(got['ext'][i], wants[r].detach(),
                                       rtol=0, atol=0)
            total = total + (wants[r] * weights[i][r]).sum()
        total.backward()
        for r, got in enumerate(worlds['halo']):
            torch.testing.assert_close(
                got['grad'][i], whole.grad[..., starts[r]:starts[r + 1], :],
                rtol=0, atol=1e-12)


@pytest.mark.parametrize('name', ['maps_r50', 'maps_deaot'])
def test_rank_maps_hold_their_band(worlds, name):
    """Every banded convolution of the encoder, the id bank and the
    decoder receives the band's rows at its stride, never the whole map;
    the band's maps, the whole id tokens and the band's logits equal the
    whole image's."""
    whole = {s: -(-worker.SIZE // s) for s in spatial.STRIDES}
    for r, got in enumerate(worlds[name]):
        rows = got['band_rows']
        assert got['conv_inputs']
        for level, n in got['conv_inputs']:
            assert n == rows[level][1] - rows[level][0] < whole[level]
        assert got['map_rows'] == [rows[s][1] - rows[s][0]
                                   for s in (4, 8, 16, 16)]
        assert got['logit_rows'] == rows[4][1] - rows[4][0]
        assert got['map_err'] <= 1e-5 and got['token_err'] <= 1e-5
        assert got['logit_err'] <= 1e-5


@pytest.mark.parametrize('size,m,want', [
    (49, 2, (0, 32, 49)), (49, 4, (0, 16, 32, 48, 49)),
    (129, 2, (0, 80, 129)), (129, 4, (0, 48, 80, 112, 129)),
    (465, 2, (0, 240, 465)), (465, 4, (0, 128, 256, 368, 465))])
def test_band_arithmetic(size, m, want):
    """Bands start on the 16x grid, the first ranks taking a grid row
    more; a map's rows at stride s are [start / s, ...), the last rank's
    up to ceil(H / s); the bands of every stride tile its whole map."""
    for r in range(m):
        bands = spatial.make_bands((size, size), World(rank=r, size=m))
        assert bands.starts == want
        for s in spatial.STRIDES:
            first, end = bands.rows(s)
            assert first == want[r] // s
            assert end == (-(-size // s) if r == m - 1
                           else want[r + 1] // s)
    bands = spatial.make_bands((465, 465), World(size=2))
    assert [bands.whole_rows(s) for s in (2, 4, 8, 16)] == [233, 117, 59,
                                                           30]


def test_bands_refuse_what_they_cannot_split():
    """A model group with more ranks than grid rows leaves a band empty;
    a halo larger than a neighbour's band raises on every rank alike."""
    with pytest.raises(ValueError, match='empty'):
        spatial.make_bands((49, 49), World(size=5))
    bands = spatial.make_bands((49, 49), World(rank=1, size=4))
    with pytest.raises(ValueError, match='too thin'):
        bands.check_halo(16, 2, 2, 'a dilated conv')


def _close_leaf(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=5e-4,
                               atol=2e-5, err_msg=name)


def test_spatial_step_matches_jax_mesh(worlds):
    """The JAX package's Trainer with `train_spatial_sharding` and ZeRO-1
    on Mesh((2, 2), ('data', 'model')), from the world's initial weights,
    takes one step from the 2 x 2 world's averaged gradient (its episode
    replaced by a loss with that gradient): its parameters are the
    world's after its first step within JAX's TP bars, the seq-training
    parameters frozen alike, and its learning rate and gradient norm are
    the world's."""
    two = worlds['sp22_deaot_prev'][1]
    case = _cases()[1][0]
    exp = worker.exp_of(case)
    jexp = replace(jax_get_config('pre_vost', model=case['model'],
                                  data_seq_len=worker.T,
                                  train_total_steps=100,
                                  **case['overrides']),
                   train_long_term_mem_gap=1, train_zero1=True)
    assert jexp.train_spatial_sharding
    jmodel = jax_build(jexp.model, jexp)
    size = worker.SIZE
    template = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, size, size, jexp.model.id_dim)))
    template = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                      template)
    model = build_vos_model(exp.model, device='cpu', seed=0, exp=exp)
    params, _ = convert_torch_params(
        {k: v.numpy() for k, v in model.state_dict().items()}, template,
        jexp.model)
    gtree, _ = convert_torch_params(
        {k: v.numpy() for k, v in two['grads'].items()}, template,
        jexp.model, strict=False)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ('data', 'model'))
    jtrainer = JaxTrainer(jmodel, jexp, mesh=mesh)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jtrainer.globalize_state(JaxTrainState(
        params=params, opt_state=jtrainer.tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        step=jnp.zeros((), jnp.int32), ema_updates=jnp.zeros((), jnp.int32)))
    step0 = two['steps'][0]

    def world_episode(p, *args, **kw):
        loss = sum(jnp.sum(a * b) for a, b in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(gtree)))
        return loss, {
            'aux_loss': jnp.asarray(step0['aux_loss']),
            'pred_loss': jnp.asarray(step0['pred_loss']),
            'iou': jnp.asarray(step0['iou']),
            'frame_losses': jnp.asarray(step0['frame_losses']),
            'frame_ious': jnp.asarray(step0['frame_ious']),
            'final_pred_mask': jnp.zeros((2, size, size), jnp.int32)}
    jtrainer.engine.episode_loss = world_episode
    state, jmetrics = jtrainer.train_step(state, worker.global_batch(2, 3),
                                          jax.random.PRNGKey(1))
    got = params_from_flax(jax.device_get(state.params), exp.model)
    for name, p in two['params_1'].items():
        _close_leaf(p, got[name], name)
    assert step0['lr'] == float(jmetrics['lr'])
    assert step0['grad_norm'] == pytest.approx(float(jmetrics['grad_norm']),
                                               rel=1e-5)
