"""Spatial sharding (`train_spatial_sharding`, parallel/spatial.py) of the
port's training for ResNeSt, the TopDown/oracle encoder and MobileNetV3:
D x M worlds over gloo whose model groups split the image's rows, against
one process and against the JAX package's episode.

A 1 x 2 world (tests/torch_dp_worker.py) trains, T=3, 2 steps of B=2, at
49 px (bands of 32 + 17) but for MobileNetV3 at 129 px (80 + 49: its
dilated 5x5 depthwise convs at 16x need 4 rows of halo each side, which
49 px bands of 2 grid rows do not hold), while this process trains the
same cases alone: `rs101_aotl` with `encoder='resnest50'` (ResNeSt's
modules at a CPU depth); the same with trainable BN and SGD in float64,
as tests/test_torch_spatial.py's trainable-BN case (its split-attention
BN normalises a pooled vector alike on the model ranks: data-group
moments); `r50_topdown_aotl` with its reconstruction loss; the same with
`oracle=True`; `aotl` on MobileNetV3. A 2 x 2 world trains
`r50_topdown_aotl` with remat 'full' and ZeRO-1 (the recompute repeats
the exchanges). Bars: losses within 1e-5 at every step; each averaged
gradient leaf within 2e-3 of its largest magnitude (or of 1e-6), the
encoder, decoder, LSTT split and LSTT whole leaves each present, and
TopDown's `decoders`, `prompt` and `top_down_transform` among the
encoder's (band-local: their gradients are summed over the model group);
weights and EMA within 1e-4 after 2 steps; the ranks alike.

The ResNeSt, TopDown and MobileNetV3 cases run with every train-time
rate at 0 and no id shuffle, so that their world's first step equals
the JAX package's `TrainEngine.episode_loss` and its `jax.grad` on one
device, from the same weights (the port's, through the JAX converter;
`params_from_flax` gives them back), at the same bars. The JAX package's
ResNeSt avg-down pool starts its `reduce_window` sums from a traced zero,
which reverse-mode autodiff refuses; the anchor runs that pool with a
numpy zero, the same function.

Unit cases: on a 1 x 2 and a 1 x 4 world, in float64, the band mean, the
half-pixel resize (1x to 16x, 16x to 4x, and a transposed conv's 4x map
one row short to the stage's) at 49, 72 and 465 px, and at M = 2
TopDown's three transposed convs at 49 and 72 px, forward and backward
against the whole map's; a rank's encoder, id bank and decoder maps for
the full-depth `rs101_aotl` (float32) and the oracle's `r50_topdown_aotl`
at 72 px (not 1 mod 16: its transposed convs' maps have rows of no
stride; float64, where two passes of ResNet-50 leave f32 rounding of
1.4e-5 at maps of magnitude 12); MobileNetV3's bands refused at 49 px.
Swin-B's bands are tests/test_torch_spatial_swin.py's.
"""
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.engine.train_engine import TrainEngine as JaxTrainEngine
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.models.encoders import resnest as jax_resnest
from rmem_ocu_tpu.ops import layers as jlayers
from rmem_ocu_tpu.utils.torch_convert import convert_torch_params

import torch_threads  # noqa: F401
import torch_dp_worker as worker
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
from rmem_ocu_tpu_torch.models.encoders.mobilenetv3 import (
    MobileNetV3Encoder)
from rmem_ocu_tpu_torch.ops.layers import BatchNorm2d
from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.train.optim import make_masks
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

WORLD_TIMEOUT, GROUP_TIMEOUT = 300, 120
LOSSES = ('loss', 'aux_loss', 'pred_loss', 'frame_losses')
SPATIAL = dict(train_spatial_sharding=True)
RESNEST50 = dict(SPATIAL, encoder='resnest50')
MOBILENETV3 = dict(SPATIAL, encoder='mobilenetv3',
                   encoder_dim=(24, 40, 112, 960))
TOPDOWN_LEAVES = ('encoder.decoders.', 'encoder.prompt',
                  'encoder.top_down_transform')


def _cases():
    train = dict(steps=2, batch=2, capture=True)
    one_by_two = [
        dict(kind='bands', name='bands_m2', transposed=True),
        dict(kind='maps', name='maps_rs101', model='rs101_aotl'),
        dict(kind='maps', name='maps_topdown', model='r50_topdown_aotl',
             size=72, dtype='float64', overrides=dict(oracle=True)),
        dict(train, name='sp_rs50', model='rs101_aotl', deterministic=True,
             overrides=RESNEST50),
        dict(train, name='sp_rs50_bn', model='rs101_aotl', dtype='float64',
             overrides=dict(RESNEST50, freeze_bn=False, train_opt='sgd')),
        dict(train, name='sp_topdown', model='r50_topdown_aotl',
             deterministic=True, overrides=SPATIAL),
        dict(train, name='sp_oracle', model='r50_topdown_aotl',
             overrides=dict(SPATIAL, oracle=True)),
        dict(train, name='sp_mbv3', model='aotl', size=129,
             deterministic=True, overrides=MOBILENETV3),
    ]
    two_by_two = [
        dict(train, name='sp22_topdown', model='r50_topdown_aotl',
             zero1=True, remat='full', overrides=SPATIAL),
    ]
    one_by_four = [dict(kind='bands', name='bands_m4')]
    return ((one_by_two, 2, 2), (two_by_two, 4, 2), (one_by_four, 4, 4))


TRAIN_CASES = [c['name'] for w, _, _ in _cases() for c in w
               if c.get('kind', 'train') == 'train']
JAX_CASES = [c['name'] for w, _, _ in _cases() for c in w
             if c.get('deterministic')]


def _spec(root, name, cases, tp):
    path = os.path.join(root, f'{name}.json')
    with open(path, 'w') as f:
        json.dump(dict(device='cpu', backend='gloo', timeout=GROUP_TIMEOUT,
                       out=root, cases=cases, tp=tp), f)
    return path


def _avg_pool_ceil(x, k: int):
    """The JAX package's ResNeSt avg-down pool (models/encoders/resnest.py
    `_avg_pool_ceil`) with its sums started from a numpy zero, which
    `jax.grad` differentiates (a traced zero makes the reduce_window
    generic)."""
    h, w = x.shape[1], x.shape[2]
    pad = ((0, 0), (0, (-h) % k), (0, (-w) % k), (0, 0))
    win = (1, k, k, 1)
    zero = np.zeros((), x.dtype)
    total = jax.lax.reduce_window(x, zero, jax.lax.add, win, win, pad)
    count = jax.lax.reduce_window(np.ones((1, h, w, 1), x.dtype), zero,
                                  jax.lax.add, win, win, pad)
    return total / count


def _jax_step(case):
    """The JAX package's episode loss and gradient (in the port's names)
    of the case's first step on one device, from the port's seeded
    weights, every train-time rate 0 and no id shuffle."""
    size = case.get('size', worker.SIZE)
    exp = worker.exp_of(case)
    jexp = replace(jax_get_config(
        'pre_vost', model=case['model'], data_seq_len=worker.T,
        train_total_steps=100, train_lstt_droppath=0.0,
        train_remat_policy='none', **case['overrides']),
        train_long_term_mem_gap=1)
    jmodel = jax_build(jexp.model, jexp)
    template = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, size, size, jexp.model.id_dim)))
    template = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                      template)
    weights = build_vos_model(exp.model, device='cpu', seed=0,
                              exp=exp).state_dict()
    params, _ = convert_torch_params(
        {k: v.numpy() for k, v in weights.items()}, template, jexp.model)
    back = params_from_flax(params, exp.model)
    assert back.keys() == weights.keys() and all(
        torch.equal(back[k], v) for k, v in weights.items())
    batch = worker.global_batch(2, 3, size)
    engine = JaxTrainEngine(jmodel, jexp)

    def loss_fn(p):
        return engine.episode_loss(
            p, jnp.asarray(batch['frames']),
            jnp.asarray(batch['masks'].astype(np.int32)),
            jnp.asarray(batch['obj_nums'], jnp.int32),
            jnp.asarray(0.0, jnp.float32), jax.random.PRNGKey(0),
            use_prev_pred=False, enable_id_shuffle=False)
    mp = pytest.MonkeyPatch()
    dwconv = jlayers.DWConv2d.__call__
    mp.setattr(jlayers.DWConv2d, '__call__',
               lambda self, x, size_2d, deterministic=True:
               dwconv(self, x, size_2d, True))
    mp.setattr(jax_resnest, '_avg_pool_ceil', _avg_pool_ceil)
    try:
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    finally:
        mp.undo()
    return float(loss), params_from_flax(jax.device_get(grads), exp.model)


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """{case name: (one process, the world's digest)}, per-rank digests
    of the unit cases as lists, and {case name: JAX step} under 'jax'.
    The worlds run while this process trains the cases alone and takes
    the JAX package's steps."""
    root = str(tmp_path_factory.mktemp('spatial_encoders'))
    procs = []
    for i, (cases, n, tp) in enumerate(_cases()):
        procs += worker.spawn(n, [worker.__file__,
                                  _spec(root, f'w{i}', cases, tp)])
    try:
        alone = {c['name']: worker.run_case(c, World())
                 for cases, _, _ in _cases() for c in cases
                 if 'kind' not in c}
        jax_steps = {c['name']: _jax_step(c) for cases, _, _ in _cases()
                     for c in cases if c.get('deterministic')}
    finally:
        worker.wait(procs, WORLD_TIMEOUT)
    out = {'jax': jax_steps}
    for cases, n, tp in _cases():
        for c in cases:
            if 'kind' in c:
                out[c['name']] = [torch.load(worker.digest_path(
                    root, f'{c["name"]}_r{r}', n)) for r in range(tp)]
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


def _assert_leaves_close(got, want, names):
    for k in names:
        g = want[k]
        torch.testing.assert_close(
            got[k].to(g.dtype), g, rtol=0,
            atol=2e-3 * max(float(g.abs().max()), 1e-6), msg=k)


@pytest.mark.parametrize('name', TRAIN_CASES)
def test_world_trains_as_one_process(worlds, name):
    one, sp = worlds[name]
    assert sp['same_on_ranks'] and sp['whole_grads_alike']
    for a, b in zip(one['steps'], sp['steps']):
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        if 'var_loss' in a:
            # TopDown's reconstruction loss (weight 0.01 in the loss)
            # reads 19-50: f32 rounding alone is ~4e-6 there
            np.testing.assert_allclose(b['var_loss'], a['var_loss'],
                                       rtol=1e-5, atol=0)
        assert b['lr'] == a['lr']
    split = set(sp['split'])
    seen = {_leaf_class(k, split) for k in one['grads']}
    _assert_leaves_close(sp['grads'], one['grads'], one['grads'])
    assert {'encoder', 'decoder', 'lstt_split', 'lstt_whole'} <= seen
    if 'topdown' in name:
        # band-local: a rank's part of these leaves is its band's, summed
        # over the model group; each moves
        for prefix in TOPDOWN_LEAVES:
            leaves = [k for k in one['grads'] if k.startswith(prefix)]
            assert leaves and prefix.split('.')[0] in spatial.BAND_LOCAL
            assert all(float(one['grads'][k].abs().max()) > 0
                       for k in leaves), prefix
        assert 'var_loss' in one['steps'][0]
    torch.testing.assert_close(sp['weights'], one['weights'], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(sp['ema'], one['ema'], rtol=0, atol=1e-4)
    assert torch.equal(sp['weights0'], one['weights0'])
    assert float((one['weights'] - one['weights0']).norm()) > 0


@pytest.mark.parametrize('name', JAX_CASES)
def test_world_step_matches_jax_episode(worlds, name):
    """The world's first step (its loss, and its averaged gradient on
    every trainable leaf) equals the JAX package's episode on one device
    from the same weights."""
    loss, grads = worlds['jax'][name]
    _, sp = worlds[name]
    case = next(c for w, _, _ in _cases() for c in w if c['name'] == name)
    exp = worker.exp_of(case)
    model = build_vos_model(exp.model, device='cpu', exp=exp)
    frozen = make_masks(dict(model.named_parameters()), exp).frozen
    trainable = [k for k, fz in frozen.items() if not fz]
    assert any(k.startswith('encoder.') for k in trainable)
    np.testing.assert_allclose(sp['steps'][0]['loss'], loss, rtol=0,
                               atol=1e-5)
    _assert_leaves_close(sp['grads'], grads, trainable)


@pytest.mark.parametrize('name', ['bands_m2', 'bands_m4'])
def test_band_pieces_equal_the_whole_map(worlds, name):
    """On every rank, float64: the band mean, the half-pixel resizes and
    (M = 2) the transposed convs equal the whole map's, forward (the
    transposed convs exactly) and backward; the ranks' weight and bias
    gradients of a transposed conv sum to the whole map's."""
    ranks = worlds[name]
    sizes = worker.BAND_SIZES
    for got in ranks:
        checks = got['checks']
        want = {f'mean {s}' for s in sizes} | {
            f'resize {k} {s}' for s in sizes
            for k in ('1x to 16x', '16x to 4x')} | {'resize 4x 17 to 18 72'}
        if name == 'bands_m2':
            want |= {f'transposed conv {spec} {s}'
                     for spec, _ in worker.DECODER_CONVS
                     for s in sizes[:2]}
        assert want == set(checks)
        for check, (fwd, bwd) in checks.items():
            assert fwd <= (0.0 if 'transposed' in check else 1e-12), check
            assert bwd <= 1e-12, check
    for check in ranks[0]['param_grads']:
        whole = ranks[0]['param_grads'][check][1]
        parts = [sum(r['param_grads'][check][0][i] for r in ranks)
                 for i in range(len(whole))]
        for part, w in zip(parts, whole):
            torch.testing.assert_close(part, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize('name,size', [('maps_rs101', 49),
                                       ('maps_topdown', 72)])
def test_rank_maps_hold_their_band(worlds, name, size):
    """Every banded convolution receives its band's rows at its stride;
    every banded transposed conv receives its band of the map it is told
    (at 72 px TopDown's decoders make 4x and 2x maps of 17 and 33 rows,
    which no stride names); the band's maps, the whole id tokens and the
    band's logits equal the whole image's, and TopDown's with and
    without the oracle's mask."""
    whole = {s: -(-size // s) for s in spatial.STRIDES}
    for got in worlds[name]:
        rows = got['band_rows']
        assert got['conv_inputs']
        for level, n in got['conv_inputs']:
            assert n == rows[level][1] - rows[level][0] < whole[level]
        for at, n, band in got['transposed_inputs']:
            assert n == band[1] - band[0] < at[1]
        assert got['map_rows'] == [rows[s][1] - rows[s][0]
                                   for s in (4, 8, 16, 16)]
        assert got['logit_rows'] == rows[4][1] - rows[4][0]
        assert got['map_err'] <= 1e-5 and got['token_err'] <= 1e-5
        assert got['logit_err'] <= 1e-5
        if name == 'maps_topdown':
            maps = {tuple(at) for at, _, _ in got['transposed_inputs']}
            assert {(4, 17), (2, 33)} <= maps
            assert got['unmasked_err'] <= 1e-5 and got['mask_moves'] > 0
        else:
            assert not got['transposed_inputs']


def test_split_attention_bn_takes_data_group_moments():
    """Under the knob every trainable BN takes its moments over the whole
    world but ResNeSt's split-attention BN, whose pooled input is alike
    on the model ranks: over the data group."""
    exp = replace(get_config('pre_vost', model='rs101_aotl',
                             **dict(RESNEST50, freeze_bn=False)),
                  mesh_shape=(2, 2), mesh_axes=('data', 'model'))
    model = build_vos_model(exp.model, device='cpu', exp=exp)
    world = World(size=4, tp=2)
    TrainEngine(model, exp, world)
    bns = {k: m for k, m in model.named_modules()
           if isinstance(m, BatchNorm2d)}
    pooled = {k for k in bns if k.endswith('conv2.bn1')}
    assert pooled and len(pooled) < len(bns)
    for k, m in bns.items():
        assert m.world == (world.data if k in pooled else world), k


def test_mobilenetv3_refuses_thin_bands():
    """At 49 px and M = 2 the 16x bands hold 2 rows; MobileNetV3's
    dilated 5x5 depthwise convs need 4 on each side, and the bands
    refuse them before any exchange."""
    enc = MobileNetV3Encoder()
    dilated = [m for m in enc.modules() if isinstance(m, spatial.Conv2d)
               and m.dilation[0] == 2 and m.kernel_size[0] == 5]
    assert dilated
    bands = spatial.make_bands((49, 49), World(rank=0, size=2))
    first, end = bands.rows(16)
    x = torch.zeros(1, dilated[0].in_channels, end - first, 4)
    with pytest.raises(ValueError, match='too thin'):
        spatial.conv2d(dilated[0], x, bands)
