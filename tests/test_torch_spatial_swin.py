"""Spatial sharding (`train_spatial_sharding`, parallel/spatial.py) of the
port's training for Swin-B: D x M worlds over gloo whose model groups
split the image's rows, against one process and against the JAX
package's episode.

Swin's windows of 7 rows start at rows 7k (7k + 3 in the shifted blocks,
modulo the map's rows padded to whole windows), not on the bands' 16x
grid, so every band takes the rows that complete its windows from the
bands around, and in the shifted blocks rank 0's first windows wrap to
the map's last rows (torch.roll's wrap).

A 1 x 2 world (tests/torch_dp_worker.py) trains `swinb_deaotl` and
`swinb_aotl` with a narrow Swin (embed 32, depths (2, 2, 2), heads (2, 4,
8); encoder_dim (32, 64, 128, 128)) at 128x64 px (bands of 64 + 64: at
stride 4 the wrap carries a real row, the last band pads its bottom),
T=3, 2 steps of B=2, in float32, while this process trains the same
cases alone; a 2 x 2 world trains `swinb_deaotl` with remat 'full' and
ZeRO-1 (the recompute repeats the wrapping exchanges in their order).
Bars: losses within 1e-5 at every step; each averaged gradient leaf
within 2e-3 of its largest magnitude (or of 1e-6), the encoder, decoder,
LSTT split and LSTT whole leaves each present, and the encoder's window
biases among the band-local leaves; weights and EMA within 1e-4 after 2
steps; the ranks alike. The 1 x 2 cases run with every train-time rate
at 0 and no id shuffle, so that their world's first step equals the JAX
package's `TrainEngine.episode_loss` and its `jax.grad` on one device,
from the same weights, at the same bars; both packages' `build_encoder`
are monkeypatched here to the same narrow Swin.

Unit cases: the window plan's halos against windows enumerated from
torch.roll of the padded map's rows (and at 464 px and M = 2 against the
table of the model's three strides); on a 1 x 2 world at 128 and 464 px
rows and a 1 x 4 world at 288 and 464 px rows, 64 px wide, in float64,
the banded Swin blocks (unshifted and shifted) at strides 4, 8 and 16
and the patch merges at 4 and 8, forward and backward against the whole
map's, and the wrapping halo exchange against torch.roll of the whole
map; a rank's encoder, id bank and decoder maps of the full-width Swin-B
of `swinb_deaotl` at 464x64 px in float32; thin bands refused (112 px
at M = 2: stride-16 bands of 4 + 3 rows against a shifted halo of 4
above and 6 below).
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
from rmem_ocu_tpu.models import vos_model as jax_vos_model
from rmem_ocu_tpu.models.encoders.swin import SwinEncoder as JaxSwin
from rmem_ocu_tpu.ops import layers as jlayers
from rmem_ocu_tpu.utils.torch_convert import convert_torch_params

import torch_threads  # noqa: F401
import torch_dp_worker as worker
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
from rmem_ocu_tpu_torch.models.encoders.swin import SwinBlock
from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.train.optim import make_masks
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

WORLD_TIMEOUT, GROUP_TIMEOUT = 300, 120
LOSSES = ('loss', 'aux_loss', 'pred_loss', 'frame_losses')
NARROW = dict(train_spatial_sharding=True, encoder_dim=(32, 64, 128, 128))
SIZE = [128, 64]
WS, SHIFT = 7, 3
MODELS = ('swinb_deaotl', 'swinb_aotl')


def _cases():
    train = dict(steps=2, batch=2, capture=True, size=SIZE,
                 swin=worker.SWIN_NARROW, overrides=NARROW)
    one_by_two = [
        dict(kind='swin', name='swin_m2', sizes=[128, 464]),
        dict(kind='maps', name='maps_swinb', model='swinb_deaotl',
             size=[464, 64]),
    ] + [dict(train, name=f'sp_{m}', model=m, deterministic=True)
         for m in MODELS]
    two_by_two = [dict(train, name='sp22_swinb_deaotl', model='swinb_deaotl',
                       zero1=True, remat='full')]
    one_by_four = [dict(kind='swin', name='swin_m4', sizes=[288, 464])]
    return ((one_by_two, 2, 2), (two_by_two, 4, 2), (one_by_four, 4, 4))


TRAIN_CASES = [c['name'] for w, _, _ in _cases() for c in w
               if 'kind' not in c]
JAX_CASES = [c['name'] for w, _, _ in _cases() for c in w
             if c.get('deterministic')]


def _spec(root, name, cases, tp):
    path = os.path.join(root, f'{name}.json')
    with open(path, 'w') as f:
        json.dump(dict(device='cpu', backend='gloo', timeout=GROUP_TIMEOUT,
                       out=root, cases=cases, tp=tp), f)
    return path


def _jax_step(case):
    """The JAX package's episode loss and gradient (in the port's names)
    of the case's first step on one device, its encoder the same narrow
    Swin, from the port's seeded weights, every train-time rate 0 and no
    id shuffle."""
    h, w = worker.hw_of(case['size'])
    exp = worker.exp_of(case)
    jexp = replace(jax_get_config(
        'pre_vost', model=case['model'], data_seq_len=worker.T,
        train_total_steps=100, train_lstt_droppath=0.0,
        train_remat_policy='none', **case['overrides']),
        train_long_term_mem_gap=1)
    embed, depths, heads = worker.SWIN_NARROW
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_vos_model, 'build_encoder',
               lambda *a, **k: JaxSwin(embed_dim=embed, depths=depths,
                                       num_heads=heads, name='encoder'))
    dwconv = jlayers.DWConv2d.__call__
    mp.setattr(jlayers.DWConv2d, '__call__',
               lambda self, x, size_2d, deterministic=True:
               dwconv(self, x, size_2d, True))
    try:
        jmodel = jax_build(jexp.model, jexp)
        template = jax.eval_shape(
            jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
            jnp.zeros((1, h, w, jexp.model.id_dim)))
        template = jax.tree_util.tree_map(
            lambda x: np.zeros(x.shape, x.dtype), template)
        weights = worker.build_model(case, exp.model, 'cpu', seed=0,
                                     exp=exp).state_dict()
        params, _ = convert_torch_params(
            {k: v.numpy() for k, v in weights.items()}, template,
            jexp.model)
        back = params_from_flax(params, exp.model)
        assert back.keys() == weights.keys() and all(
            torch.equal(back[k], v) for k, v in weights.items())
        batch = worker.global_batch(2, 3, case['size'])
        engine = JaxTrainEngine(jmodel, jexp)

        def loss_fn(p):
            return engine.episode_loss(
                p, jnp.asarray(batch['frames']),
                jnp.asarray(batch['masks'].astype(np.int32)),
                jnp.asarray(batch['obj_nums'], jnp.int32),
                jnp.asarray(0.0, jnp.float32), jax.random.PRNGKey(0),
                use_prev_pred=False, enable_id_shuffle=False)
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
    root = str(tmp_path_factory.mktemp('spatial_swin'))
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


def _case(name):
    return next(c for w, _, _ in _cases() for c in w if c['name'] == name)


def _trainable(case):
    exp = worker.exp_of(case)
    model = worker.build_model(case, exp.model, 'cpu', exp=exp)
    frozen = make_masks(dict(model.named_parameters()), exp).frozen
    return [k for k, fz in frozen.items() if not fz]


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
        assert b['lr'] == a['lr']
    split = set(sp['split'])
    seen = {_leaf_class(k, split) for k in one['grads']}
    _assert_leaves_close(sp['grads'], one['grads'], one['grads'])
    assert {'encoder', 'decoder', 'lstt_split', 'lstt_whole'} <= seen
    # the trainable window biases, unshifted and shifted, are band-local:
    # a rank's part is its band's windows', summed over the model group;
    # each moves
    biases = [k for k in _trainable(_case(name))
              if k.endswith('attn.relative_position_bias_table')]
    assert {int(k.split('.')[4]) % 2 for k in biases} == {0, 1}
    assert all(k.split('.')[0] in spatial.BAND_LOCAL for k in biases)
    assert all(float(one['grads'][k].abs().max()) > 0 for k in biases)
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
    trainable = _trainable(_case(name))
    assert any(k.endswith('relative_position_bias_table')
               for k in trainable)
    np.testing.assert_allclose(sp['steps'][0]['loss'], loss, rtol=0,
                               atol=1e-5)
    _assert_leaves_close(sp['grads'], grads, trainable)


def _halos_by_roll(bands, stride, hp, shift):
    """For each rank, (rows above, rows below) its band that the windows
    meeting it hold: the windows are the rows of torch.roll(arange(hp),
    -shift) in sevens, in order; the rows above precede the band's first
    row in its window, those below follow its last row in its window."""
    rolled = torch.roll(torch.arange(hp), -shift).reshape(-1, WS).tolist()
    tops, bottoms = [], []
    for r in range(bands.world.size):
        first, end = bands.rows(stride, r, hp)
        mine = set(range(first, end))
        top_win = next(win for win in rolled if first in win)
        bottom_win = next(win for win in rolled if end - 1 in win)
        top = top_win.index(first)
        bottom = WS - 1 - bottom_win.index(end - 1)
        rows = {y for win in rolled if mine & set(win) for y in win} - mine
        assert rows == set(top_win[:top]) | set(bottom_win[WS - bottom:])
        tops.append(top)
        bottoms.append(bottom)
    return tuple(tops), tuple(bottoms)


# at 464 px and M = 2, each stride's (rows, padded rows) and per shift
# the halos (rank 0 / rank 1 above, rank 0 / rank 1 below)
TABLE_464 = {4: ((116, 119), {0: ((0, 4), (3, 0)), 3: ((4, 1), (6, 3))}),
             8: ((58, 63), {0: ((0, 2), (5, 0)), 3: ((4, 6), (1, 3))}),
             16: ((29, 35), {0: ((0, 1), (6, 0)), 3: ((4, 5), (2, 3))})}


@pytest.mark.parametrize('size,m', [(128, 2), (464, 2), (288, 4),
                                    (464, 4)])
def test_window_plan_completes_the_windows(size, m):
    """The window plan's halos, for every rank, stride and shift, are the
    rows of the windows meeting its band (enumerated from the roll), each
    within what the neighbour holds; at 464 px and M = 2 they are the
    table's."""
    for s in (4, 8, 16):
        for shift in (0, SHIFT):
            plan = None
            for r in range(m):
                bands = spatial.make_bands((size, 64), World(rank=r, size=m))
                whole = bands.whole_rows(s)
                hp = -(-whole // WS) * WS
                got = spatial.window_halos(bands, s, hp, WS, shift)
                assert plan in (None, got)
                plan = got
            assert plan == _halos_by_roll(bands, s, hp, shift)
            assert max(plan[0] + plan[1]) <= WS - 1
            bands.check_halo(s, *plan, 'the windows', hp, wrap=shift > 0)
            if size == 464 and m == 2:
                assert (whole, hp) == TABLE_464[s][0]
                assert plan == TABLE_464[s][1][shift]


@pytest.mark.parametrize('name', ['swin_m2', 'swin_m4'])
def test_banded_swin_equals_the_whole_map(worlds, name):
    """On every rank, float64: each banded block (unshifted and shifted)
    and patch merge equals the whole map's, forward and backward, and the
    ranks' parameter gradients sum to the whole map's; the wrapping halo
    exchange equals torch.roll of the whole map, forward and backward."""
    ranks = worlds[name]
    sizes = [128, 464] if name == 'swin_m2' else [288, 464]
    want = {f'{mod} stride {s} {size}' for size in sizes
            for s in (4, 8, 16)
            for mod in ('block shift 0', 'block shift 3')
            + (('merge',) if s < 16 else ())} | {'wrap'}
    for got in ranks:
        assert want == set(got['checks'])
        for check, (fwd, bwd) in got['checks'].items():
            assert fwd <= (0.0 if check == 'wrap' else 1e-12), check
            assert bwd <= (0.0 if check == 'wrap' else 1e-12), check
    for check in ranks[0]['param_grads']:
        whole = ranks[0]['param_grads'][check][1]
        parts = [sum(r['param_grads'][check][0][i] for r in ranks)
                 for i in range(len(whole))]
        for part, w in zip(parts, whole):
            torch.testing.assert_close(
                part, w, rtol=0, atol=1e-12 * max(float(w.abs().max()), 1))


def test_rank_maps_hold_their_band(worlds):
    """The full-width Swin-B of swinb_deaotl at 464x64 px, float32: a
    rank's encoder maps, the whole id tokens (the 16x16 id conv reads its
    band's grid cells) and its band's decoded logits equal the whole
    image's."""
    h, w = 464, 64
    whole = {s: -(-h // s) for s in spatial.STRIDES}
    for got in worlds['maps_swinb']:
        rows = got['band_rows']
        assert got['conv_inputs'] and not got['transposed_inputs']
        for level, n in got['conv_inputs']:
            assert n == rows[level][1] - rows[level][0] < whole[level]
        assert got['map_rows'] == [rows[s][1] - rows[s][0]
                                   for s in (4, 8, 16, 16)]
        assert got['logit_rows'] == rows[4][1] - rows[4][0]
        assert got['map_err'] <= 1e-5 and got['token_err'] <= 1e-5
        assert got['logit_err'] <= 1e-5
    assert w == worker.SWIN_WIDTH


@pytest.mark.parametrize('model', MODELS)
def test_swin_models_admitted(model):
    """The knob trains both Swin models (align_corners=False)."""
    exp = replace(get_config('pre_vost', model=model,
                             train_spatial_sharding=True),
                  mesh_shape=(1, 2), mesh_axes=('data', 'model'))
    assert not exp.model.align_corners
    engine = TrainEngine(build_vos_model(exp.model, device='cpu'), exp,
                         World(size=2, tp=2))
    assert engine.spatial


def test_thin_bands_refused():
    """At 112 px and M = 2 the stride-16 bands hold 4 + 3 rows; the
    shifted windows take 4 rows above rank 0 (from the last band) and 6
    below, and the block refuses the bands before any exchange, naming
    the stage."""
    bands = spatial.make_bands((112, 64), World(rank=0, size=2))
    block = SwinBlock(128, 8, WS, SHIFT)
    first, end = bands.rows(16)
    x = torch.zeros(1, (end - first) * 4, 128)
    with spatial.banded(bands), pytest.raises(
            ValueError, match="Swin stage 2's shifted windows at stride 16"
                              ".* too thin"):
        block(x, end - first, 4)
