"""Tensor-parallel training of the port on the CPU: D x M worlds over gloo
against one process, and against the JAX package's (data, model) mesh.

Worlds of 1 x 2 and 2 x 2 ranks (tests/torch_dp_worker.py; the ranks of
a model group take the same rows of the batch, the model's transformer
split over them) train the cases of tests/test_torch_parallel.py's data
parallelism while this process trains them alone on the whole batch.
Bars: losses within 1e-5 at every step (the JAX package's own TP bar is
rtol 2e-5, tests/test_tensor_parallel.py), the gradient norm within 1e-4,
parameters and EMA within 1e-4 after 2 steps and the parameters' change
within 1e-2 of its norm (the data-parallel bars), every rank of the world
alike, and the whole parameters' gradients alike on the ranks of a model
group. The 2 x 2 world's first step, ZeRO-1 on top, equals the JAX
package's Trainer on Mesh((2, 2), ('data', 'model')) handed the world's
averaged gradient, within JAX's TP bars (rtol 5e-4, atol 2e-5). A 1 x 2
checkpoint restores in one process and one process's in the 1 x 2 world.
The gather's backward sums the ranks' gradients before it slices. The
train CLI under `--multihost --mesh 1x2 --zero1` logs one process's loss.
"""
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.train.trainer import Trainer as JaxTrainer
from rmem_ocu_tpu.train.trainer import TrainState as JaxTrainState
from rmem_ocu_tpu.utils.torch_convert import convert_torch_params

import torch_threads  # noqa: F401
import torch_dp_worker as worker
import chip_smoke
from rmem_ocu_tpu_torch import build_vos_model
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.tools import train as train_cli
from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

WORLD_TIMEOUT, GROUP_TIMEOUT = 300, 120
LOSSES = ('loss', 'aux_loss', 'pred_loss', 'frame_losses')


def _cases(root):
    ck = lambda name: os.path.join(root, name)
    one_by_two = [
        dict(kind='gather', name='gather'),
        dict(name='tp_deaot', model='deaott', steps=2, batch=2,
             capture=True, save=ck('ck_tp')),
        dict(name='tp_aot', model='aott', steps=2, batch=2, zero1=True),
        dict(name='tp_restore_one', model='deaott', steps=1, batch=2,
             seed=7, restore=ck('ck_one')),
    ]
    two_by_two = [
        dict(name='tp22_deaot', model='deaott', steps=2, batch=2,
             zero1=True, capture=True),
        dict(name='tp22_aot', model='aott', steps=2, batch=2,
             remat='full'),
    ]
    return one_by_two, two_by_two


TRAIN_CASES = [c['name'] for w in _cases('') for c in w
               if c.get('kind', 'train') == 'train']


def _spec(root, name, cases):
    path = os.path.join(root, f'{name}.json')
    with open(path, 'w') as f:
        json.dump(dict(device='cpu', backend='gloo', timeout=GROUP_TIMEOUT,
                       out=root, cases=cases, tp=2), f)
    return path


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """{case name: (one process, the world)} and the root. Both worlds run
    while this process trains the cases alone."""
    root = str(tmp_path_factory.mktemp('tp'))
    one_by_two, two_by_two = _cases(root)
    worker.run_case(dict(name='one', model='deaott', steps=1, batch=2,
                         save=os.path.join(root, 'ck_one')), World())
    procs = (worker.spawn(2, [worker.__file__,
                              _spec(root, 'w12', one_by_two)])
             + worker.spawn(4, [worker.__file__,
                                _spec(root, 'w22', two_by_two)]))
    try:
        alone = {c['name']: worker.run_case(
            {k: v for k, v in c.items() if k not in ('save', 'restore')},
            World()) for c in one_by_two[1:3] + two_by_two}
    finally:
        worker.wait(procs, WORLD_TIMEOUT)
    alone['tp_restore_one'] = worker.run_case(one_by_two[3], World())
    alone['restore_tp'] = worker.run_case(
        dict(one_by_two[3], name='restore_tp', restore=os.path.join(
            root, 'ck_tp')), World())
    out = {c['name']: (alone.get(c['name']), torch.load(
        worker.digest_path(root, c['name'], n)))
        for cases, n in ((one_by_two, 2), (two_by_two, 4)) for c in cases}
    out['restore_tp'] = (alone['restore_tp'], None)
    return out, root


@pytest.mark.parametrize('name', TRAIN_CASES)
def test_world_trains_as_one_process(worlds, name):
    one, tp = worlds[0][name]
    assert tp['same_on_ranks']
    if 'whole_grads_alike' in tp:
        assert tp['whole_grads_alike']
    for a, b in zip(one['steps'], tp['steps']):
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert b['lr'] == a['lr']
        np.testing.assert_allclose(b['grad_norm'], a['grad_norm'],
                                   rtol=1e-4)
    if 'grads' in tp:
        # each averaged gradient, whole: a part summed wrongly over the
        # group (a factor of M) would hardly move AdamW's update
        for k, g in one['grads'].items():
            torch.testing.assert_close(
                tp['grads'][k], g, rtol=0,
                atol=1e-4 * max(float(g.abs().max()), 1e-6), msg=k)
    torch.testing.assert_close(tp['weights'], one['weights'], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(tp['ema'], one['ema'], rtol=0, atol=1e-4)
    assert torch.equal(tp['weights0'], one['weights0'])
    moved = one['weights'] - one['weights0']
    assert float(moved.norm()) > 0
    assert float((tp['weights'] - tp['weights0'] - moved).norm()
                 ) <= 1e-2 * float(moved.norm())


def test_zero1_splits_the_moments_over_the_data_ranks(worlds):
    """On 2 x 2, each rank holds half of the largest moment (a whole
    encoder weight); on 1 x 2 ZeRO-1 has one data rank and keeps it
    whole."""
    whole, held = worlds[0]['tp22_deaot'][1]['largest_moment']
    assert held * 2 == whole
    assert worlds[0]['tp_aot'][1]['largest_moment'] == (whole, whole)


def test_checkpoints_restore_across_meshes(worlds):
    """The 1 x 2 world writes the layout of one process (every tensor
    whole), one process restores it bitwise, and the 1 x 2 world restores
    one process's checkpoint."""
    digests, root = worlds
    saved, _ = ckpt.restore_checkpoint(os.path.join(root, 'ck_tp'))
    one, _ = ckpt.restore_checkpoint(os.path.join(root, 'ck_one'))
    for part in ('state_dict', 'ema'):
        assert {k: v.shape for k, v in saved[part].items()} == {
            k: v.shape for k, v in one[part].items()}
    for m in ('mu', 'nu'):
        assert {k: v.shape for k, v in saved['opt_state'][m].items()} == {
            k: v.shape for k, v in one['opt_state'][m].items()}
    assert digests['restore_tp'][0]['restored_equal']
    assert digests['tp_restore_one'][1]['restored_equal']
    a, b = digests['tp_restore_one']
    np.testing.assert_allclose(b['steps'][0]['loss'], a['steps'][0]['loss'],
                               rtol=0, atol=1e-5)


def test_gather_backward_sums_then_slices(worlds):
    """y = gather(x_r) feeds y * A_r on each rank r: autograd through the
    whole tensor gives sum_r A_r, and each rank's gradient of its shard is
    its slice of that (a backward that only sliced would give A_r's)."""
    got = worlds[0]['gather'][1]
    whole, weights = worker.gather_operands(2)
    w = whole.clone().requires_grad_()
    sum((w * a).sum() for a in weights).backward()
    torch.testing.assert_close(got['y'], whole, rtol=0, atol=0)
    torch.testing.assert_close(got['grad'], w.grad, rtol=0, atol=1e-12)
    assert not torch.allclose(got['grad'], weights[0])


def _close_leaf(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=5e-4,
                               atol=2e-5, err_msg=name)


def test_tp_step_matches_jax_mesh(worlds):
    """The JAX package's Trainer with ZeRO-1 on Mesh((2, 2), ('data',
    'model')), from the world's initial weights, takes one step from the
    2 x 2 world's averaged gradient (its episode replaced by a loss with
    that gradient): its parameters are the world's after its first step
    within JAX's TP bars, its LSTT moments split over both axes, and its
    learning rate and gradient norm are the world's."""
    two = worlds[0]['tp22_deaot'][1]
    case = _cases('')[1][0]
    exp = worker.exp_of(case)
    jexp = replace(jax_get_config('pre_vost', model=case['model'],
                                  data_seq_len=worker.T,
                                  train_total_steps=100),
                   train_long_term_mem_gap=1, train_zero1=True)
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
    both = [x for x in jax.tree_util.tree_leaves(state.opt_state)
            if x.ndim and {'data', 'model'} <= set(
                getattr(x.sharding, 'spec', P()))]
    assert both
    got = params_from_flax(jax.device_get(state.params), exp.model)
    for name, p in two['params_1'].items():
        _close_leaf(p, got[name], name)
    assert step0['lr'] == float(jmetrics['lr'])
    assert step0['grad_norm'] == pytest.approx(float(jmetrics['grad_norm']),
                                               rel=1e-5)


# ------------------------------------------------------------- the CLI
CLI_ARGS = ['--stage', 'default', '--model', 'aott', '--exp_name', 'tp',
            '--datasets', 'vost', '--crop_size', '65', '--seq_len', '3',
            '--log_step', '1', '--save_step', '2', '--total_steps', '2',
            '--fix_random', '--device', 'cpu', '--batch_size', '1']
RESULT = os.path.join('results', 'tp_aott', 'default')


def test_train_cli_mesh_1x2(tmp_path):
    """`--multihost --mesh 1x2 --zero1` in two processes logs the loss of
    one process on the same sample, and its checkpoint is whole."""
    tree = str(tmp_path / 'vost')
    chip_smoke.write_vost_tree(tree, (48, 64), 6, n_train=2)
    two, one = tmp_path / 'two', tmp_path / 'one'
    two.mkdir()
    one.mkdir()
    procs = worker.spawn(2, ['-m', 'rmem_ocu_tpu_torch.tools.train',
                             *CLI_ARGS, '--data_root', tree, '--multihost',
                             '--mesh', '1x2', '--zero1', '--backend',
                             'gloo'], cwd=str(two))
    old = os.getcwd()
    try:
        os.chdir(one)
        train_cli.main(CLI_ARGS + ['--data_root', tree])
    finally:
        os.chdir(old)
        outs = worker.wait(procs, WORLD_TIMEOUT)

    def rows(d):
        with open(d / RESULT / 'metrics.jsonl') as f:
            return [json.loads(line) for line in f]
    got, want = rows(two), rows(one)
    assert [r['step'] for r in got] == [1, 2]
    for a, b in zip(got, want):
        for k in ('loss', 'aux_loss', 'pred_loss'):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), k
    assert '[0] fix random seed 1' in outs[0]
    assert '[0] fix random seed 1' in outs[1]
    saved, _ = ckpt.restore_checkpoint(str(two / RESULT / 'ckpt'))
    mine, _ = ckpt.restore_checkpoint(str(one / RESULT / 'ckpt'))
    for part in ('state_dict', 'ema'):
        assert {k: v.shape for k, v in saved[part].items()} == {
            k: v.shape for k, v in mine[part].items()}
    ema, _ = ckpt.restore_checkpoint(str(two / RESULT / 'ema_ckpt'))
    assert {k: v.shape for k, v in ema['state_dict'].items()} == {
        k: v.shape for k, v in mine['ema'].items()}
