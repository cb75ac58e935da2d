"""Data-parallel training of the port on the CPU: two ranks over gloo
against one process, and against the JAX package.

Two processes (tests/torch_dp_worker.py) train each case as one world of
two ranks, one sample a rank, while this process trains it alone on both
samples; drop-path (0.1) and the id shuffle are on, so a rank must draw
its rows of the one process's masks. Bars: losses within 1e-5 (and the
ious of the first step; later ones count pixels of an argmax that
rounding may flip, 1e-3), parameters and EMA within 1e-4 after 2 steps
(the JAX package's own multi-process bars, tests/test_multihost.py), the
parameters' change within 1e-2 of its L2 norm, and both ranks bitwise
alike. AdamW's first steps move each parameter by about +-lr whatever the
size of its gradient, so gradients that rounding alone makes (the
trainable BatchNorm's, whose batch moments nearly cancel them) move
parameters by ~lr in either world (3.4e-3 of the change's norm for
DeAOT-T here): the trainable-BN case trains with SGD, linear in the
gradient. ZeRO-1 equals the plain step within 2e-5, and each rank holds
half of the largest moment. A ZeRO-1 checkpoint of the world of two
restores in both worlds, a checkpoint of one process in the world of two,
and a save whose first write fails on rank 0 lands in the backup root on
both ranks. The world's first ZeRO-1 step equals the JAX package's step
on a 2-device data mesh with ZeRO-1, handed the world's averaged
gradient, as tests/test_torch_trainer.py hands it one process's. The
train CLI under `--multihost --mesh 2 --zero1` logs the loss of one
process on both samples and writes its files once; the eval CLI in two
processes writes the masks of one.
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
from rmem_ocu_tpu.parallel import tp as jtp
from rmem_ocu_tpu.train.trainer import Trainer as JaxTrainer
from rmem_ocu_tpu.train.trainer import TrainState as JaxTrainState
from rmem_ocu_tpu.utils.torch_convert import convert_torch_params

import torch_threads  # noqa: F401
import torch_dp_worker as worker
import chip_smoke
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.engine import train_engine
from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
from rmem_ocu_tpu_torch.ops.layers import keep_mask, noise_from
from rmem_ocu_tpu_torch.ops.masks import generate_permute_matrix
from rmem_ocu_tpu_torch.parallel import tp
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.tools import eval as eval_cli
from rmem_ocu_tpu_torch.tools import train as train_cli
from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

# seconds: the spawned world, and its process group's own limit
WORLD_TIMEOUT, GROUP_TIMEOUT = 300, 120
LOSSES = ('loss', 'aux_loss', 'pred_loss', 'frame_losses')
IOUS = ('iou', 'frame_ious')


def _cases(root):
    ck = lambda name: os.path.join(root, name)
    return [
        dict(name='dp_deaot', model='deaott', steps=2, batch=2),
        dict(name='dp_aot', model='aott', steps=2, batch=2),
        dict(name='zero1', model='deaott', steps=2, batch=2, zero1=True,
             capture=True, save=ck('ck_zero1')),
        dict(name='bn', model='deaott', steps=2, batch=2, remat='full',
             zero1=True, overrides=dict(freeze_bn=False, train_opt='sgd')),
        dict(name='restore_zero1', model='deaott', steps=1, batch=2,
             zero1=True, seed=7, restore=ck('ck_zero1')),
        dict(name='restore_one', model='deaott', steps=1, batch=2,
             zero1=True, seed=7, restore=ck('ck_one'), save=ck('ck_flaky'),
             flaky_save=True),
    ]


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """{case name: (digest of one process, digest of the world of two)}.
    The world of two runs while this process runs the cases that need
    nothing of it."""
    root = str(tmp_path_factory.mktemp('dp'))
    cases = _cases(root)
    # a checkpoint of one process, the layout single-process training
    # writes
    worker.run_case(dict(name='one', model='deaott', steps=1, batch=2,
                         save=os.path.join(root, 'ck_one')), World())
    spec = os.path.join(root, 'spec.json')
    with open(spec, 'w') as f:
        json.dump(dict(device='cpu', backend='gloo', timeout=GROUP_TIMEOUT,
                       out=root, cases=cases), f)
    procs = worker.spawn(2, [worker.__file__, spec])
    try:
        alone = {c['name']: worker.run_case(
            {k: v for k, v in c.items() if k not in ('save', 'flaky_save')},
            World()) for c in cases if 'restore' not in c
            or c['name'] == 'restore_one'}
    finally:
        worker.wait(procs, WORLD_TIMEOUT)
    alone['restore_zero1'] = worker.run_case(cases[4], World())
    return {c['name']: (alone[c['name']], torch.load(
        worker.digest_path(root, c['name'], 2))) for c in cases}, root


@pytest.mark.parametrize('shape,taken,dp,want', [
    ((16, 4), (), 8, 0), ((4, 16), (), 8, 1), ((8, 64), (1,), 8, 0),
    ((3, 5), (), 8, None), ((), (), 8, None)])
def test_zero1_dim_matches_jax(shape, taken, dp, want):
    """The cases of tests/test_zero1.py (a dimension the tensor-parallel
    spec takes is skipped)."""
    spec = P(*[('model' if d in taken else None) for d in range(len(shape))])
    got = tp.zero1_dim(shape, taken, dp)
    assert got == want
    jspec = jtp._zero1_spec(spec, shape, dp)
    assert [i for i, e in enumerate(jspec) if e == 'data'] == (
        [] if got is None else [got])


def test_zero1_dim_matches_jax_on_random_shapes():
    rs = np.random.RandomState(0)
    for _ in range(300):
        shape = tuple(int(n) for n in rs.choice(
            [1, 2, 3, 4, 6, 8, 12, 16, 24, 256], size=rs.randint(0, 5)))
        dp = int(rs.choice([1, 2, 3, 4, 8]))
        got = tp.zero1_dim(shape, (), dp)
        jspec = jtp._zero1_spec(P(), shape, dp)
        assert [i for i, e in enumerate(jspec) if e == 'data'] == (
            [] if got is None else [got]), (shape, dp)


def test_noise_is_the_ranks_rows_of_the_world_draw():
    """Dropout and drop-path masks: a rank of two draws rows
    [rank*B, (rank+1)*B) of one process's draw of 2B, and the generator
    moves on alike; so does a batch-major flattening such as B*T."""
    like = torch.zeros(())
    for shape in ((2, 3, 4), (6, 1, 5)):
        whole_gen = torch.Generator().manual_seed(5)
        with noise_from(whole_gen):
            whole = keep_mask((2 * shape[0],) + shape[1:], 0.7, like)
            after = torch.rand(3, generator=whole_gen)
        for rank in (0, 1):
            gen = torch.Generator().manual_seed(5)
            with noise_from(gen, rank, 2):
                part = keep_mask(shape, 0.7, like)
            n = shape[0]
            assert torch.equal(part, whole[rank * n:(rank + 1) * n])
            assert torch.equal(torch.rand(3, generator=gen), after)


def test_id_shuffle_is_the_ranks_rows_of_the_world_draw(monkeypatch):
    """The episode of rank r of two shuffles its samples' ids by rows
    [2r, 2r + 2) of the permutations one process draws for four."""
    seen = []
    real = train_engine.shuffle_one_hot
    monkeypatch.setattr(train_engine, 'shuffle_one_hot',
                        lambda oh, perm: seen.append(perm) or real(oh, perm))
    exp = worker.exp_of(_cases('')[0])
    model = build_vos_model(exp.model, device='cpu', exp=exp).train()
    batch = worker.rank_rows(worker.global_batch(2, 0), 0, 1, 'cpu')
    whole = generate_permute_matrix(exp.model.max_obj_num + 1, 4,
                                    torch.Generator().manual_seed(2))
    for rank in (0, 1):
        TrainEngine(model, exp, World(rank=rank, size=2)).episode_loss(
            batch['frames'], batch['masks'], batch['obj_nums'], 0,
            torch.Generator().manual_seed(2))
        assert torch.equal(seen[-1], whole[2 * rank:2 * rank + 2])


@pytest.mark.parametrize('name', [c['name'] for c in _cases('')])
def test_world_of_two_trains_as_one_process(worlds, name):
    """Losses within 1e-5 at every step; the ious of the first step, from
    the same weights, within 1e-5, and later ones within 1e-3 (they count
    pixels of an argmax, which the worlds' rounding may flip)."""
    one, two = worlds[0][name]
    assert two['same_on_ranks']
    for i, (a, b) in enumerate(zip(one['steps'], two['steps'])):
        for k in LOSSES + IOUS:
            np.testing.assert_allclose(
                b[k], a[k], rtol=0, atol=1e-3 if i and k in IOUS else 1e-5,
                err_msg=k)
        assert b['lr'] == a['lr']
    np.testing.assert_allclose(two['steps'][0]['grad_norm'],
                               one['steps'][0]['grad_norm'], rtol=1e-4)
    torch.testing.assert_close(two['weights'], one['weights'], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(two['ema'], one['ema'], rtol=0, atol=1e-4)
    # the learning rate keeps every step under ~5e-5 here, so the bar above
    # holds the parameters' change loosely: hold the change itself too
    assert torch.equal(two['weights0'], one['weights0'])
    moved = one['weights'] - one['weights0']
    assert float(moved.norm()) > 0
    assert float((two['weights'] - two['weights0'] - moved).norm()
                 ) <= 1e-2 * float(moved.norm())


def test_zero1_equals_the_plain_step(worlds):
    plain, zero1 = worlds[0]['dp_deaot'][1], worlds[0]['zero1'][1]
    for a, b in zip(plain['steps'], zero1['steps']):
        assert a['loss'] == b['loss']
    torch.testing.assert_close(zero1['weights'], plain['weights'], rtol=0,
                               atol=2e-5)
    torch.testing.assert_close(zero1['ema'], plain['ema'], rtol=0,
                               atol=2e-5)
    # each rank holds half of the largest moment, the whole without ZeRO-1
    whole, held = zero1['largest_moment']
    assert held * 2 == whole
    assert plain['largest_moment'] == (whole, whole)
    assert worlds[0]['bn'][1]['largest_moment'] == (whole, whole // 2)


def test_checkpoints_restore_across_worlds(worlds):
    """The world of two writes the layout of one process (moments whole),
    each world restores it bitwise, the world of two restores one
    process's checkpoint, and a failed first write on rank 0 sends both
    ranks to the backup root."""
    digests, root = worlds
    saved, step = ckpt.restore_checkpoint(os.path.join(root, 'ck_zero1'))
    one, _ = ckpt.restore_checkpoint(os.path.join(root, 'ck_one'))
    assert step == 2 and saved['step'] == 2
    for part in ('state_dict', 'ema'):
        assert {k: v.shape for k, v in saved[part].items()} == {
            k: v.shape for k, v in one[part].items()}
    for m in ('mu', 'nu'):
        assert {k: v.shape for k, v in saved['opt_state'][m].items()} == {
            k: v.shape for k, v in one['opt_state'][m].items()}
    assert digests['restore_zero1'][0]['restored_equal']
    assert digests['restore_zero1'][1]['restored_equal']
    assert digests['restore_one'][1]['restored_equal']
    flaky = digests['restore_one'][1]
    assert flaky['saved_alike']
    assert flaky['saved_to'] == ckpt.step_path(
        ckpt.backup_root_for(os.path.join(root, 'ck_flaky')), 2)
    assert ckpt.list_checkpoint_steps(os.path.join(root, 'ck_flaky')) == []
    assert ckpt.restore_checkpoint(os.path.join(root, 'ck_flaky'))[1] == 2


def _close_leaf(got, want, tol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


def test_world_step_matches_jax_data_mesh(worlds):
    """The JAX package's Trainer with ZeRO-1 on a 2-device `data` mesh,
    from the world's initial weights, takes one step from the world's
    averaged gradient (its episode replaced by a loss with that gradient):
    its parameters are the world's after its first ZeRO-1 step within
    1e-6 of each leaf's largest magnitude, its moments are sharded over
    the mesh, and its learning rate and gradient norm are the world's."""
    two = worlds[0]['zero1'][1]
    case = _cases('')[2]
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
    jtrainer = JaxTrainer(jmodel, jexp, mesh=Mesh(
        np.asarray(jax.devices()[:2]), ('data',)))
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
    batch = worker.global_batch(2, 3)
    state, jmetrics = jtrainer.train_step(state, batch,
                                          jax.random.PRNGKey(1))
    sharded = [x for x in jax.tree_util.tree_leaves(state.opt_state)
               if x.ndim and 'data' in getattr(x.sharding, 'spec', P())]
    assert sharded
    got = params_from_flax(jax.device_get(state.params), exp.model)
    for name, p in two['params_1'].items():
        _close_leaf(p, got[name], 1e-6, name)
    assert step0['lr'] == float(jmetrics['lr'])
    # XLA's f32 sums of squares over leaves of ~1e6 elements land 3.4e-6
    # off the float64 norm here, torch's 6e-8
    assert step0['grad_norm'] == pytest.approx(float(jmetrics['grad_norm']),
                                               rel=1e-5)


# ------------------------------------------------------------- the CLIs
TREE_SIZE, TREE_FRAMES = (48, 64), 6
CLI_ARGS = ['--stage', 'default', '--model', 'aott', '--exp_name', 'dp',
            '--datasets', 'vost', '--crop_size', '65', '--seq_len', '3',
            '--log_step', '1', '--save_step', '2', '--total_steps', '2',
            '--fix_random', '--device', 'cpu']
RESULT = os.path.join('results', 'dp_aott', 'default')


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """The train CLI in a world of two (one sample a rank, ZeRO-1) and in
    one process (two samples), each in its own directory; then the eval
    CLI of the world's EMA checkpoint in two processes and in one."""
    root = tmp_path_factory.mktemp('cli')
    tree = str(root / 'vost')
    chip_smoke.write_vost_tree(tree, TREE_SIZE, TREE_FRAMES, n_train=4)
    two, one = root / 'two', root / 'one'
    two.mkdir()
    one.mkdir()
    procs = worker.spawn(2, ['-m', 'rmem_ocu_tpu_torch.tools.train',
                             *CLI_ARGS, '--data_root', tree, '--batch_size',
                             '1', '--multihost', '--mesh', '2', '--zero1'],
                         cwd=str(two))
    old = os.getcwd()
    try:
        os.chdir(one)
        train_cli.main(CLI_ARGS + ['--data_root', tree, '--batch_size', '2'])
    finally:
        os.chdir(old)
        train_outs = worker.wait(procs, WORLD_TIMEOUT)
    ema = str(two / RESULT / 'ema_ckpt')
    eval_args = ['--stage', 'default', '--model', 'aott', '--exp_name', 'dp',
                 '--dataset', 'vost', '--data_root', tree, '--max_size', '65',
                 '--ckpt_path', ema, '--device', 'cpu', '--output']
    procs = worker.spawn(2, ['-m', 'rmem_ocu_tpu_torch.tools.eval',
                             *eval_args, str(root / 'eval_two')],
                         cwd=str(two))
    try:
        os.chdir(one)
        eval_cli.main(eval_args + [str(root / 'eval_one')])
    finally:
        os.chdir(old)
        worker.wait(procs, WORLD_TIMEOUT)
    return root, train_outs


def _rows(result):
    with open(result / 'metrics.jsonl') as f:
        return [json.loads(line) for line in f]


def test_train_cli_world_of_two(cli_runs):
    """Rank 0 alone writes print.log, metrics.jsonl, config.json and the
    code snapshot; the rows hold the loss of one process on both samples;
    both ranks print it; each rank seeds python and numpy from
    1 << rank."""
    root, outs = cli_runs
    two, one = root / 'two' / RESULT, root / 'one' / RESULT
    rows, want = _rows(two), _rows(one)
    assert [r['step'] for r in rows] == [1, 2]
    for a, b in zip(rows, want):
        for k in ('loss', 'aux_loss', 'pred_loss', 'iou'):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), k
        np.testing.assert_allclose(a['frame_losses'], b['frame_losses'],
                                   rtol=0, atol=1e-5)
    for name in ('config.json', 'code_snapshot/tools/train.py',
                 'ckpt/step_2/state.pth', 'ema_ckpt/step_2/state.pth'):
        assert (two / name).is_file(), name
    with open(two / 'print.log') as f:
        log = f.read()
    assert log.count('step 1/2') == 1
    assert '[0] fix random seed 1' in outs[0]
    assert '[1] fix random seed 2' in outs[1]
    for out in outs:
        assert f'loss {rows[0]["loss"]:.4f}' in out
    saved, _ = ckpt.restore_checkpoint(str(two / 'ckpt'))
    mine, _ = ckpt.restore_checkpoint(str(one / 'ckpt'))
    assert {k: v.shape for k, v in saved['opt_state']['mu'].items()} == {
        k: v.shape for k, v in mine['opt_state']['mu'].items()}


def test_eval_cli_world_of_two(cli_runs):
    """Each rank evaluates its share of the sequences; together they write
    the masks of one process, file for file, and rank 0 the log."""
    root, _ = cli_runs
    from PIL import Image
    two, one = root / 'eval_two', root / 'eval_one'
    seqs = sorted(p.name for p in one.iterdir() if p.is_dir())
    assert seqs == ['val0', 'val1']
    for seq in seqs:
        names = sorted(os.listdir(one / seq))
        assert names == sorted(os.listdir(two / seq))
        assert len(names) == TREE_FRAMES
        for name in names:
            assert np.array_equal(np.asarray(Image.open(two / seq / name)),
                                  np.asarray(Image.open(one / seq / name)))
    with open(two / 'print.log') as f:
        log = f.read()
    assert '[rank 0]' in log and '[rank 1]' not in log


def _unbanded_model():
    """A model whose config names an encoder the bands do not know (every
    registered encoder is banded)."""
    model = build_vos_model(get_config('pre_vost', model='r50_deaotl').model,
                            device='cpu')
    model.cfg = replace(model.cfg, encoder='swin_large')
    return model


@pytest.mark.parametrize('call,error', [
    (lambda: train_cli.main(CLI_ARGS + ['--mesh', '2']),
     'torchrun --nproc_per_node 2'),
    (lambda: train_cli.main(CLI_ARGS + ['--mesh', '2x2']),
     'torchrun --nproc_per_node 4 .* --mesh 2x2'),
    (lambda: eval_cli.main(['--mesh', '3', '--device', 'cpu']),
     'torchrun --nproc_per_node 3 .* --mesh 3'),
    (lambda: TrainEngine(_unbanded_model(), replace(
        get_config('pre_vost', model='r50_deaotl'),
        train_spatial_sharding=True, mesh_shape=(1, 2),
        mesh_axes=('data', 'model')), World(size=2, tp=2)),
     'encoder .*swin_large.*: bands are ported for .*swin_base'),
    (lambda: train_cli.main(CLI_ARGS + ['--multihost', '--mesh', '3']),
     'torchrun --nproc_per_node 3'),
], ids=['mesh_without_group', 'mesh_dxm', 'eval_mesh', 'spatial',
        'mesh_not_the_world'])
def test_refusals_name_the_way(call, error, monkeypatch):
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '0')
    with pytest.raises((SystemExit, NotImplementedError), match=error):
        call()

