"""The PyTorch port's train step and optimizer pieces against the JAX
package, on the CPU.

One AdamW step of `Trainer.train_step` on deaott against the JAX
`Trainer.train_step`, from the same weights, in the seq-training phase
from step 0 (the memory takes the prediction, the id bank freezes), with
one fixed id permutation. The JAX step is handed the port's episode: a
loss whose gradient is the port's episode gradient (the episode gradient
itself is held against the JAX package's in
tests/test_torch_train_engine.py; this file holds what the trainer does
with it). Then both steps zero the frozen gradients, clip, update and
move the EMA from the same numbers. Bars: the parameters after the step
and the EMA within 1e-6 of each leaf's largest magnitude, the learning
rate exact in f32, the gradient norm within 1e-6. (Held end to end, the
step would hinge on the sign of every small gradient element: Adam's
first step moves each by +-lr, and with random weights a ReLU input
within the packages' rounding difference of 0 flips some of those signs;
CHANGES.md.)

The optimizer pieces on small synthetic parameter dicts against the JAX
functions, with no model: SGD, the learning-rate schedule, AdamW's clip,
Adam and decoupled decay, and the EMA; the parameter masks (weight decay,
encoder group, freezing) on every encoder family's real parameter names.
"""
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.train import optim as joptim
from rmem_ocu_tpu.train.trainer import Trainer as JaxTrainer
from rmem_ocu_tpu.utils.torch_convert import convert_torch_params

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.engine import train_engine
from rmem_ocu_tpu_torch.models.vos_model import VOSModel, zero_dropout
from rmem_ocu_tpu_torch.train import optim
from rmem_ocu_tpu_torch.train.trainer import Trainer
from rmem_ocu_tpu_torch.utils.convert import flax_key_map, params_from_flax

SIZE, T = 49, 3
def _close_leaf(got, want, tol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


@pytest.fixture(scope='module')
def one_step():
    kw = dict(data_seq_len=T, train_total_steps=100,
              train_lstt_droppath=0.0, train_seq_training_start_ratio=0.0)
    jexp = replace(jax_get_config('pre_vost', model='deaott', **kw),
                   train_long_term_mem_gap=1)
    exp = replace(get_config('pre_vost', model='deaott', **kw),
                  train_long_term_mem_gap=1)
    rs = np.random.RandomState(12)
    frames = rs.randn(2, T, SIZE, SIZE, 3).astype(np.float32)
    masks = (rs.rand(2, T, SIZE, SIZE) * 3).astype(np.int32)
    obj_nums = np.array([2, 1], np.int32)
    perm = np.eye(11, dtype=np.float32)[[0, 3, 1, 2, 5, 4, 6, 7, 10, 8, 9]]
    perm = np.stack([perm, np.eye(11, dtype=np.float32)[
        [0, 2, 1, 3, 4, 5, 6, 7, 8, 9, 10]]])

    jmodel = jax_build(jexp.model, jexp)
    jtrainer = JaxTrainer(jmodel, jexp, mesh=Mesh(
        np.asarray(jax.devices()[:1]), ('data',)))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jnp.asarray(frames),
                                 jnp.asarray(masks), jit_init=True)
    params0 = jax.device_get(jstate.params)

    model = build_vos_model(exp.model, device='cpu', exp=exp)
    model.load_state_dict(params_from_flax(params0, exp.model), strict=True)
    zero_dropout(model)
    trainer = Trainer(model, exp)
    seen = []
    mp = pytest.MonkeyPatch()
    mp.setattr(train_engine, 'generate_permute_matrix',
               lambda dim, batch, generator, device=None:
               torch.from_numpy(perm).to(device))
    norm = optim.global_norm
    mp.setattr(optim, 'global_norm', lambda g: seen.append(dict(g)) or norm(g))
    try:
        state, metrics = trainer.train_step(
            trainer.init_state(),
            {'frames': torch.from_numpy(frames),
             'masks': torch.from_numpy(masks),
             'obj_nums': torch.from_numpy(obj_nums)},
            torch.Generator().manual_seed(1))
    finally:
        mp.undo()
    grads = {k: v.numpy() for k, v in seen[0].items()}
    gtree, _ = convert_torch_params(
        grads, jax.tree_util.tree_map(np.zeros_like, params0), jexp.model,
        strict=False)

    def port_episode(p, *args, **kw):
        """A loss whose gradient is the port's episode gradient, with the
        port episode's outputs."""
        loss = sum(jnp.sum(a * b) for a, b in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(gtree)))
        return loss, {
            'aux_loss': jnp.asarray(float(metrics['aux_loss'])),
            'pred_loss': jnp.asarray(float(metrics['pred_loss'])),
            'iou': jnp.asarray(float(metrics['iou'])),
            'frame_losses': jnp.asarray(metrics['frame_losses'].numpy()),
            'frame_ious': jnp.asarray(metrics['frame_ious'].numpy()),
            'final_pred_mask': jnp.asarray(metrics['pred_mask'].numpy())}
    jtrainer.engine.episode_loss = port_episode
    jstate, jmetrics = jtrainer.train_step(
        jstate, {'frames': frames, 'masks': masks, 'obj_nums': obj_nums},
        jax.random.PRNGKey(1))
    cfg = exp.model
    return dict(model=model, trainer=trainer, state=state, metrics=metrics,
                params0=params_from_flax(params0, cfg),
                jparams=params_from_flax(jax.device_get(jstate.params), cfg),
                jema=params_from_flax(jax.device_get(jstate.ema_params),
                                      cfg),
                jmetrics=jax.device_get(jmetrics))


def test_train_step_params_match_jax(one_step):
    moved = 0
    for name, p in one_step['model'].named_parameters():
        _close_leaf(p.detach(), one_step['jparams'][name], 1e-6, name)
        moved += not torch.equal(p.detach(), one_step['params0'][name])
    assert moved > 0


def test_train_step_freezes_like_jax(one_step):
    """The encoder's first stages (train_encoder_freeze_at=2) and, in the
    seq-training phase, the id bank do not move, and are
    requires_grad=False; the rest of the model does move."""
    model = one_step['model']
    frozen = one_step['trainer'].masks(('patch_wise_id_bank',)).frozen
    assert frozen['patch_wise_id_bank.weight']
    assert frozen['encoder.features.0.0.weight']
    assert not frozen['encoder.features.4.conv.0.0.weight']
    for name, p in model.named_parameters():
        if frozen[name]:
            assert torch.equal(p.detach(), one_step['params0'][name]), name
        assert p.requires_grad == (not frozen[name])


def test_train_step_ema_matches_jax(one_step):
    ema = one_step['state'].ema
    assert set(ema) == set(one_step['model'].state_dict())
    for name, value in ema.items():
        _close_leaf(value, one_step['jema'][name], 1e-6, name)


def test_train_step_metrics_match_jax(one_step):
    m, jm = one_step['metrics'], one_step['jmetrics']
    assert m['lr'] == float(jm['lr'])
    assert float(m['grad_norm']) == pytest.approx(float(jm['grad_norm']),
                                                  rel=1e-6)
    assert float(m['grad_norm']) > 0
    assert set(m) == set(jm)
    assert tuple(m['pred_mask'].shape) == (2, SIZE, SIZE)
    assert m['frame_losses'].shape == (T - 1,)
    assert m['frame_ious'].shape == (T,)
    assert one_step['state'].step == 1


# ------------------------------------------------------ synthetic pieces
def _tree(rs, scale=1.0):
    """A flax-style tree and the same arrays under the port's names:
    an encoder kernel, a head kernel and bias, a 1-D norm scale."""
    arrs = {'encoder.conv1.weight': rs.randn(4, 4) * scale,
            'head.weight': rs.randn(3, 4) * scale,
            'head.bias': rs.randn(3) * scale,
            'norm.weight': rs.randn(4) * scale}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    tree = {'params': {
        'encoder': {'conv1': {'kernel': arrs['encoder.conv1.weight']}},
        'head': {'kernel': arrs['head.weight'], 'bias': arrs['head.bias']},
        'norm': {'scale': arrs['norm.weight']}}}
    return jax.tree_util.tree_map(jnp.asarray, tree), {
        k: torch.from_numpy(v) for k, v in arrs.items()}


def _flat(tree):
    t = jax.device_get(tree)['params']
    return {'encoder.conv1.weight': t['encoder']['conv1']['kernel'],
            'head.weight': t['head']['kernel'], 'head.bias': t['head']['bias'],
            'norm.weight': t['norm']['scale']}


@pytest.mark.parametrize('opt', ['sgd', 'adamw'])
def test_optimizer_steps_match_jax(opt):
    """Four steps of the JAX package's chain (clip, then SGD with L2 and
    Nesterov momentum, or Adam and decoupled decay; per-group learning
    rates) and the EMA against the port's, on a synthetic tree whose
    gradients clip on some steps."""
    exp = replace(jax_get_config('pre_vost', model='aott'), train_opt=opt,
                  train_total_steps=100, train_encoder_freeze_at=0,
                  train_lr_warm_up_ratio=0.02)
    rs = np.random.RandomState(0)
    jparams, params = _tree(rs)
    tx = joptim.make_optimizer(exp, jparams)
    jopt = tx.init(jparams)
    jmasks = joptim.make_masks(jparams, exp)
    masks = optim.ParamMasks(
        wd={k: 0.0 if v.dim() <= 1 else exp.train_weight_decay
            for k, v in params.items()},
        is_enc={k: k.startswith('encoder.') for k in params},
        frozen={k: False for k in params})
    state = optim.init_opt_state(params, exp)
    jema, ema = jparams, dict(params)
    decay = 0.9
    for step in range(4):
        jgrads, grads = _tree(rs, scale=0.5 if step % 2 else 4.0)
        lr = optim.schedule_lr(step, exp)
        assert lr == float(joptim.schedule_lr(step, exp))
        updates, jopt = tx.update(jgrads, jopt, jparams)
        jparams = joptim.apply_updates(jparams, updates, jmasks, lr, exp)
        jema = joptim.ema_update(jema, jparams, step + 1, decay)
        if opt == 'sgd':
            upd, state = optim.sgd_update(
                optim.clip_by_global_norm(grads, exp.train_clip_grad_norm),
                state, params, masks, exp)
        else:
            upd, state = optim.adam_update(
                optim.clip_by_global_norm(grads, exp.train_clip_grad_norm),
                state)
        params = optim.apply_updates(params, upd, masks, lr, exp)
        ema = optim.ema_update(ema, params, step + 1, decay)
        for name, want in _flat(jparams).items():
            _close_leaf(params[name], want, 1e-6, name)
        for name, want in _flat(jema).items():
            _close_leaf(ema[name], want, 1e-6, name)
    assert float(optim.global_norm(grads)) == pytest.approx(
        float(optax.global_norm(jgrads)), rel=1e-6)


@pytest.mark.parametrize('overrides', [
    {}, dict(train_lr_cosine_decay=True), dict(train_lr_restart=3),
    dict(train_lr_warm_up_ratio=0.0, train_lr_power=2.0)],
    ids=['poly', 'cosine', 'restarts', 'no_warmup'])
def test_schedule_lr_matches_jax(overrides):
    exp = replace(jax_get_config('pre_vost_2', model='r50_deaotl'),
                  **overrides)
    for step in (0, 1, 499, 500, 501, 6666, 6667, 6668, 13_000, 19_999,
                 20_000):
        assert optim.schedule_lr(step, exp) == float(
            joptim.schedule_lr(step, exp)), step


MASK_CASES = [
    ('deaott', {}, ()),
    ('deaott', dict(train_encoder_freeze_at=4), ('patch_wise_id_bank',)),
    ('r50_deaotl', dict(train_encoder_freeze_at=3), ()),
    ('r50_deaotl', dict(freeze_except_temporal_pe=True), ()),
    ('r50_aotl', dict(gru_memory=True, freeze_except_gru=True), ()),
    ('swinb_aotl', dict(train_encoder_freeze_at=3), ()),
    ('aotl', dict(encoder='mobilenetv3', encoder_dim=(24, 40, 112, 960),
                  train_encoder_freeze_at=3), ()),
    ('rs101_aotl', dict(train_encoder_freeze_at=2), ()),
    ('r50_topdown_aotl', dict(freeze_backbone=True), ()),
    ('deaott', dict(freeze_bn=False), ()),
]


@pytest.mark.parametrize('model,overrides,extra', MASK_CASES,
                         ids=[f'{m}-{i}' for i, (m, _, _)
                              in enumerate(MASK_CASES)])
def test_make_masks_match_jax(model, overrides, extra):
    """Weight decay, encoder group and freezing of every parameter, by the
    JAX package's rules on its own parameter paths and by the port's on
    the torch names, for each encoder family and freeze recipe."""
    jexp = jax_get_config('pre_vost_2', model=model, **overrides)
    exp = get_config('pre_vost_2', model=model, **overrides)
    size = 33 if jexp.model.align_corners else 32
    shapes = jax.eval_shape(
        jax_build(jexp.model).init, jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, size, size, jexp.model.id_dim)))
    tree = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                  {'params': shapes['params']})
    jmasks = joptim.make_masks(tree, jexp, extra)
    names = flax_key_map(tree, exp.model)
    want = [{}, {}, {}]
    for kind, jtree in enumerate(jmasks):
        for kp, value in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            path = '/'.join(k.key for k in kp[1:])
            want[kind][names[path]] = value
    with torch.device('meta'):           # names and shapes only
        net = VOSModel(exp.model)
    masks = optim.make_masks(dict(net.named_parameters()), exp, extra)
    assert masks.frozen and set(masks.frozen) <= set(want[2])
    for name in masks.frozen:
        assert masks.wd[name] == pytest.approx(want[0][name]), name
        assert masks.is_enc[name] == want[1][name], name
        assert masks.frozen[name] == want[2][name], name
    assert any(masks.frozen.values()) and not all(masks.frozen.values())


def test_trainer_writes_bn_stats_and_freezes():
    """freeze_bn off, SGD: a step stores the episode's BN statistics in
    the buffers (f32) and the EMA tracks them; frozen parameters keep
    their values."""
    exp = replace(get_config('pre_vost', model='deaott', data_seq_len=2,
                             freeze_bn=False, train_opt='sgd',
                             train_total_steps=10),
                  train_long_term_mem_gap=1)
    model = build_vos_model(exp.model, device='cpu', exp=exp)
    bn = model.get_submodule('encoder.features.5.conv.0.1')
    stem = model.get_submodule('encoder.features.0.0').weight.detach().clone()
    before = bn.running_var.clone()
    trainer = Trainer(model, exp)
    state = trainer.init_state()
    rs = np.random.RandomState(3)
    batch = {'frames': torch.from_numpy(rs.randn(1, 2, 33, 33, 3)
                                        .astype(np.float32)),
             'masks': torch.from_numpy((rs.rand(1, 2, 33, 33) * 3)
                                       .astype(np.int64)),
             'obj_nums': torch.tensor([2])}
    state, metrics = trainer.train_step(state, batch,
                                        torch.Generator().manual_seed(0))
    assert bn.running_var.dtype == torch.float32
    assert not torch.equal(bn.running_var, before)
    name = 'encoder.features.5.conv.0.1.running_var'
    d = min(trainer.ema_decay, 2 / 11)
    torch.testing.assert_close(state.ema[name],
                               before - (1 - d) * (before - bn.running_var))
    assert torch.equal(model.get_submodule('encoder.features.0.0').weight,
                       stem)
    assert np.isfinite(float(metrics['loss']))
    assert float(metrics['grad_norm']) > 0
