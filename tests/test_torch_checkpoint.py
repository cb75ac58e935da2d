"""The port's native checkpoints (utils/checkpoint.py), the train state
they hold (Trainer.state_dict / load_state_dict), the eval CLI's choice of
checkpoint, and the config snapshot (config_to_dict) against the JAX
package's."""
import json
import os
from argparse import Namespace
from dataclasses import replace

import pytest
import torch

from rmem_ocu_tpu.config import config_to_dict as jax_config_to_dict
from rmem_ocu_tpu.config import get_config as jax_get_config

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch.config import (MODEL_REGISTRY, STAGE_REGISTRY,
                                       config_from_dict, config_to_dict,
                                       get_config)
from rmem_ocu_tpu_torch.models import build_vos_model
from rmem_ocu_tpu_torch.tools.eval import load_checkpoint
from rmem_ocu_tpu_torch.train.trainer import Trainer, TrainState
from rmem_ocu_tpu_torch.utils import checkpoint as ckpt


def seeded_state(seed: int, model='aott'):
    """A trainer whose model, optimizer moments, EMA and counters are all
    drawn from `seed` (so that each differs from the others)."""
    exp = get_config('pre_vost_2', model=model)
    trainer = Trainer(build_vos_model(exp.model, device='cpu', seed=seed),
                      exp)
    g = torch.Generator().manual_seed(seed)
    state = trainer.init_state()
    rand = lambda tree: {k: torch.randn(v.shape, generator=g)
                         for k, v in tree.items()}
    state = TrainState(
        opt_state={'count': 3 + seed, 'mu': rand(state.opt_state['mu']),
                   'nu': rand(state.opt_state['nu'])},
        ema=rand(state.ema), step=7 + seed, ema_updates=5 + seed)
    return trainer, state


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict)
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_round_trip_is_bitwise(tmp_path):
    trainer, state = seeded_state(1)
    saved = trainer.state_dict(state)
    path = ckpt.save_checkpoint(str(tmp_path / 'ckpt'), state.step, saved)
    assert path == str(tmp_path / 'ckpt' / 'step_8' / 'state.pth')
    assert os.listdir(tmp_path / 'ckpt' / 'step_8') == ['state.pth']

    other, other_state = seeded_state(2)
    restored, step = ckpt.restore_checkpoint(
        str(tmp_path / 'ckpt'), other.state_dict(other_state))
    assert step == 8
    new_state = other.load_state_dict(restored)
    assert_tree_equal(other.state_dict(new_state), saved)
    assert (new_state.step, new_state.ema_updates,
            new_state.opt_state['count']) == (8, 6, 4)


def test_max_keep_prunes_the_oldest(tmp_path):
    root = str(tmp_path / 'ckpt')
    for step in (2, 4, 6, 8, 10):
        ckpt.save_checkpoint(root, step, {'x': torch.full((2,), step)},
                             max_keep=3)
    assert ckpt.list_checkpoint_steps(root) == [6, 8, 10]
    state, step = ckpt.restore_checkpoint(root)
    assert step == 10 and torch.equal(state['x'], torch.full((2,), 10))
    assert ckpt.restore_checkpoint(root, step=4) == (None, None)
    assert ckpt.restore_checkpoint(str(tmp_path / 'none')) == (None, None)


def test_backup_after_a_failed_write(tmp_path, monkeypatch):
    """The primary write fails once: the half-written step_<N> goes, the
    save lands in <root>_backup, and restore finds it there; a step saved
    later to the primary is newer and wins, an explicit step still reads
    the backup."""
    root = str(tmp_path / 'ckpt')
    real_save = torch.save
    calls = []

    def flaky_save(obj, path):
        calls.append(path)
        if len(calls) == 1:
            with open(path, 'wb') as f:
                f.write(b'half')
            raise OSError(28, 'No space left on device')
        real_save(obj, path)
    monkeypatch.setattr(torch, 'save', flaky_save)
    path = ckpt.save_checkpoint(root, 3, {'x': torch.arange(3)})
    assert path == os.path.join(ckpt.backup_root_for(root), 'step_3',
                                'state.pth')
    assert ckpt.backup_root_for(root) == root + '_backup'
    assert ckpt.list_checkpoint_steps(root) == []
    assert ckpt.list_checkpoint_steps(root + '_backup') == [3]
    state, step = ckpt.restore_checkpoint(root)
    assert step == 3 and torch.equal(state['x'], torch.arange(3))

    ckpt.save_checkpoint(root, 5, {'x': torch.arange(5)})
    state, step = ckpt.restore_checkpoint(root)
    assert step == 5 and torch.equal(state['x'], torch.arange(5))
    state, step = ckpt.restore_checkpoint(root, step=3)
    assert step == 3 and torch.equal(state['x'], torch.arange(3))
    # the newest step may be in the backup too
    ckpt.save_checkpoint(root + '_backup', 9, {'x': torch.arange(9)})
    assert ckpt.restore_checkpoint(root)[1] == 9


def test_ema_checkpoint_loads_as_a_pth(tmp_path):
    trainer, state = seeded_state(3)
    path = ckpt.save_checkpoint(str(tmp_path / 'ema_ckpt'), 8,
                                {'state_dict': state.ema})
    model = build_vos_model(trainer.model.cfg, device='cpu', seed=4)
    assert ckpt.load_torch_pretrained(path, model) == []
    assert_tree_equal(model.state_dict(), state.ema)


@pytest.mark.parametrize('test_ema', [True, False])
def test_eval_picks_step_and_weights(tmp_path, monkeypatch, test_ema):
    """The eval CLI's selection: the experiment's ckpt/ (a train state) by
    default under --no_ema, its ema_ckpt/ otherwise; the newest step
    unless --ckpt_step or test_ckpt_step names one; the EMA of a train
    state under test_ema, its weights otherwise."""
    monkeypatch.chdir(tmp_path)
    exp = replace(get_config('pre_vost_2', model='aott'), test_ema=test_ema)
    states = {step: seeded_state(seed) for step, seed in ((2, 5), (4, 6))}
    for step, (trainer, state) in states.items():
        ckpt.save_checkpoint(os.path.join(exp.dir_result(), 'ckpt'), step,
                             trainer.state_dict(state))
        ckpt.save_checkpoint(os.path.join(exp.dir_result(), 'ema_ckpt'),
                             step, {'state_dict': state.ema})

    def loaded(ckpt_path=None, ckpt_step=None, exp=exp):
        model = build_vos_model(exp.model, device='cpu', seed=9)
        load_checkpoint(Namespace(ckpt_path=ckpt_path, ckpt_step=ckpt_step),
                        exp, model)
        return model.state_dict()

    def want(step, ema):
        trainer, state = states[step]
        return state.ema if ema else trainer.model.state_dict()

    assert_tree_equal(loaded(), want(4, test_ema))  # ema_ckpt/ or ckpt/
    train_dir = os.path.join(exp.dir_result(), 'ckpt')
    assert_tree_equal(loaded(train_dir), want(4, test_ema))
    assert_tree_equal(loaded(train_dir, 2), want(2, test_ema))
    assert_tree_equal(loaded(train_dir, exp=replace(exp, test_ckpt_step=2)),
                      want(2, test_ema))
    assert_tree_equal(loaded(os.path.join(train_dir, 'step_2',
                                          'state.pth')), want(2, False))


def test_eval_refuses_what_it_cannot_read(tmp_path):
    exp = get_config('pre_vost_2', model='aott')
    model = build_vos_model(exp.model, device='cpu')
    orbax = tmp_path / 'orbax'
    (orbax / 'step_3' / 'default').mkdir(parents=True)
    with pytest.raises(SystemExit, match="only its own step_<N>"):
        load_checkpoint(Namespace(ckpt_path=str(orbax), ckpt_step=None),
                        exp, model)
    with pytest.raises(SystemExit, match='no step_<N> checkpoints'):
        load_checkpoint(Namespace(ckpt_path=str(tmp_path), ckpt_step=None),
                        exp, model)
    ckpt.save_checkpoint(str(tmp_path / 'other'), 1, {'step': 1})
    with pytest.raises(SystemExit, match='not a train state'):
        load_checkpoint(Namespace(ckpt_path=str(tmp_path / 'other'),
                                  ckpt_step=None), exp, model)


@pytest.mark.parametrize('stage', sorted(STAGE_REGISTRY))
def test_config_to_dict_matches_jax(stage):
    """config.json of every stage x registered model holds the JAX
    package's JSON (the same keys and values; the ModelConfig fields are
    declared in another order), and the port reads it back."""
    for model in sorted(MODEL_REGISTRY):
        exp = get_config(stage, model=model)
        snapshot = json.loads(json.dumps(config_to_dict(exp)))
        assert snapshot == json.loads(json.dumps(jax_config_to_dict(
            jax_get_config(stage, model=model))))
        assert config_from_dict(snapshot) == exp
