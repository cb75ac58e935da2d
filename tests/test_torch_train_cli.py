"""The port's train, pipeline, accept and prepare_extracted CLIs on the CPU
(`--device cpu`), on a synthetic VOST tree written from a seed
(chip_smoke.write_vost_tree): the train CLI's first logged loss is the
Trainer's on the same loader batch and pretrained weights, a resumed run
continues bitwise from its checkpoint, the pipeline writes masks and the
scorer's CSV, accept scores a checkpoint of the port's own, and
prepare_extracted stages the tree the JAX package's does."""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from rmem_ocu_tpu.tools.prepare_extracted import prepare as jax_prepare

import torch_threads  # noqa: F401
import chip_smoke
from rmem_ocu_tpu_torch.config import config_from_dict, get_config
from rmem_ocu_tpu_torch.data.train_datasets import (TrainDataLoader,
                                                    build_train_dataset)
from rmem_ocu_tpu_torch.models import build_vos_model
from rmem_ocu_tpu_torch.tools import accept, pipeline
from rmem_ocu_tpu_torch.tools import train as train_cli
from rmem_ocu_tpu_torch.tools.prepare_extracted import prepare
from rmem_ocu_tpu_torch.train import optim
from rmem_ocu_tpu_torch.train.trainer import Trainer
from rmem_ocu_tpu_torch.utils import checkpoint as ckpt

TREE_SIZE, TREE_FRAMES = (48, 64), 6
# the 'default' stage resumes automatically; aott at 65x65 crops, T=3
TRAIN_ARGS = ['--stage', 'default', '--model', 'aott', '--exp_name', 'cli',
              '--datasets', 'vost', '--crop_size', '65', '--seq_len', '3',
              '--batch_size', '1', '--log_step', '1', '--save_step', '1',
              '--device', 'cpu']
ROW_KEYS = {'step', 'loss', 'aux_loss', 'pred_loss', 'iou', 'lr',
            'grad_norm', 'frame_losses', 'frame_ious', 'it_per_s'}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('vost'))
    chip_smoke.write_vost_tree(root, TREE_SIZE, TREE_FRAMES)
    return root


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    """The directory the CLIs run in (their results go to ./results)."""
    path = tmp_path_factory.mktemp('work')
    old = os.getcwd()
    os.chdir(path)
    yield path
    os.chdir(old)


@pytest.fixture(scope='module')
def trained(tree, workdir):
    """Two steps of the train CLI from seeded pretrained weights; returns
    the result directory and the weights' path."""
    exp = get_config('default', model='aott')
    pre = str(workdir / 'pretrained.pth')
    torch.save({'state_dict': build_vos_model(
        exp.model, device='cpu', seed=11).state_dict()}, pre)
    train_cli.main(TRAIN_ARGS + ['--data_root', tree, '--total_steps', '2',
                                 '--pretrained_path', pre])
    return workdir / 'results' / 'cli_aott' / 'default', pre


def read_rows(result):
    with open(result / 'metrics.jsonl') as f:
        return [json.loads(line) for line in f]


def read_exp(result):
    with open(result / 'config.json') as f:
        return config_from_dict(json.load(f))


def first_batch(exp):
    batch = next(iter(TrainDataLoader(build_train_dataset(exp),
                                      exp.train_batch_size, seed=0,
                                      num_workers=2)))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_first_loss_is_the_trainers(trained):
    result, pre = trained
    for name in ('print.log', 'config.json', 'code_snapshot/tools/train.py',
                 'ckpt/step_1/state.pth', 'ckpt/step_2/state.pth',
                 'ema_ckpt/step_2/state.pth'):
        assert (result / name).is_file(), name
    rows = read_rows(result)
    assert [r['step'] for r in rows] == [1, 2]
    assert set(rows[0]) == ROW_KEYS
    assert all(np.isfinite(r['loss']) for r in rows)

    exp = read_exp(result)
    model = build_vos_model(exp.model, device='cpu', seed=5, exp=exp)
    assert ckpt.load_torch_pretrained(pre, model) == []
    trainer = Trainer(model, exp)
    _, metrics = trainer.train_step(trainer.restart_ema(trainer.init_state()),
                                    first_batch(exp),
                                    torch.Generator().manual_seed(1))
    want = float(metrics['loss'])
    assert abs(rows[0]['loss'] - want) <= 1e-6 * abs(want)
    np.testing.assert_allclose(rows[0]['frame_losses'],
                               metrics['frame_losses'].numpy(), rtol=1e-6)


def test_resume_continues_bitwise(trained, tree):
    """The same experiment to 3 steps resumes from step 2: the step count
    and the learning-rate schedule go on, and step 3 is the Trainer's step
    from the restored checkpoint on the loader's first batch (the loader
    and the episode generator start again, as in the JAX CLI)."""
    result, _ = trained
    train_cli.main(TRAIN_ARGS + ['--data_root', tree, '--total_steps', '3'])
    with open(result / 'print.log') as f:
        assert 'resumed from step 2' in f.read()
    row = read_rows(result)[-1]
    exp = read_exp(result)
    assert exp.train_total_steps == 3 and row['step'] == 3
    assert row['lr'] == optim.schedule_lr(2, exp)

    trainer = Trainer(build_vos_model(exp.model, device='cpu', seed=5,
                                      exp=exp), exp)
    saved, step = ckpt.restore_checkpoint(str(result / 'ckpt'), step=2)
    state = trainer.load_state_dict(saved)
    assert (step, state.step, state.ema_updates) == (2, 2, 2)
    state, metrics = trainer.train_step(state, first_batch(exp),
                                        torch.Generator().manual_seed(1))
    assert row['loss'] == float(metrics['loss'])
    after, _ = ckpt.restore_checkpoint(str(result / 'ckpt'), step=3)
    want = trainer.state_dict(state)
    assert after['step'] == want['step'] == 3
    assert after['opt_state']['count'] == want['opt_state']['count'] == 3
    for part in ('state_dict', 'ema'):
        for k, v in want[part].items():
            assert torch.equal(after[part][k], v), (part, k)
    for k, v in want['opt_state']['mu'].items():
        assert torch.equal(after['opt_state']['mu'][k], v), k


@pytest.mark.parametrize('flags,error', [
    (['--mesh', '2x1'], 'item 15'), (['--zero1'], 'item 15'),
    (['--multihost'], 'item 15'), (['--enc_chunk', '2'], 'XLA knob'),
    (['--remat', 'dots'], 'XLA rematerialisation')])
def test_train_refuses_what_the_port_lacks(flags, error):
    with pytest.raises((SystemExit, NotImplementedError), match=error):
        train_cli.main(TRAIN_ARGS + flags)


def test_pipeline_writes_masks_and_scores(tree, workdir):
    pipeline.main(['--stage', 'default', '--model', 'aott', '--exp_name',
                   'pipe', '--dataset', 'vost', '--data_root', tree,
                   '--batch_size', '1', '--total_steps', '2', '--save_step',
                   '2', '--crop_size', '65', '--max_size', '65', '--device',
                   'cpu'])
    result = workdir / 'results' / 'pipe_aott' / 'default'
    assert ckpt.list_checkpoint_steps(str(result / 'ckpt')) == [2]
    out = result / 'eval' / 'vost'
    for seq in ('val0', 'val1'):
        masks = sorted(os.listdir(out / seq))
        assert masks == [f'{t:05d}.png' for t in range(TREE_FRAMES)]
        assert np.asarray(Image.open(out / seq / masks[-1])).shape == \
            TREE_SIZE
    with open(out / 'global_results-val.csv') as f:
        head, values = [line.strip().split(',') for line in f]
    j = float(values[head.index('J_mean')])
    assert 0.0 <= j <= 1.0


def test_accept_scores_a_port_checkpoint(tree, workdir, capsys):
    exp = get_config('pre_vost_2', model='r50_deaotl')
    trainer = Trainer(build_vos_model(exp.model, device='cpu', seed=0), exp)
    ckpt_dir = str(workdir / 'accept_ckpt')
    ckpt.save_checkpoint(ckpt_dir, 1, trainer.state_dict(
        trainer.init_state()))
    out = accept.run(['--ckpt', ckpt_dir, '--vost_root', tree, '--output',
                      str(workdir / 'accept_out'), '--max_size', '65',
                      '--device', 'cpu'])
    assert 0.0 <= out['J'] <= 100.0 and 0.0 <= out['J_tr'] <= 100.0
    assert os.path.isfile(out['csv'])
    assert (out['ref_J_tr'], out['ref_J']) == accept.PUBLISHED[
        ('r50_deaotl', 'rmem')]
    assert out['delta_J'] == out['J'] - out['ref_J']
    assert out['delta_J_tr'] == out['J_tr'] - out['ref_J_tr']
    printed = capsys.readouterr().out
    assert 'loaded ema from step 1' in printed
    assert any(line.startswith('delta') for line in printed.splitlines())
    shutil.rmtree(ckpt_dir)


def _labelme_frame(root, num, shapes, size=(40, 60)):
    h, w = size
    Image.fromarray(np.full((h, w, 3), num % 255, np.uint8)).save(
        os.path.join(root, f'frame_{num}.jpg'))
    with open(os.path.join(root, f'frame_{num}.json'), 'w') as f:
        json.dump({'imageHeight': h, 'imageWidth': w, 'shapes': shapes}, f)


def _rect(label, x0, y0, x1, y1):
    return {'label': label, 'shape_type': 'polygon',
            'points': [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]}


def test_prepare_extracted_matches_jax(tmp_path, capsys):
    """A LabelMe directory whose eval tail swaps the shapes' order and
    drops an object: the port stages the same files, with the same
    name-stable ids, as the JAX package."""
    src = tmp_path / 'src'
    src.mkdir()
    a, b = _rect('alpha', 2, 2, 12, 12), _rect('beta', 30, 2, 50, 20)
    for n, shapes in ((100, [a, b]), (101, [a, b]), (102, [b]),
                      (103, [a, b]), (104, [b, a]), (105, [b])):
        _labelme_frame(str(src), n, shapes)
    with open(src / 'test_frame.json', 'w') as f:
        json.dump({'shapes': []}, f)
    summaries = {}
    for name, fn in (('port', prepare), ('jax', jax_prepare)):
        fn(str(src), str(tmp_path / name), eval_frames=3, seq_name='seq',
           symlink=False)
        summaries[name] = json.loads(capsys.readouterr().out)
    for s in summaries.values():
        del s['train_root'], s['eval_root']
    assert summaries['port'] == summaries['jax']
    assert summaries['port']['labels'] == {'alpha': 1, 'beta': 2}

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    assert files(tmp_path / 'port') == files(tmp_path / 'jax')
    for rel in files(tmp_path / 'port'):
        got, want = tmp_path / 'port' / rel, tmp_path / 'jax' / rel
        if rel.endswith('.png'):
            g, w = Image.open(got), Image.open(want)
            assert g.mode == w.mode == 'P'
            assert np.array_equal(np.asarray(g), np.asarray(w)), rel
            assert g.getpalette() == w.getpalette()
        else:
            assert got.read_bytes() == want.read_bytes(), rel
