"""The VOST oracle protocol of the port against the JAX package's.

`r50_topdown_aotl` with `oracle=True`: every frame has a ground-truth
label; each one conditions the mask-conditioned TopDown encoder (flipped
and resized per augmentation) and none re-references. A VOST layout of
6 JPEG frames at 65x97, each with a PNG label (three objects drifting a
pixel a frame), is read by both packages' `build_vost_dataset(...,
oracle=True)` and run through both Evaluators with flip, the same random
weights (over the flax tree's shapes, converted with params_from_flax),
fp32 on the CPU (the JAX package's default path), a bank of 1 + 2 frames
written every frame so that eviction runs.

Bars: eviction frame ids identical at every update of every state, probe
logits within 1e-3, written masks identical; a reference frame is added
once per augmentation, at frame 0. Then the port's eval CLI
(`--dataset vost --oracle --model r50_topdown_aotl`, the weights as a
`.pth`) writes the same masks as the port's Evaluator.
"""
import os
import re
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.data.eval_datasets import \
    build_vost_dataset as jax_build_vost_dataset
from rmem_ocu_tpu.eval.evaluator import Evaluator as JaxEvaluator
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.ops.masks import save_mask_png as jax_save_mask_png

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.data.eval_datasets import build_vost_dataset
from rmem_ocu_tpu_torch.eval.evaluator import Evaluator
from rmem_ocu_tpu_torch.ops.masks import read_mask_png
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

H, W = 65, 97
N_FRAMES = 6
MODEL = 'r50_topdown_aotl'
OVERRIDES = dict(oracle=True, latter_mem_len=2)
PROBE = re.compile(r': (\S+) (\S+) logits\[\d+,\d+,:7\] = \[([^\]]*)\]')


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One CPU thread for the port (see tests/test_torch_evaluator.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_params(shapes, seed: int):
    """Lecun-normal kernels, the TopDown prompt and a near-identity
    transform, biases, norm affines and frozen-BN statistics off their
    init values."""
    rng = np.random.RandomState(seed)

    def make(path, x):
        name = path[-1].key
        noise = rng.randn(*x.shape).astype(np.float32)
        if name in ('kernel', 'relative_emb_k_w'):
            fan_in = np.prod(x.shape[:-1]) if name == 'kernel' else x.shape[1]
            return noise * np.float32(fan_in ** -0.5)
        if name == 'running_var':
            return 1.0 + 0.2 * np.abs(noise)
        if name in ('running_mean', 'bias'):
            return 0.1 * noise
        if name in ('scale', 'weight'):
            return 1.0 + 0.1 * noise
        if name == 'top_down_transform':
            return np.eye(x.shape[0], dtype=np.float32) + 0.02 * noise
        if name == 'prompt':
            return noise
        return np.zeros(x.shape, np.float32)
    return jax.tree_util.tree_map_with_path(make, shapes)


def _labels(t: int) -> np.ndarray:
    lbl = np.zeros((H, W), np.uint8)
    lbl[10 + t:40 + t, 5:35] = 1
    lbl[20:50, 40 + t:70 + t] = 2
    lbl[45 - t:60 - t, 75:92] = 3
    lbl[0:3, 0:3] = 255                  # ignored pixels clear to 0
    return lbl


def _write_vost(root):
    rng = np.random.RandomState(7)
    base = rng.rand(H, W, 3) * 255
    for sub in ('JPEGImages/seq', 'Annotations/seq', 'ImageSets'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for t in range(N_FRAMES):
        frame = np.clip(base * 0.8 + rng.rand(H, W, 3) * 60, 0, 255)
        Image.fromarray(frame.astype(np.uint8)).save(
            os.path.join(root, 'JPEGImages', 'seq', f'{t:05d}.jpg'))
        jax_save_mask_png(_labels(t), os.path.join(root, 'Annotations', 'seq',
                                                   f'{t:05d}.png'))
    with open(os.path.join(root, 'ImageSets', 'val.txt'), 'w') as f:
        f.write('seq\n')


class _Recorder:
    """Counts add_reference_frame calls and keeps each state's ordered
    frame ids after every update_memory."""

    def __init__(self, engine, to_numpy):
        self.ids, self.refs = [], 0
        add, update = engine.add_reference_frame, engine.update_memory

        def add_reference_frame(*args):
            self.refs += 1
            return add(*args)

        def update_memory(*args):
            state = update(*args)
            self.ids.append(to_numpy(state.bank.ordered_frame_ids))
            return state
        engine.add_reference_frame = add_reference_frame
        engine.update_memory = update_memory


def _masks(root):
    return {n: read_mask_png(os.path.join(root, 'seq', n))
            for n in sorted(os.listdir(os.path.join(root, 'seq')))}


def test_oracle_evaluator_matches_jax(tmp_path, capsys, monkeypatch):
    data = str(tmp_path / 'vost')
    _write_vost(data)
    seq_kw = dict(max_size=1040, align_corners=True, flip=True)
    exp_fields = dict(test_long_term_mem_gap=1, test_fixed_mem_gap=True)

    jexp = replace(jax_get_config('pre_vost_2', model=MODEL, **OVERRIDES),
                   **exp_fields)
    shapes = jax.eval_shape(
        jax_build(jexp.model).init, jax.random.PRNGKey(0),
        jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, jexp.model.id_dim)))
    params = _random_params({'params': shapes['params']}, 3)
    jev = JaxEvaluator(jax_build(jexp.model), params, jexp,
                       str(tmp_path / 'jax'), probe=True)
    jrec = _Recorder(jev.engine, np.asarray)
    capsys.readouterr()
    jev.evaluate(jax_build_vost_dataset(data, 'val', oracle=True, **seq_kw),
                 verbose=False)
    jprobe = PROBE.findall(capsys.readouterr().out)

    exp = replace(get_config('pre_vost_2', model=MODEL, **OVERRIDES),
                  **exp_fields)
    assert exp.model.use_mask
    state_dict = params_from_flax(params, exp.model)
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(state_dict, strict=True)
    ev = Evaluator(model, exp, str(tmp_path / 'port'), probe=True)
    rec = _Recorder(ev.engine, lambda x: x.numpy())
    ev.evaluate(build_vost_dataset(data, 'val', oracle=True, **seq_kw),
                verbose=False)
    probe = PROBE.findall(capsys.readouterr().out)

    # one reference per augmentation (frame 0); every later frame, though
    # labelled, updates the memory of both
    assert rec.refs == jrec.refs == 2
    assert len(rec.ids) == len(jrec.ids) == 2 * (N_FRAMES - 1)
    for i, (got, want) in enumerate(zip(rec.ids, jrec.ids)):
        np.testing.assert_array_equal(got, want, err_msg=f'update {i}')
    assert (rec.ids[-1] == [0, 4, 5, -1]).all()          # evicted 1, 2, 3
    assert len(probe) == len(jprobe) == 2 * (N_FRAMES - 1)
    for (name, frame, vals), (jname, jframe, jvals) in zip(probe, jprobe):
        assert (name, frame) == (jname, jframe)
        np.testing.assert_allclose(np.array(vals.split(), np.float32),
                                   np.array(jvals.split(), np.float32),
                                   rtol=1e-3, atol=1e-3,
                                   err_msg=f'probe {frame}')
    got, want = _masks(tmp_path / 'port'), _masks(tmp_path / 'jax')
    assert list(got) == list(want) and len(got) == N_FRAMES - 1
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    # the eval CLI, with the same weights as a .pth
    ckpt = str(tmp_path / 'w.pth')
    torch.save(state_dict, ckpt)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, 'argv', [
        'eval', '--dataset', 'vost', '--data_root', data, '--oracle',
        '--model', MODEL, '--ckpt_path', ckpt, '--flip', '--gap', '1',
        '--latter_mem_len', '2', '--device', 'cpu', '--output',
        str(tmp_path / 'cli')])
    from rmem_ocu_tpu_torch.tools import eval as eval_cli
    eval_cli.main()
    cli = _masks(tmp_path / 'cli')
    # the CLI's result dir also holds the copied frame-0 label
    assert set(got) <= set(cli)
    for name in got:
        np.testing.assert_array_equal(cli[name], got[name], err_msg=name)
