"""The port's eval protocol against the JAX package's, end to end.

The port's `Evaluator` and the JAX `Evaluator` run the same sequence of
JPEG frames and PNG labels written here, with the same r50_deaotl weights
(flax init, converted with params_from_flax), in fp32 on the CPU. The JAX
package runs its default CPU path; the port's kernel wrappers take their
plain versions, which tests/test_torch_kernels.py and
tests/test_torch_multihead.py hold to the Pallas kernels.

Cases:
- flip and multi_scale=(1.0, 1.3) on 65x97 frames (grids 5x7 and 6x9):
  four engine states, logits upsampled, flipped back and their softmaxes
  summed; a bank of 1 + 2 frames written every frame, so that eviction
  runs;
- 10 objects (one group) and an 11th and 12th labelled at frame 3, with
  flip: the merged map re-references every augmentation's state, which is
  rebuilt at two groups, and soft aggregation merges them from then on.

Bars, every frame: written masks agree on more than 99.9% of pixels,
eviction frame ids identical at every update of every state (recorded by
wrapping each evaluator's engine.update_memory), probe logits within
1e-3. Also here: the eval, demo and video CLIs of the port end to end on
the CPU, and the `.pth` loader against the JAX loader.
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
from rmem_ocu_tpu.eval.evaluator import Evaluator as JaxEvaluator
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.ops.masks import save_mask_png as jax_save_mask_png
from rmem_ocu_tpu.utils.checkpoint import (
    load_torch_pretrained as jax_load_torch_pretrained)

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.data.eval_datasets import VOSSequence
from rmem_ocu_tpu_torch.eval.evaluator import Evaluator
from rmem_ocu_tpu_torch.ops.masks import read_mask_png, save_mask_png
from rmem_ocu_tpu_torch.utils.checkpoint import load_torch_pretrained
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

H, W = 65, 97
PROBE = re.compile(r': (\S+) (\S+) logits\[\d+,\d+,:7\] = \[([^\]]*)\]')


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port computes on one CPU thread in these tests. Under the
    suite's parallel workers an 8-thread pool waits at every op for
    threads that other workers hold the cores of: the eval CLI case took
    143 s instead of 3 s beside 8 busy processes on 8 cores, and 3 s with
    one thread. The results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def weights():
    """(flax params, the port's state_dict) of one r50_deaotl init."""
    exp = jax_get_config('pre_vost_2', model='r50_deaotl')
    params = jax.jit(jax_build(exp.model).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, exp.model.id_dim)))
    params = jax.device_get(params)
    port_exp = get_config('pre_vost_2', model='r50_deaotl')
    return params, params_from_flax(params, port_exp.model)


def _write_sequence(root, n_frames, labels):
    """Frames near one base image (so that predictions are not noise) and
    the given {frame index: label map} as PNGs. Returns the frame names."""
    rng = np.random.RandomState(7)
    base = rng.rand(H, W, 3) * 255
    os.makedirs(root / 'img' / 'seq', exist_ok=True)
    os.makedirs(root / 'lbl' / 'seq', exist_ok=True)
    names = []
    for i in range(n_frames):
        name = f'{i:05d}.jpg'
        frame = np.clip(base * 0.8 + rng.rand(H, W, 3) * 60, 0, 255)
        Image.fromarray(frame.astype(np.uint8)).save(root / 'img' / 'seq' /
                                                     name)
        names.append(name)
    for i, lbl in labels.items():
        jax_save_mask_png(lbl, str(root / 'lbl' / 'seq' / f'{i:05d}.png'))
    return names, [f'{i:05d}.png' for i in labels]


def _blocks(ids, rows, cols):
    """A label map with one rectangle per id on a rows x cols layout."""
    lbl = np.zeros((H, W), np.uint8)
    bh, bw = H // rows, W // cols
    for n, obj in enumerate(ids):
        r, c = divmod(n, cols)
        lbl[r * bh + 2:(r + 1) * bh - 2, c * bw + 2:(c + 1) * bw - 2] = obj
    return lbl


class _Recorder:
    """Wraps engine.update_memory; keeps each state's ordered frame ids."""

    def __init__(self, engine, to_numpy):
        self.ids = []
        inner = engine.update_memory

        def update_memory(*args):
            state = inner(*args)
            self.ids.append(to_numpy(state.bank.ordered_frame_ids))
            return state
        engine.update_memory = update_memory


def _run_both(tmp_path, capsys, weights, n_frames, labels, overrides,
              exp_fields, **seq_kw):
    params, state_dict = weights
    names, label_names = _write_sequence(tmp_path, n_frames, labels)

    def dataset(cls):
        seq = cls(str(tmp_path / 'img'), str(tmp_path / 'lbl'), 'seq',
                  names, label_names, max_size=1040, align_corners=True,
                  **seq_kw)
        return {'seq': seq}.items

    class _DS:
        def __init__(self, items):
            self.items = items

    from rmem_ocu_tpu.data.eval_datasets import VOSSequence as JaxSequence
    jexp = replace(jax_get_config('pre_vost_2', model='r50_deaotl',
                                  **overrides), **exp_fields)
    jev = JaxEvaluator(jax_build(jexp.model), params, jexp,
                       str(tmp_path / 'jax'), probe=True)
    jrec = _Recorder(jev.engine, lambda x: np.asarray(x))
    capsys.readouterr()
    jev.evaluate(_DS(dataset(JaxSequence)), verbose=False)
    jprobe = PROBE.findall(capsys.readouterr().out)

    exp = replace(get_config('pre_vost_2', model='r50_deaotl', **overrides),
                  **exp_fields)
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(state_dict, strict=True)
    ev = Evaluator(model, exp, str(tmp_path / 'port'), probe=True)
    rec = _Recorder(ev.engine, lambda x: x.numpy())
    ev.evaluate(_DS(dataset(VOSSequence)), verbose=False)
    probe = PROBE.findall(capsys.readouterr().out)

    assert len(rec.ids) == len(jrec.ids) > 0
    for i, (got, want) in enumerate(zip(rec.ids, jrec.ids)):
        np.testing.assert_array_equal(got, want, err_msg=f'update {i}')
    assert len(probe) == len(jprobe) > 0
    for (name, frame, vals), (jname, jframe, jvals) in zip(probe, jprobe):
        assert (name, frame) == (jname, jframe)
        np.testing.assert_allclose(np.array(vals.split(), np.float32),
                                   np.array(jvals.split(), np.float32),
                                   rtol=1e-3, atol=1e-3,
                                   err_msg=f'probe {frame}')
    written = sorted(os.listdir(tmp_path / 'port' / 'seq'))
    assert written == sorted(os.listdir(tmp_path / 'jax' / 'seq'))
    assert len(written) == n_frames - 1
    masks = []
    for name in written:
        got = read_mask_png(str(tmp_path / 'port' / 'seq' / name))
        want = read_mask_png(str(tmp_path / 'jax' / 'seq' / name))
        assert got.shape == (H, W)
        assert (got == want).mean() > 0.999, name
        masks.append(got)
    return rec.ids, masks


def test_flip_and_multiscale_match_jax(tmp_path, capsys, weights):
    """Four augmentations on two grids (5x7 and 6x9), one group; a bank
    of 1 + 2 frames written every frame (--gap 1), so that eviction runs
    from frame 3 on."""
    ids, masks = _run_both(
        tmp_path, capsys, weights, 5, {0: _blocks([1, 2, 3], 1, 3)},
        dict(latter_mem_len=2),
        dict(test_long_term_mem_gap=1, test_fixed_mem_gap=True),
        multi_scale=(1.0, 1.3), flip=True)
    assert len(ids) == 4 * 4
    assert {i.shape for i in ids} == {(1, 4)}
    # the reference stays in slot 0; frames 1 and 2 were evicted
    assert (ids[-1] == [0, 3, 4, -1]).all()


def test_rereference_regroups_like_jax(tmp_path, capsys, weights):
    """10 objects, then objects 11 and 12 labelled at frame 3: the state
    of each augmentation is rebuilt at two groups, and frame 4 merges the
    two groups' logits.

    Only one frame follows the regroup. With random weights the merged
    map spreads its probability almost evenly over 20 foreground ids, and
    ties decide some pixels: at frame 4 the two packages' masks differ at
    4 of 6305 pixels, each a pixel where JAX's two best summed
    probabilities are less than 4e-6 apart; the differing masks then feed
    both memories, and at a frame 5 they would differ at 17 pixels
    (99.73% agreement, every one with a margin under 1.1e-4), the same
    under 1, 3 and 8 CPU threads."""
    labels = {0: _blocks(range(1, 11), 2, 5),
              3: _blocks(range(1, 13), 3, 4)}
    labels[3][labels[3] < 11] = 0        # frame 3 labels only the new ones
    ids, masks = _run_both(tmp_path, capsys, weights, 5, labels, {}, {},
                           flip=True)
    # frames 1, 2 and 4 update both augmentations; frame 3 re-references
    assert [i.shape[0] for i in ids] == [1, 1, 1, 1, 2, 2]
    # the frame-3 ground truth of the new objects is written as is
    frame3 = masks[2]
    assert set(np.unique(frame3[labels[3] > 0])) == {11, 12}


def test_pth_loader_matches_jax(tmp_path, weights):
    """A reference-style checkpoint ('state_dict' wrapper, 'module.'
    prefix, id bank without the ignore-token channel) loads into the port
    as the JAX loader loads it into flax."""
    params, state_dict = weights
    exp = get_config('pre_vost_2', model='r50_deaotl')
    rng = np.random.RandomState(3)
    sd = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in state_dict.items()}
    sd['patch_wise_id_bank.weight'] = sd['patch_wise_id_bank.weight'][:, :-1]
    path = str(tmp_path / 'ckpt.pth')
    torch.save({'state_dict': {'module.' + k: v for k, v in sd.items()}},
               path)

    model = build_vos_model(exp.model, device='cpu', seed=1)
    assert load_torch_pretrained(path, model) == []
    jexp = jax_get_config('pre_vost_2', model='r50_deaotl')
    want = params_from_flax(jax.device_get(
        jax_load_torch_pretrained(path, params, jexp.model)), exp.model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    assert not got['patch_wise_id_bank.weight'][:, -1].any()

    # a tensor of the wrong shape keeps its value and is reported
    sd['encoder_projector.bias'] = torch.zeros(3)
    torch.save(sd, path)
    before = model.encoder_projector.bias.clone()
    assert load_torch_pretrained(path, model) == ['encoder_projector.bias']
    assert torch.equal(model.encoder_projector.bias, before)


def _write_frames(d, n=3, size=49):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)
                        ).save(os.path.join(d, f'{i:05d}.jpg'))


def _write_mask(path, size=49):
    m = np.zeros((size, size), np.uint8)
    m[10:30, 10:30] = 1
    m[32:45, 5:20] = 2
    save_mask_png(m, path)


def test_eval_cli_on_the_cpu(tmp_path, monkeypatch):
    """`python -m rmem_ocu_tpu_torch.tools.eval --dataset test --device
    cpu` writes masks and print.log; without --device it needs the card."""
    from rmem_ocu_tpu_torch.tools import eval as eval_cli
    monkeypatch.chdir(tmp_path)
    out = tmp_path / 'out'
    monkeypatch.setattr(sys, 'argv', [
        'eval', '--dataset', 'test', '--device', 'cpu', '--output',
        str(out)])
    eval_cli.main()
    for seq in ('test_0', 'test_1'):
        assert len(os.listdir(out / seq)) == 9
        assert read_mask_png(str(out / seq / '00001.png')).shape == (129,
                                                                      129)
    assert 'done: 18 frames' in (out / 'print.log').read_text()

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(sys, 'argv', ['eval', '--dataset', 'test',
                                      '--output', str(tmp_path / 'x')])
    with pytest.raises(RuntimeError, match='CUDA'):
        eval_cli.main()


def test_demo_cli_on_the_cpu(tmp_path, monkeypatch):
    frames = tmp_path / 'clip'
    _write_frames(str(frames))
    _write_mask(str(tmp_path / 'first.png'))
    out = tmp_path / 'out'
    from rmem_ocu_tpu_torch.tools import demo
    monkeypatch.setattr(sys, 'argv', [
        'demo', '--img_dir', str(frames), '--mask',
        str(tmp_path / 'first.png'), '--device', 'cpu', '--output',
        str(out), '--max_size', '65'])
    demo.main()
    masks = sorted(os.listdir(out / 'masks' / 'clip'))
    assert len(masks) == 3
    assert read_mask_png(str(out / 'masks' / 'clip' / masks[0])).shape == (
        49, 49)
    assert len(os.listdir(out / 'overlay' / 'clip')) == 3
    assert (out / 'clip.mp4').exists()


def test_video_cli(tmp_path, monkeypatch):
    _write_frames(str(tmp_path / 'imgs' / 'seq0'))
    os.makedirs(tmp_path / 'res' / 'seq0')
    for i in range(3):
        _write_mask(str(tmp_path / 'res' / 'seq0' / f'{i:05d}.png'))
    from rmem_ocu_tpu_torch.tools import video
    out = tmp_path / 'vis'
    monkeypatch.setattr(sys, 'argv', [
        'video', '--image_root', str(tmp_path / 'imgs'),
        '--results_path', str(tmp_path / 'res'), '--output', str(out)])
    video.main()
    assert (out / 'seq0.mp4').stat().st_size > 0
