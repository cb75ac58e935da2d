"""The port's eval data, label resizing, grouping, aggregation, mask
files, scorer and config reload against the JAX package's.

No model runs here. Everything is exact (the same numpy arithmetic on
both sides) except the group aggregation, which the port computes in
torch and the JAX package in jax.numpy: 1e-6 on random logits.
"""
import json
import os
from dataclasses import fields, replace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import jax.numpy as jnp

from rmem_ocu_tpu.config import config_to_dict
from rmem_ocu_tpu.config import get_config as jax_get_config
from rmem_ocu_tpu.config.defaults import STAGE_REGISTRY as JAX_STAGES
from rmem_ocu_tpu.data import eval_datasets as jds
from rmem_ocu_tpu.eval import evaluator as jev
from rmem_ocu_tpu.eval import metrics as jmetrics
from rmem_ocu_tpu.eval import scorer as jscorer
from rmem_ocu_tpu.ops import masks as jmasks

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch.config import (STAGE_REGISTRY, config_from_dict,
                                       get_config)
from rmem_ocu_tpu_torch.data import eval_datasets as ds
from rmem_ocu_tpu_torch.eval import evaluator as ev
from rmem_ocu_tpu_torch.eval import metrics, scorer
from rmem_ocu_tpu_torch.ops import masks


@pytest.mark.parametrize('align_corners', [True, False])
def test_restrict_size_and_label_resize_match_jax(align_corners):
    """Target sizes of MultiRestrictSize, and the nearest label resize to
    them, which must also equal torch's F.interpolate(mode='nearest')."""
    rng = np.random.RandomState(0)
    cases = [(480, 854, 1040, 1.0, None), (480, 854, 1040, 1.3, None),
             (1080, 1920, 1040, 1.0, None), (1080, 1920, 1040, 1.3, None),
             (720, 1280, 1040, 0.75, None), (500, 480, 600, 1.0, 480),
             (65, 97, 1040, 1.3, None), (241, 433, 1040, 1.3, None),
             (353, 625, 480 * 1.3, 1.0, None)]
    for h, w, max_size, scale, min_size in cases:
        size = ds.restrict_size(h, w, max_size, align_corners, scale,
                                min_size)
        assert size == jds.restrict_size(h, w, max_size, align_corners,
                                         scale, min_size), (h, w, scale)
        label = (rng.rand(h, w) * 5).astype(np.uint8)
        got = ev.Evaluator._label_at(label, size)
        np.testing.assert_array_equal(
            got, jev.Evaluator._label_at(label, size))
        want = F.interpolate(torch.from_numpy(label)[None, None].float(),
                             size=size, mode='nearest')[0, 0].numpy()
        np.testing.assert_array_equal(got, want.astype(np.uint8))
    # 500 -> 480 is where an integer floor (dst * in // out) is one row off
    label = np.arange(500, dtype=np.uint8)[:, None].repeat(3, 1)
    got = ev.Evaluator._label_at(label, (480, 3))
    np.testing.assert_array_equal(got,
                                  jev.Evaluator._label_at(label, (480, 3)))
    assert (got[:, 0] != (np.arange(480) * 500 // 480).astype(np.uint8)
            ).any()


def test_groups_and_gaps_match_jax():
    rng = np.random.RandomState(1)
    mask = (rng.rand(17, 23) * 26).astype(np.uint8)
    for n_groups in (1, 2, 3):
        np.testing.assert_array_equal(
            ev.separate_mask_groups(mask, n_groups, 10),
            jev.separate_mask_groups(mask, n_groups, 10))
    for frames in (1, 30, 149, 151, 450, 3000):
        for nmg in (False, True):
            assert ev.adaptive_mem_gap(frames, 5, nmg) == \
                jev.adaptive_mem_gap(frames, 5, nmg)
    cfg = get_config('pre_vost_2', model='r50_deaotl').model
    for fixed in (False, True):
        exp = replace(get_config('pre_vost_2', model='r50_deaotl'),
                      test_fixed_mem_gap=fixed, test_long_term_mem_gap=3)
        jexp = replace(jax_get_config('pre_vost_2', model='r50_deaotl'),
                       test_fixed_mem_gap=fixed, test_long_term_mem_gap=3)
        for frames in (40, 400):
            assert ev.sequence_mem_gap(exp, cfg, frames) == \
                jev.sequence_mem_gap(jexp, jexp.model, frames)


@pytest.mark.parametrize('groups', [1, 2, 3])
@pytest.mark.parametrize('how', ['soft', 'min'])
def test_group_aggregation_matches_jax(groups, how):
    """The port aggregates [G, C, H, W], the JAX package [G, H, W, C]."""
    rng = np.random.RandomState(groups)
    logits = (rng.randn(groups, 9, 13, 11) * 3).astype(np.float32)
    fn, jfn = {'soft': (ev.soft_aggregate_group_logits,
                        jev.soft_aggregate_group_logits),
               'min': (ev.min_aggregate_group_logits,
                       jev.min_aggregate_group_logits)}[how]
    got = fn(torch.from_numpy(logits).permute(0, 3, 1, 2), 12, 10)
    want = np.asarray(jfn(jnp.asarray(logits), 12, 10))
    assert got.shape == (1, 10 * groups + 1, 9, 13)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def _write_clip(root, seq, n=4, size=(61, 83), labelled=(0, 2)):
    """JPEG frames and palette PNG labels; frame 2 adds object 5."""
    rng = np.random.RandomState(3)
    os.makedirs(os.path.join(root, 'JPEGImages', seq), exist_ok=True)
    os.makedirs(os.path.join(root, 'Annotations', seq), exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.rand(*size, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, 'JPEGImages', seq, f'{i:05d}.jpg'))
    for i in labelled:
        lbl = np.zeros(size, np.uint8)
        lbl[5:20, 5:30] = 1
        lbl[25:40, 40:70] = 3
        if i:
            lbl[45:55, 10:30] = 5
        jmasks.save_mask_png(lbl, os.path.join(root, 'Annotations', seq,
                                               f'{i:05d}.png'))


def _same_sequence(seq, jseq):
    for name in ('images', 'labels', 'obj_nums', 'obj_indices',
                 'image_root', 'label_root'):
        assert getattr(seq, name, None) == getattr(jseq, name, None), name
    assert getattr(seq, 'images_sparse', None) == getattr(
        jseq, 'images_sparse', None)
    for idx in range(len(jseq)):
        got, want = seq.frame(idx), jseq.frame(idx)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for name in ('name', 'height', 'width', 'obj_num', 'obj_idx',
                         'flip', 'scale'):
                assert getattr(g, name) == getattr(w, name), name
            assert g.image.dtype == w.image.dtype
            np.testing.assert_array_equal(g.image, w.image)
            if w.label is None:
                assert g.label is None
            else:
                np.testing.assert_array_equal(g.label, w.label)


def test_sequence_samples_match_jax(tmp_path):
    """Flip and two scales: four samples per frame with the same images,
    labels (squeezed ids), names, sizes and object tables."""
    root = str(tmp_path)
    _write_clip(root, 'clip')
    kw = dict(max_size=1040, align_corners=True, multi_scale=(1.0, 1.3),
              flip=True)
    args = (os.path.join(root, 'JPEGImages'),
            os.path.join(root, 'Annotations'), 'clip',
            sorted(os.listdir(os.path.join(root, 'JPEGImages', 'clip'))),
            ['00000.png', '00002.png'])
    seq, jseq = ds.VOSSequence(*args, **kw), jds.VOSSequence(*args, **kw)
    _same_sequence(seq, jseq)
    samples = seq.frame(2)
    assert [(s.scale, s.flip) for s in samples] == [
        (1.0, False), (1.0, True), (1.3, False), (1.3, True)]
    assert samples[2].image.shape == (81, 113, 3)
    # object 5 arrives at frame 2 and is squeezed to id 3
    assert seq.obj_indices[2] == [0, 1, 3, 5] and seq.obj_nums == [2, 2, 2,
                                                                   3]
    assert set(np.unique(samples[0].label)) == {0, 1, 2, 3}
    # DAVIS 2016: every object is one
    _same_sequence(ds.VOSSequence(*args, single_obj=True),
                   jds.VOSSequence(*args, single_obj=True))


def _img(path, size=(8, 8)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.zeros(size + (3,), np.uint8)).save(path)


def _png(path, size=(8, 8)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.zeros(size, np.uint8), mode='P').save(path)


def test_dataset_layouts_match_jax(tmp_path):
    """DAVIS 480p / Full-Resolution, VOST (10 fps and oracle frames),
    YouTube-VOS sparse and _all_frames, Long Videos, the synthetic set; the
    frame-0 annotation is copied into the results."""
    root = str(tmp_path / 'DAVIS')
    for res in ('480p', 'Full-Resolution'):
        for f in ('00000', '00001'):
            _img(os.path.join(root, 'JPEGImages', res, 'seqA', f + '.jpg'))
        _png(os.path.join(root, 'Annotations', res, 'seqA', '00000.png'))
    os.makedirs(os.path.join(root, 'ImageSets', '2017'))
    with open(os.path.join(root, 'ImageSets', '2017', 'val.txt'), 'w') as f:
        f.write('seqA\n')
    for full_res in (False, True):
        out = str(tmp_path / f'out_{full_res}')
        d = ds.build_davis_dataset(root, 'val', 2017, full_res=full_res,
                                   result_root=out)
        jd = jds.build_davis_dataset(root, 'val', 2017, full_res=full_res)
        _same_sequence(d.sequences['seqA'], jd.sequences['seqA'])
        assert os.path.exists(os.path.join(out, 'seqA', '00000.png'))

    root = str(tmp_path / 'VOST')
    for sub in ('JPEGImages', 'JPEGImages_10fps'):
        for f in ('00000', '00001'):
            _img(os.path.join(root, sub, 'v1', f + '.jpg'))
    for f in ('00000', '00001'):
        _png(os.path.join(root, 'Annotations', 'v1', f + '.png'))
    os.makedirs(os.path.join(root, 'ImageSets'))
    with open(os.path.join(root, 'ImageSets', 'val.txt'), 'w') as f:
        f.write('v1\n')
    for oracle in (False, True):
        _same_sequence(
            ds.build_vost_dataset(root, oracle=oracle).sequences['v1'],
            jds.build_vost_dataset(root, oracle=oracle).sequences['v1'])

    root = str(tmp_path / 'YTB')
    sparse_base = os.path.join(root, '2019', 'valid')
    for f in ('00005', '00015'):
        _img(os.path.join(sparse_base, 'JPEGImages', 'vid1', f + '.jpg'))
    _png(os.path.join(sparse_base, 'Annotations', 'vid1', '00005.png'))
    for i in range(0, 21, 5):
        _img(os.path.join(sparse_base + '_all_frames', 'JPEGImages', 'vid1',
                          f'{i:05d}.jpg'))
    with open(os.path.join(sparse_base, 'meta.json'), 'w') as f:
        json.dump({'videos': {'vid1': {'objects': {
            '1': {'frames': ['00005', '00015']}}}}}, f)
    for all_frames in (False, True):
        seq = ds.build_youtubevos_dataset(
            root, all_frames=all_frames).sequences['vid1']
        _same_sequence(seq, jds.build_youtubevos_dataset(
            root, all_frames=all_frames).sequences['vid1'])
    assert seq.images == ['00005.jpg', '00010.jpg', '00015.jpg']
    assert seq.images_sparse == {'00005.jpg', '00015.jpg'}

    root = str(tmp_path / 'LV')
    _img(os.path.join(root, 'JPEGImages', 'long1', '00000.jpg'))
    _png(os.path.join(root, 'Annotations', 'long1', '00000.png'))
    _same_sequence(ds.build_long_videos_dataset(root).sequences['long1'],
                   jds.build_long_videos_dataset(root).sequences['long1'])

    syn, jsyn = ds.build_synthetic_dataset(2), jds.build_synthetic_dataset(2)
    for (name, seq), (jname, jseq) in zip(syn.items(), jsyn.items()):
        assert name == jname
        _same_sequence(seq, jseq)


def test_mask_png_matches_jax_writer(tmp_path):
    rng = np.random.RandomState(5)
    mask = (rng.rand(37, 53) * 4).astype(np.uint8)
    squeeze = [0, 3, 7, 12]
    path, jpath = str(tmp_path / 'a.png'), str(tmp_path / 'b.png')
    masks.save_mask_png(mask, path, squeeze_idx=squeeze)
    jmasks.save_mask_png(mask, jpath, squeeze_idx=squeeze)
    with open(path, 'rb') as f, open(jpath, 'rb') as g:
        assert f.read() == g.read()
    im = Image.open(path)
    assert im.mode == 'P'
    assert im.getpalette() == jmasks.VOS_PALETTE == masks.VOS_PALETTE
    got = masks.read_mask_png(path)
    np.testing.assert_array_equal(got, np.array(squeeze, np.uint8)[mask])
    np.testing.assert_array_equal(got, jmasks.read_mask_png(jpath))
    masks.save_mask_png(mask, path)
    np.testing.assert_array_equal(masks.read_mask_png(path), mask)
    np.testing.assert_array_equal(masks.label2colormap(mask),
                                  jmasks.label2colormap(mask))


def _random_masks(rng, n, h, w, n_obj):
    """Blobby id masks (smooth noise thresholded) with void pixels."""
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        noise = rng.rand(h // 4 + 1, w // 4 + 1)
        big = np.kron(noise, np.ones((4, 4)))[:h, :w]
        out[i] = np.minimum((big * (n_obj + 1)).astype(np.uint8), n_obj)
    out[:, :2, :] = 255
    return out


def test_metrics_and_scorer_match_jax(tmp_path):
    rng = np.random.RandomState(9)
    for _ in range(6):
        a = rng.rand(40, 57) > 0.6
        b = rng.rand(40, 57) > 0.5
        void = rng.rand(40, 57) > 0.9
        assert metrics.db_eval_iou(a, b, void) == jmetrics.db_eval_iou(
            a, b, void)
        assert metrics.f_measure(b, a, void) == jmetrics.f_measure(b, a,
                                                                   void)
        assert metrics.f_measure(b, a) == jmetrics.f_measure(b, a)
    stack = rng.rand(3, 40, 57) > 0.5
    np.testing.assert_array_equal(metrics.db_eval_iou(stack, stack[::-1]),
                                  jmetrics.db_eval_iou(stack, stack[::-1]))
    vals = rng.rand(23)
    assert metrics.db_statistics(vals) == jmetrics.db_statistics(vals)

    gt_root, res = tmp_path / 'gt', tmp_path / 'res'
    os.makedirs(gt_root / 'ImageSets')
    with open(gt_root / 'ImageSets' / 'val.txt', 'w') as f:
        f.write('s1\ns2\n')
    for seq, n_obj in (('s1', 2), ('s2', 3)):
        gt = _random_masks(rng, 7, 48, 64, n_obj)
        pred = gt.copy()
        pred[:, 20:30] = (rng.rand(7, 10, 64) * (n_obj + 1)).astype(np.uint8)
        os.makedirs(gt_root / 'Annotations' / seq)
        os.makedirs(res / seq)
        for i in range(7):
            masks.save_mask_png(gt[i], str(gt_root / 'Annotations' / seq /
                                           f'{i:05d}.png'))
            masks.save_mask_png(pred[i], str(res / seq / f'{i:05d}.png'))
    got = scorer.evaluate_semisupervised(scorer.GTDataset(str(gt_root)),
                                         str(res), with_boundary=True)
    want = jscorer.evaluate_semisupervised(jscorer.GTDataset(str(gt_root)),
                                           str(res), with_boundary=True)
    assert got == want
    summary = scorer.summarize(got)
    assert summary == jscorer.summarize(want)
    assert 0.0 < summary['J&F'] < 1.0


def test_config_from_jax_snapshot():
    """A JAX config_to_dict snapshot, through JSON, keeps every field,
    the training recipe included; unknown fields raise."""
    jexp = replace(
        jax_get_config('pre_vost_2', 'snap', 'r50_deaotl',
                       latter_mem_len=4, no_memory_gap=True),
        test_flip=True, test_multiscale=(1.0, 1.3), test_aggregation='min',
        test_dataset='vost', test_ckpt_path='x.pth', test_min_size=480,
        test_fixed_mem_gap=True, test_dataset_full_resolution=True,
        compute_dtype='bfloat16', dir_root='/tmp/r', train_lr=1.0)
    snap = json.loads(json.dumps(config_to_dict(jexp)))
    exp = config_from_dict(snap)
    for f in fields(exp.model):
        assert getattr(exp.model, f.name) == getattr(jexp.model, f.name), \
            f.name
    for f in fields(exp):
        if f.name != 'model':
            assert getattr(exp, f.name) == getattr(jexp, f.name), f.name
    assert exp.test_multiscale == (1.0, 1.3)
    assert exp.dir_result() == jexp.dir_result()
    assert set(snap) == {f.name for f in fields(exp)}
    assert exp.train_lr == 1.0
    snap['test_new_knob'] = 1
    with pytest.raises(ValueError, match='test_new_knob'):
        config_from_dict(snap)


@pytest.mark.parametrize('model', ['r50_deaotl', 'r50_aotl'])
def test_every_stage_matches_jax(model):
    """Every stage of the JAX package, with the model settings it
    overrides, gives the port's config field for field, and its result
    directory."""
    assert set(STAGE_REGISTRY) == set(JAX_STAGES)
    for stage in JAX_STAGES:
        port = get_config(stage, 'x', model)
        ref = jax_get_config(stage, 'x', model)
        for f in fields(port.model):
            assert getattr(port.model, f.name) == getattr(ref.model,
                                                          f.name), (stage,
                                                                    f.name)
        for f in fields(port):
            if f.name != 'model':
                assert getattr(port, f.name) == getattr(ref, f.name), (
                    stage, f.name)
        assert port.dir_result() == ref.dir_result()
