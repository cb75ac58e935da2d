"""The port's training data (data/video_transforms.py,
data/train_datasets.py) against the JAX package's: the same files and
seeds give identical samples (np.array_equal) for every transform, every
dataset layout, the prev-frame episode, the dynamic merge and the loader's
rank shards across an epoch boundary."""
import json
import os

import cv2
import numpy as np
import pytest

from rmem_ocu_tpu.config import get_config as jax_get_config
from rmem_ocu_tpu.data import train_datasets as jax_td
from rmem_ocu_tpu.data import video_transforms as jax_vt

import torch_threads  # noqa: F401
import chip_smoke
from rmem_ocu_tpu_torch.config import get_config
from rmem_ocu_tpu_torch.data import train_datasets as td
from rmem_ocu_tpu_torch.data import video_transforms as vt

SIZE = (48, 72)
N_FRAMES = 6
# a non-square crop and a short edge of 96 keep the samples small
CFG = dict(data_randomcrop=(40, 56), data_short_edge_len=96, data_seq_len=3)


def configs(**overrides):
    kw = dict(CFG, **overrides)
    return (get_config('pre_vost_2', model='aott', **kw),
            jax_get_config('pre_vost_2', model='aott', **kw))


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype and np.array_equal(x, y), k
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def raw_sample(seed, n_obj=3, size=SIZE, t=3):
    """An untransformed sample: frames [T][H,W,3] f32 0-255, labels
    [T][H,W] u8 with n_obj blobs and an ignore (255) band."""
    rng = np.random.RandomState(seed)
    h, w = size
    yy, xx = np.mgrid[:h, :w]
    labels = []
    for _ in range(t):
        lbl = np.zeros(size, np.uint8)
        for o in range(1, n_obj + 1):
            cy, cx = rng.rand(2) * size
            lbl[(yy - cy) ** 2 + (xx - cx) ** 2 < (0.2 * h) ** 2] = o
        lbl[:2] = 255
        labels.append(lbl)
    frames = [rng.rand(h, w, 3).astype(np.float32) * 255 for _ in range(t)]
    return {'frames': frames, 'labels': labels, 'obj_num': n_obj}


def copy(sample):
    return {k: list(v) if isinstance(v, list) else v
            for k, v in sample.items()}


TRANSFORMS = {
    'random_scale': lambda m, s, r, c: m.random_scale(s, r, 0.7, 1.3, 96),
    'balanced_random_crop': lambda m, s, r, c: m.balanced_random_crop(
        s, r, (40, 56), 10, 4),
    'random_horizontal_flip': lambda m, s, r, c:
        m.random_horizontal_flip(s, r),
    'resize_with_padding': lambda m, s, r, c: m.resize_with_padding(
        s, r, (64, 80)),
    'normalize_stack': lambda m, s, r, c: m.normalize_stack(s),
    'train_transform': lambda m, s, r, c: m.train_transform(s, r, c),
}


@pytest.mark.parametrize('n_obj', [0, 3, 12], ids=['empty', '3obj',
                                                  '12obj'])
@pytest.mark.parametrize('name', list(TRANSFORMS))
def test_transform_matches_jax(name, n_obj):
    """Each transform on seeded samples, over several draws: no object
    (the crop gives up), 3 objects, and 12 (more than max_obj_num: the
    crop shuffles)."""
    cfg, jcfg = configs()
    for seed in range(4):
        sample = raw_sample(seed, n_obj)
        rngs = np.random.RandomState(seed), np.random.RandomState(seed)
        got = TRANSFORMS[name](vt, copy(sample), rngs[0], cfg)
        want = TRANSFORMS[name](jax_vt, copy(sample), rngs[1], jcfg)
        assert_same(got, want)
        assert rngs[0].randint(2 ** 31) == rngs[1].randint(2 ** 31)


@pytest.mark.parametrize('ignore_in_merge', [False, True])
def test_merge_samples_matches_jax(ignore_in_merge):
    cfg, _ = configs()
    for seed, n_obj in ((0, 3), (1, 7), (2, 12)):
        s1 = vt.normalize_stack(raw_sample(seed, n_obj))
        s2 = vt.normalize_stack(raw_sample(seed + 10, n_obj))
        got = td.merge_samples(s1, s2, np.random.RandomState(seed),
                               max_obj_n=5, ignore_in_merge=ignore_in_merge)
        want = jax_td.merge_samples(s1, s2, np.random.RandomState(seed),
                                    max_obj_n=5,
                                    ignore_in_merge=ignore_in_merge)
        assert_same(got, want)


# ------------------------------------------------------------- layouts
def write_split(root, names, split_dir, split='train'):
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, f'{split}.txt'), 'w') as f:
        f.write('\n'.join(names) + '\n')


def write_davis(root, rng):
    for i in range(3):
        chip_smoke.write_sequence(
            os.path.join(root, 'DAVIS', 'JPEGImages', '480p', f's{i}'),
            os.path.join(root, 'DAVIS', 'Annotations', '480p', f's{i}'),
            SIZE, N_FRAMES, rng)
    write_split(root, ['s0', 's1', 's2'],
                os.path.join(root, 'DAVIS', 'ImageSets', '2017'))


def write_vost(root, rng, name='VOST'):
    for i in range(3):
        chip_smoke.write_sequence(
            os.path.join(root, name, 'JPEGImages', f's{i}'),
            os.path.join(root, name, 'Annotations', f's{i}'),
            SIZE, N_FRAMES, rng)
    write_split(root, ['s0', 's1', 's2'],
                os.path.join(root, name, 'ImageSets'))


def write_youtubevos(root, rng):
    """Labels on every other frame; the meta lists each object's frames
    (an object seen once is dropped, as a sequence under 2 frames)."""
    base = os.path.join(root, 'YTB', '2019', 'train')
    videos = {}
    for i in range(3):
        chip_smoke.write_sequence(
            os.path.join(base, 'JPEGImages', f'v{i}'),
            os.path.join(base, 'Annotations', f'v{i}'),
            SIZE, N_FRAMES, rng, n_obj=2, label_every=2)
        frames = [f'{t:05d}' for t in range(0, N_FRAMES, 2)]
        videos[f'v{i}'] = {'objects': {'1': {'frames': frames},
                                       '2': {'frames': frames[:1]}}}
    videos['lone'] = {'objects': {'1': {'frames': ['00000']}}}
    with open(os.path.join(base, 'meta.json'), 'w') as f:
        json.dump({'videos': videos}, f)


def write_static(root, rng):
    for sub in ('COCO', 'ECSSD'):
        img_dir = os.path.join(root, 'Static', 'JPEGImages', sub)
        ann_dir = os.path.join(root, 'Static', 'Annotations', sub)
        chip_smoke.write_sequence(img_dir, ann_dir, SIZE, 2, rng)


def write_extracted(root, rng):
    d = os.path.join(root, 'extracted_frames')
    os.makedirs(d)
    for n in range(3):
        img = (rng.rand(*SIZE, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(d, f'frame_{n}.jpg'), img)
        shapes = [{'label': 'a', 'points': [[4, 4], [30, 6], [28, 30]]},
                  {'label': 'b', 'points': [[40, 10], [70, 10], [70, 40],
                                            [40, 40]]}]
        with open(os.path.join(d, f'frame_{n}.json'), 'w') as f:
            json.dump({'shapes': shapes}, f)


LAYOUTS = {
    'vost': (('vost',), write_vost),
    'davis': (('davis2017',), write_davis),
    'youtubevos': (('youtubevos',), write_youtubevos),
    'visor': (('visor',), lambda r, g: write_vost(r, g, 'VISOR')),
    'static': (('static',), write_static),
    'extracted_frames': (('extracted_frames',), write_extracted),
    'synthetic': (('test',), None),
    'concat': (('vost', 'davis2017'), None),
}


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('train_data'))
    rng = np.random.RandomState(0)
    for _, writer in LAYOUTS.values():
        if writer is not None:
            writer(root, rng)
    return root


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_dataset_samples_match_jax(layout, data_root):
    """build_train_dataset of each layout: the same length, and each
    index's sample under two seeds identical to the JAX package's."""
    datasets, _ = LAYOUTS[layout]
    cfg, jcfg = configs(dir_data=data_root, datasets=datasets)
    ds, jds = td.build_train_dataset(cfg), jax_td.build_train_dataset(jcfg)
    assert type(ds).__name__ == type(jds).__name__
    n = len(ds)
    assert n == len(jds) and n > 0
    obj_nums = []
    for idx in (range(n) if n < 100 else (0, n - 1)):
        for seed in (idx, 1000 + idx):
            got = ds.get(idx, np.random.RandomState(seed))
            assert_same(got, jds.get(idx, np.random.RandomState(seed)))
            assert got['frames'].shape[1:3] == (40, 56)
            obj_nums.append(got['obj_num'])
    assert max(obj_nums) > 0


def test_prev_frame_layout_matches_jax(data_root):
    cfg, jcfg = configs(dir_data=data_root, datasets=('vost',),
                        enable_prev_frame=True, data_seq_len=4)
    ds, jds = td.build_train_dataset(cfg), jax_td.build_train_dataset(jcfg)
    assert ds.enable_prev_frame and jds.enable_prev_frame
    for idx in range(len(ds)):
        for seed in (idx, 77 + idx):
            assert_same(ds.sample_sequence(idx, np.random.RandomState(seed)),
                        jds.sample_sequence(idx,
                                            np.random.RandomState(seed)))
            assert_same(ds.get(idx, np.random.RandomState(seed)),
                        jds.get(idx, np.random.RandomState(seed)))


@pytest.mark.parametrize('rank', [0, 1])
def test_loader_shards_match_jax(rank, data_root):
    """world=2 over the 3 VOST sequences: rank 0 reads 2 a epoch and rank
    1 one, so 3 batches cross an epoch boundary on either rank; the
    ranks' first-epoch indices are disjoint."""
    cfg, jcfg = configs(dir_data=data_root, datasets=('vost',))
    loaders = [m.TrainDataLoader(m.build_train_dataset(c), 1, seed=5,
                                 rank=rank, world=2, num_workers=2)
               for m, c in ((td, cfg), (jax_td, jcfg))]
    got, want = (iter(ld) for ld in loaders)
    for _ in range(3):
        assert_same(next(got), next(want))
    order = np.random.RandomState(5).permutation(3)
    assert set(order[0::2]).isdisjoint(order[1::2])
