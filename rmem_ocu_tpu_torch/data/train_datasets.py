"""Training datasets and their loader (host-side numpy).

The port's copy of the JAX package's `data/train_datasets.py`: the same
files, the same draws from the same `np.random.RandomState` in the same
order, so that a seeded sample and a loader batch are identical in both
packages. Reference: aot_plus/dataloaders/train_datasets.py — the VOSTrain
sampling base (:238-597: reference-frame selection with fg/ignore filters,
random gaps with reflect-at-bounds indexing, random sequence reversal,
dynamic two-clip merge) and the per-benchmark variants (DAVIS2017 :600,
VOST :655, VISOR :707, YouTube-VOS :757, TEST :821, StaticTrain :92,
ExtractedFrames :870), every one of them wired into `build_train_dataset`.

Batches stay numpy, {frames [B,T,H,W,3] f32, masks [B,T,H,W] i32,
obj_nums [B] i32}; the train CLI moves each to the device.
"""
from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from rmem_ocu_tpu_torch.data.eval_datasets import _read_image, _read_label
from rmem_ocu_tpu_torch.data.video_transforms import augment, train_transform


def merge_samples(s1: Dict, s2: Dict, rng: np.random.RandomState,
                  min_obj_pixels=100, max_obj_n=10,
                  ignore_in_merge=False) -> Dict:
    """Dynamic merge: paste clip2's foreground onto clip1, relabel ids
    +max_obj_n, drop sub-threshold objects (reference :28-89). Operates on
    transformed samples (frames [T,H,W,3], masks [T,H,W])."""
    frames1, masks1 = s1['frames'], s1['masks']
    frames2, masks2 = s2['frames'], s2['masks']

    out_frames = np.empty_like(frames1)
    out_masks = np.empty_like(masks1)
    selected: Optional[np.ndarray] = None
    selected_obj = None
    obj_num = 0
    for idx in range(frames1.shape[0]):
        fg2 = (masks2[idx] > 0) & (masks2[idx] != 255)
        merged_img = np.where(fg2[..., None], frames2[idx], frames1[idx])
        merged = np.where(fg2, masks2[idx] + max_obj_n, masks1[idx])
        one_hot = merged[None] == np.arange(max_obj_n * 2 + 1)[:, None, None]
        if idx == 0:
            selected = one_hot.sum(axis=(1, 2)) > min_obj_pixels
            selected[0] = True
            obj_num = int(selected.sum()) - 1
            if obj_num > max_obj_n:
                order = list(range(1, obj_num + 1))
                rng.shuffle(order)
                selected_obj = [0] + order[:max_obj_n]
        kept = one_hot[selected]
        if selected_obj is not None:
            kept = kept[selected_obj]
        score = kept.astype(np.float32)
        score[0] += 0.1
        new_mask = np.argmax(score, axis=0).astype(masks1.dtype)
        if ignore_in_merge:
            ign = ((masks1[idx] == 255) | (masks2[idx] == 255)) & (
                new_mask == 0)
            new_mask = np.where(ign, 255, new_mask)
        out_frames[idx] = merged_img
        out_masks[idx] = new_mask

    return {'frames': out_frames, 'masks': out_masks,
            'obj_num': min(obj_num, max_obj_n)}


def _obj_num(ref_objs) -> int:
    """The largest object id of the reference label, 255 (ignore) aside."""
    obj_ids = sorted(ref_objs)
    return int(obj_ids[-2] if 255 in obj_ids else obj_ids[-1])


class VOSTrainDataset:
    """Base sampler over {seq_name: (images, labels)} listings."""

    def __init__(self, image_root, label_root, imglistdic, cfg,
                 rand_gap=3, seq_len=5, rand_reverse=True,
                 dynamic_merge=True, merge_prob=0.3, max_obj_n=10,
                 ignore_thresh=1.0, ignore_in_merge=False, repeat_time=1,
                 rgb=True, enable_prev_frame=None):
        self.image_root = image_root
        self.label_root = label_root
        self.imglistdic = imglistdic
        self.seqs = list(imglistdic.keys())
        self.cfg = cfg
        self.rand_gap = rand_gap
        self.seq_len = seq_len
        self.rand_reverse = rand_reverse
        self.dynamic_merge = dynamic_merge
        self.merge_prob = merge_prob
        self.max_obj_n = max_obj_n
        self.ignore_thresh = ignore_thresh
        self.ignore_in_merge = ignore_in_merge
        self.repeat_time = repeat_time
        self.rgb = rgb
        # prev-frame episode layout (reference ENABLE_PREV_FRAME,
        # train_datasets.py:264, 460-492): off in every recipe
        self.enable_prev_frame = (cfg.enable_prev_frame
                                  if enable_prev_frame is None
                                  else enable_prev_frame)

    def __len__(self):
        return int(len(self.seqs) * self.repeat_time)

    def _label(self, seqname, name):
        return _read_label(os.path.join(self.label_root, seqname, name))

    # ---------- index sampling (reference :319-409) ----------
    def _ref_index(self, rng, seqname, lablist, min_fg_pixels=200,
                   max_try=40, total_gap=0):
        search = len(lablist) - total_gap
        if search <= 1:
            return 0
        for _ in range(max_try):
            ref = rng.randint(search)
            label = self._label(seqname, lablist[ref])
            n_ign = int(np.sum(label == 255))
            n_fg = int(np.sum(label > 0))
            if n_fg > min_fg_pixels and (n_ign / max(n_fg, 1)) <= \
                    self.ignore_thresh:
                return ref
        return ref

    def _ref_index_v1(self, rng, seqname, lablist, objs,
                      min_fg_pixels=200, max_try=5):
        """Object-consistency reference pick (reference get_ref_index,
        train_datasets.py:292-317): accept a random annotated frame only
        if every object it contains is in the episode's `objs` set and it
        has > min_fg_pixels foreground. The reference recipes never call
        it; kept as the JAX package keeps it."""
        bad = set()
        ref = 0
        for _ in range(max_try):
            ref = rng.randint(len(lablist))
            if ref in bad:
                continue
            label = self._label(seqname, lablist[ref])
            consistent = all(o == 0 or o in objs for o in np.unique(label))
            if int(np.sum(label != 0)) > min_fg_pixels and consistent:
                break
            bad.add(ref)
        return ref

    def _gaps(self, rng, n, labels, images, start_ind, max_gap=99,
              max_try=10):
        for _ in range(max_try):
            gaps = [int(rng.randint(self.rand_gap) + 1) for _ in range(n)]
            total = sum(gaps)
            if total > max_gap:
                continue
            if start_ind + total < len(images):
                name = os.path.splitext(images[start_ind + total])[0] + '.png'
                if name in labels:
                    return gaps, total
        gaps = [1] * min(n, len(images) - start_ind)
        gaps += [0] * (n - len(gaps))
        return gaps, len(images) - start_ind

    @staticmethod
    def _reflect(total_len, index):
        if total_len <= 1:
            return 0
        while index < 0 or index >= total_len:
            if index < 0:
                index = -index
            elif index >= total_len:
                index = 2 * (total_len - 1) - index
        return index

    def _image_label(self, seqname, imagelist, lablist, index,
                     is_ref=False):
        name = os.path.splitext((lablist if is_ref else imagelist)[index])[0]
        image = _read_image(os.path.join(self.image_root, seqname,
                                         name + '.jpg'), self.rgb)
        lbl = name + '.png'
        label = self._label(seqname, lbl) if lbl in lablist else None
        return image, label

    def _prev_index(self, rng, lablist, total_gap):
        """Random prev-frame start (reference get_prev_index :384-390)."""
        search = len(lablist) - total_gap
        return rng.randint(search) if search > 1 else 0

    def _sample_prev_frame_layout(self, rng, seqname, imagelist, lablist):
        """ENABLE_PREV_FRAME episode: prev frame sampled anywhere, curr
        frames walk from it, ref sampled independently and re-drawn (<=5
        tries) to land outside the prev..curr window.

        As in the JAX package, this follows the upstream AOT layout with
        seq_len-2 gaps (the reference fork's branch, :460-492, reads
        variables it never assigns), keeping the episode at seq_len frames
        (ref + prev + seq_len-2 curr). Every index lives in lablist space
        and frames are read by lablist-derived name, so the episode trains
        on annotated frames only."""
        gaps, total_gap = self._gaps(rng, self.seq_len - 2, set(lablist),
                                     lablist, 0)
        prev_index = self._prev_index(rng, lablist, total_gap)
        prev_image, prev_label = self._image_label(
            seqname, imagelist, lablist, prev_index, is_ref=True)
        frames, labels = [prev_image], [prev_label]
        objs = (set(np.unique(prev_label)) if prev_label is not None
                else set())
        now = prev_index
        end_index = prev_index
        for gap in gaps:
            now = self._reflect(len(lablist), now + gap)
            end_index = max(end_index, now)
            img, lab = self._image_label(seqname, imagelist, lablist, now,
                                         is_ref=True)
            if lab is not None:
                objs |= set(np.unique(lab))
            frames.append(img)
            labels.append(lab)

        # ref outside (prev_index, end_index] (reference :484-490)
        ref_index = self._ref_index(rng, seqname, lablist)
        for _ in range(5):
            if not (prev_index < ref_index <= end_index):
                break
            ref_index = self._ref_index(rng, seqname, lablist)
        ref_image, ref_label = self._image_label(
            seqname, imagelist, lablist, ref_index, is_ref=True)
        frames = [ref_image] + frames
        labels = [ref_label] + [
            l if l is not None else np.full(ref_label.shape, 255, np.uint8)
            for l in labels]
        return frames, labels, set(np.unique(ref_label)), objs

    # ---------- sequence sampling (reference :446-577) ----------
    def sample_sequence(self, idx, rng) -> Dict:
        seqname = self.seqs[idx % len(self.seqs)]
        imagelist, lablist = self.imglistdic[seqname]
        imagelist, lablist = list(imagelist), list(lablist)
        if self.rand_reverse and rng.randint(2) == 1:
            imagelist = imagelist[::-1]
            lablist = lablist[::-1]

        if self.enable_prev_frame:
            for _ in range(5):
                frames, labels, ref_objs, objs = \
                    self._sample_prev_frame_layout(rng, seqname, imagelist,
                                                   lablist)
                if all(o in ref_objs or o == 0 for o in objs):
                    break
            return {'frames': frames, 'labels': labels,
                    'obj_num': _obj_num(ref_objs)}

        for _ in range(5):
            ref_index = self._ref_index(rng, seqname, lablist,
                                        total_gap=self.seq_len)
            gaps, _ = self._gaps(rng, self.seq_len - 1, set(lablist),
                                 imagelist, ref_index)
            ref_image, ref_label = self._image_label(
                seqname, imagelist, lablist, ref_index, is_ref=True)
            ref_objs = set(np.unique(ref_label))

            frames, labels = [ref_image], [ref_label]
            objs = set()
            now = ref_index
            for gap in gaps:
                now = self._reflect(len(imagelist), now + gap)
                img, lab = self._image_label(seqname, imagelist, lablist,
                                             now)
                if lab is None:
                    lab = np.full(ref_label.shape, 255, np.uint8)
                else:
                    objs |= set(np.unique(lab))
                frames.append(img)
                labels.append(lab)
            if all(o == 0 or o in ref_objs for o in objs):
                break

        return {'frames': frames, 'labels': labels,
                'obj_num': _obj_num(ref_objs)}

    def __getitem__(self, idx):
        return self.get(idx, np.random.RandomState(
            np.random.randint(2 ** 31)))

    def get(self, idx, rng: np.random.RandomState) -> Dict:
        s1 = train_transform(self.sample_sequence(idx, rng), rng, self.cfg)
        if self.dynamic_merge and (s1['obj_num'] == 0
                                   or rng.rand() < self.merge_prob):
            rand_idx = rng.randint(len(self.seqs))
            while rand_idx == (idx % len(self.seqs)):
                rand_idx = rng.randint(len(self.seqs))
            s2 = train_transform(self.sample_sequence(rand_idx, rng), rng,
                                 self.cfg)
            return merge_samples(s1, s2, rng, max_obj_n=self.max_obj_n,
                                 ignore_in_merge=self.ignore_in_merge)
        return s1


def _listdir_pairs(image_root, label_root, seq_names):
    return {name: (sorted(os.listdir(os.path.join(image_root, name))),
                   sorted(os.listdir(os.path.join(label_root, name))))
            for name in seq_names}


def _read_split(path):
    with open(path) as f:
        return [s.strip() for s in f if s.strip()]


def _split_dataset(cfg, image_root, label_root, split_files, **kw):
    """A VOSTrainDataset over the sequences the split files list, each
    with every file of its image and label directories."""
    names = []
    for path in split_files:
        names += _read_split(path)
    return VOSTrainDataset(
        image_root, label_root, _listdir_pairs(image_root, label_root, names),
        cfg, seq_len=cfg.data_seq_len,
        rand_reverse=cfg.data_random_reverse_seq,
        merge_prob=cfg.data_dynamic_merge_prob,
        max_obj_n=cfg.model.max_obj_num, **kw)


def build_davis_train(cfg, root, split=('train',), year=2017,
                      full_resolution=False):
    res = 'Full-Resolution' if full_resolution else '480p'
    if not os.path.exists(os.path.join(root, 'JPEGImages', res)):
        res = '480p'
    return _split_dataset(
        cfg, os.path.join(root, 'JPEGImages', res),
        os.path.join(root, 'Annotations', res),
        [os.path.join(root, 'ImageSets', str(year), s + '.txt')
         for s in split],
        rand_gap=cfg.data_random_gap_davis, repeat_time=cfg.data_davis_repeat)


def build_vost_train(cfg, root, split=('train',)):
    return _split_dataset(
        cfg, os.path.join(root, 'JPEGImages'),
        os.path.join(root, 'Annotations'),
        [os.path.join(root, 'ImageSets', s + '.txt') for s in split],
        rand_gap=cfg.data_random_gap_vost,
        ignore_thresh=cfg.data_vost_ignore_thresh,
        ignore_in_merge=cfg.ignore_in_merge, repeat_time=cfg.data_vost_repeat)


def build_visor_train(cfg, root, split=('train',)):
    return _split_dataset(
        cfg, os.path.join(root, 'JPEGImages'),
        os.path.join(root, 'Annotations'),
        [os.path.join(root, 'ImageSets', s + '.txt') for s in split],
        rand_gap=cfg.data_random_gap_visor,
        ignore_thresh=cfg.data_visor_ignore_thresh,
        repeat_time=cfg.data_visor_repeat)


def build_youtubevos_train(cfg, root, year=2019):
    base = os.path.join(root, str(year), 'train')
    with open(os.path.join(base, 'meta.json')) as f:
        meta = json.load(f)['videos']
    imglistdic = {}
    for seq, info in meta.items():
        images, labels = [], []
        for obj in info['objects'].values():
            if len(obj['frames']) < 2:
                continue
            images += [x + '.jpg' for x in obj['frames']]
            labels += [x + '.png' for x in obj['frames']]
        if len(set(images)) >= 2:
            imglistdic[seq] = (sorted(set(images)), sorted(set(labels)))
    return VOSTrainDataset(
        os.path.join(base, 'JPEGImages'), os.path.join(base, 'Annotations'),
        imglistdic, cfg, rand_gap=cfg.data_random_gap_ytb,
        seq_len=cfg.data_seq_len, rand_reverse=cfg.data_random_reverse_seq,
        merge_prob=cfg.data_dynamic_merge_prob,
        max_obj_n=cfg.model.max_obj_num)


class StaticTrainDataset:
    """Synthesize a clip from one still image by random affine jitter
    (reference :92-235). Used for the 'pre' stage."""

    def __init__(self, cfg, root, seq_len=5):
        self.cfg = cfg
        self.seq_len = seq_len
        self.img_list: List[str] = []
        self.mask_list: List[str] = []
        for name in ('COCO', 'ECSSD', 'MSRA10K', 'PASCAL-S',
                     'PASCALVOC2012'):
            img_dir = os.path.join(root, 'JPEGImages', name)
            mask_dir = os.path.join(root, 'Annotations', name)
            imgs = sorted(glob(os.path.join(img_dir, '*.jpg'))) + \
                sorted(glob(os.path.join(img_dir, '*.png')))
            masks = sorted(glob(os.path.join(mask_dir, '*.png')))
            if imgs and len(imgs) == len(masks):
                self.img_list += imgs
                self.mask_list += masks
        self.max_obj_n = cfg.model.max_obj_num

    def __len__(self):
        return len(self.img_list)

    def _affine(self, img, mask, rng):
        import cv2
        h, w = img.shape[:2]
        ang = rng.uniform(-20, 20)
        scale = rng.uniform(0.9, 1.1)
        tx = rng.uniform(-0.1, 0.1) * w
        ty = rng.uniform(-0.1, 0.1) * h
        m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, scale)
        m[:, 2] += (tx, ty)
        img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_CUBIC,
                             borderValue=(124, 116, 104))
        mask = cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST,
                              borderValue=0)
        return img, mask

    @staticmethod
    def _color_jitter(img, rng, brightness=0.1, contrast=0.1,
                      saturation=0.1, hue=0.03):
        """torchvision-style ColorJitter (reference train_datasets.py:147)."""
        import cv2
        img = img * rng.uniform(1 - brightness, 1 + brightness)
        mean = img.mean()
        img = (img - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
        gray = img.mean(axis=-1, keepdims=True)
        img = (img - gray) * rng.uniform(1 - saturation,
                                         1 + saturation) + gray
        img = np.clip(img, 0, 255).astype(np.float32)
        hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
        hsv = hsv.astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-hue, hue) * 180)) % 180
        return cv2.cvtColor(hsv.astype(np.uint8),
                            cv2.COLOR_HSV2RGB).astype(np.float32)

    def get(self, idx, rng: np.random.RandomState) -> Dict:
        img = _read_image(self.img_list[idx])
        mask = np.minimum(_read_label(self.mask_list[idx]), self.max_obj_n)
        frames, labels = [img], [mask]
        for _ in range(1, self.seq_len):
            f, m = self._affine(self._color_jitter(img, rng), mask, rng)
            frames.append(f)
            labels.append(m)
        sample = {'frames': frames, 'labels': labels,
                  'obj_num': int(mask.max())}
        return augment(sample, rng, self.cfg, 1.0, 1.3, self.max_obj_n, 0.5)

    def __getitem__(self, idx):
        return self.get(idx, np.random.RandomState(
            np.random.randint(2 ** 31)))


def polygon_to_mask(shapes, height, width):
    """labelme polygon annotations -> id mask
    (reference train_datasets.py:857-867)."""
    import cv2
    mask = np.zeros((height, width), np.uint8)
    for i, shape in enumerate(shapes):
        points = np.array(shape['points'], np.int32)
        cv2.fillPoly(mask, [points], color=(i + 1))
    return mask


class ExtractedFramesTrainDataset:
    """Single labelme-annotated frames repeated into short clips (the
    reference's notebook fine-tuning dataset, train_datasets.py:870-1043).
    Each sample is one image + polygon JSON; the 'clip' is the same frame
    seq_len times."""

    def __init__(self, cfg, root='extracted_frames', seq_len=1):
        self.cfg = cfg
        self.seq_len = max(seq_len, 1)
        self.samples = []
        if os.path.isdir(root):
            for fn in sorted(os.listdir(root)):
                if not fn.endswith('.json'):
                    continue
                stem = os.path.join(root, os.path.splitext(fn)[0])
                img = stem + '.jpg'
                if not os.path.exists(img):
                    img = stem + '.png'
                if os.path.exists(img):
                    self.samples.append((img, os.path.join(root, fn)))

    def __len__(self):
        return len(self.samples)

    def get(self, idx, rng: np.random.RandomState):
        img_path, json_path = self.samples[idx % len(self.samples)]
        img = _read_image(img_path)
        with open(json_path) as f:
            ann = json.load(f)
        mask = polygon_to_mask(ann.get('shapes', []), img.shape[0],
                               img.shape[1])
        sample = {'frames': [img] * self.seq_len,
                  'labels': [mask] * self.seq_len,
                  'obj_num': int(mask.max())}
        return augment(sample, rng, self.cfg, 1.0, 1.3,
                       self.cfg.model.max_obj_num, 0.5)

    def __getitem__(self, idx):
        return self.get(idx, np.random.RandomState(
            np.random.randint(2 ** 31)))


class SyntheticTrainDataset:
    """The reference's TEST dataset (:821-854): zero images, all-ones
    labels — runs the full training loop with no data on disk."""

    def __init__(self, cfg, seq_len=3, obj_num=3, size=None):
        self.cfg = cfg
        self.seq_len = seq_len
        self.obj_num = obj_num
        self.size = size or cfg.data_randomcrop

    def __len__(self):
        return 3000

    def get(self, idx, rng=None):
        h, w = self.size
        return {'frames': np.zeros((self.seq_len, h, w, 3), np.float32),
                'masks': np.ones((self.seq_len, h, w), np.int32),
                'obj_num': self.obj_num}

    def __getitem__(self, idx):
        return self.get(idx)


def build_train_dataset(cfg):
    """Dataset factory (reference dataloaders/__init__.py:16-105, with all
    types wired). Each dataset lives under its own directory of
    cfg.dir_data; several concatenate."""
    root = cfg.dir_data
    datasets = []
    for name in cfg.datasets:
        name = name.lower()
        if name == 'static':
            datasets.append(StaticTrainDataset(
                cfg, os.path.join(root, 'Static'), cfg.data_seq_len))
        elif name in ('davis2017', 'davis'):
            datasets.append(build_davis_train(cfg, os.path.join(root,
                                                                'DAVIS')))
        elif name == 'vost':
            datasets.append(build_vost_train(cfg, os.path.join(root,
                                                               'VOST')))
        elif name == 'visor':
            datasets.append(build_visor_train(cfg, os.path.join(root,
                                                                'VISOR')))
        elif name == 'youtubevos':
            datasets.append(build_youtubevos_train(cfg, os.path.join(root,
                                                                     'YTB')))
        elif name in ('extracted_frames', 'extractedframes'):
            datasets.append(ExtractedFramesTrainDataset(
                cfg, os.path.join(root, 'extracted_frames'),
                cfg.data_seq_len))
        elif name == 'test':
            datasets.append(SyntheticTrainDataset(cfg, cfg.data_seq_len))
        else:
            raise ValueError(f'unknown train dataset {name}')
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(datasets)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.lengths = [len(d) for d in datasets]

    def __len__(self):
        return sum(self.lengths)

    def get(self, idx, rng):
        for d, n in zip(self.datasets, self.lengths):
            if idx < n:
                return d.get(idx, rng)
            idx -= n
        raise IndexError

    def __getitem__(self, idx):
        return self.get(idx, np.random.RandomState(
            np.random.randint(2 ** 31)))


class TrainDataLoader:
    """Shuffling batch loader -> numpy batches {frames [B,T,H,W,3],
    masks [B,T,H,W], obj_nums [B]}.

    Replaces the reference's torch DataLoader + DistributedSampler
    (trainer.py:314-336): each data-parallel rank constructs a loader with
    its (rank, world) and reads a disjoint shard of the epoch's
    permutation. Sample idx of epoch e draws from the seed
    `seed + e * 1000003 + idx`, so a batch does not depend on the thread
    that built it. The samples of a batch are built on `num_workers`
    threads (cv2 releases the interpreter lock); nothing is prefetched.
    """

    def __init__(self, dataset, batch_size, seed=0, rank=0, world=1,
                 num_workers=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.seed = seed
        self.num_workers = num_workers

    def _sample(self, idx_seed):
        idx, seed = idx_seed
        return self.dataset.get(int(idx), np.random.RandomState(seed))

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor
        epoch = 0
        while True:
            rng = np.random.RandomState(self.seed + epoch)
            order = rng.permutation(len(self.dataset))
            order = order[self.rank::self.world]
            n_batches = len(order) // self.batch_size
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                for b in range(n_batches):
                    idxs = order[b * self.batch_size:(b + 1) *
                                 self.batch_size]
                    seeds = [self.seed + epoch * 1000003 + int(i)
                             for i in idxs]
                    samples = list(ex.map(self._sample, zip(idxs, seeds)))
                    yield {
                        'frames': np.stack([s['frames'] for s in samples]),
                        'masks': np.stack([s['masks'] for s in samples]),
                        'obj_nums': np.array([s['obj_num'] for s in samples],
                                             np.int32),
                    }
            epoch += 1
