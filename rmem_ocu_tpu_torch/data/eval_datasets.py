"""Per-sequence evaluation datasets (host-side numpy pipeline).

The port's copy of the JAX package's `data/eval_datasets.py` (reference
aot_plus/dataloaders/eval_datasets.py: VOSTest :14-118 plus the dataset
wrappers, YouTube-VOS :121, VOST :274, DAVIS :347, Long-Videos :426,
EVAL_TEST :497). Images load via cv2 (BGR->RGB), labels via PIL palette
PNGs; sizing follows MultiRestrictSize (video_transforms.py:559-657): long
edge <= max_size, snapped to the stride-16(+1) grid, optional flip and
multi-scale duplicates. A sequence reads its files through `_raw_image`
and `_raw_label`, which a subclass may replace.
"""
from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _read_image(path: str, rgb: bool = True) -> np.ndarray:
    import cv2
    img = cv2.imread(path)
    img = np.asarray(img, np.float32)
    if rgb:
        img = img[:, :, ::-1]
    return img


def _read_label(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path), np.uint8)


def restrict_size(h: int, w: int, max_size: float, align_corners: bool,
                  scale: float = 1.0, min_size: Optional[int] = None,
                  max_stride: int = 16) -> Tuple[int, int]:
    """Target (H, W) per MultiRestrictSize (video_transforms.py:574-620)."""
    sc = None
    if min_size is not None:
        short = min(h, w)
        if short > min_size:
            sc = float(min_size) / short
    else:
        long = max(h, w)
        if long > max_size:
            sc = float(max_size) / long
    nh, nw = (h, w) if sc is None else (sc * h, sc * w)
    nh, nw = int(nh * scale), int(nw * scale)
    if align_corners:
        if (nh - 1) % max_stride != 0:
            nh = int(np.around((nh - 1) / max_stride) * max_stride + 1)
        if (nw - 1) % max_stride != 0:
            nw = int(np.around((nw - 1) / max_stride) * max_stride + 1)
    else:
        if nh % max_stride != 0:
            nh = int(np.around(nh / max_stride) * max_stride)
        if nw % max_stride != 0:
            nw = int(np.around(nw / max_stride) * max_stride)
    return nh, nw


def normalize_image(img: np.ndarray) -> np.ndarray:
    return ((img / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


@dataclass
class FrameSample:
    image: np.ndarray                  # [H, W, 3] normalized, resized
    label: Optional[np.ndarray]        # [Ho, Wo] uint8 at ORIGINAL size
    name: str
    height: int                        # original size
    width: int
    obj_num: int
    obj_idx: List[int]
    flip: bool = False
    scale: float = 1.0


class VOSSequence:
    """One video sequence: yields per-frame FrameSample lists (one entry per
    scale/flip augmentation). Mirrors VOSTest (eval_datasets.py:14-118)."""

    def __init__(self, image_root, label_root, seq_name, images, labels,
                 rgb=True, single_obj=False, resolution=None,
                 max_size=800 * 1.3, align_corners=True,
                 multi_scale=(1.0,), flip=False, min_size=None):
        self.image_root = image_root
        self.label_root = label_root
        self.seq_name = seq_name
        self.images = list(images)
        self.labels = set(labels)
        self.rgb = rgb
        self.single_obj = single_obj
        self.resolution = resolution
        self.max_size = max_size
        self.min_size = min_size
        self.align_corners = align_corners
        self.multi_scale = tuple(multi_scale)
        self.flip = flip

        # cumulative object tables (reference :37-52)
        self.obj_nums, self.obj_indices = [], []
        curr_objs = [0]
        for img_name in self.images:
            self.obj_nums.append(len(curr_objs) - 1)
            lbl = os.path.splitext(img_name)[0] + '.png'
            if lbl in self.labels:
                label = self._label(lbl)
                for obj in np.unique(label):
                    if obj not in curr_objs:
                        curr_objs.append(int(obj))
            self.obj_indices.append(curr_objs.copy())
        if len(self.obj_nums) > 1:
            self.obj_nums[0] = self.obj_nums[1]

    def __len__(self):
        return len(self.images)

    def _raw_image(self, img_name: str) -> np.ndarray:
        """Frame `img_name` as float32 [H, W, 3] at its stored size."""
        return _read_image(os.path.join(self.image_root, self.seq_name,
                                        img_name), self.rgb)

    def _raw_label(self, label_name: str) -> np.ndarray:
        """Label map `label_name` as uint8 [H, W]."""
        return _read_label(os.path.join(self.label_root, self.seq_name,
                                        label_name))

    def _label(self, label_name, squeeze_idx=None):
        label = self._raw_label(label_name)
        if self.single_obj:
            label = (label > 0).astype(np.uint8)
        elif squeeze_idx is not None:
            squeezed = np.zeros_like(label)
            for idx, obj_id in enumerate(squeeze_idx):
                if obj_id == 0:
                    continue
                squeezed[label == obj_id] = idx
            label = squeezed
        return label

    def frame(self, idx: int) -> List[FrameSample]:
        img_name = self.images[idx]
        img = self._raw_image(img_name)
        h, w = img.shape[:2]
        if self.resolution is not None:
            w = int(np.ceil(float(w) * self.resolution / float(h)))
            h = int(self.resolution)

        lbl_name = os.path.splitext(img_name)[0] + '.png'
        label = (self._label(lbl_name, self.obj_indices[idx])
                 if lbl_name in self.labels else None)

        samples = []
        import cv2
        for scale in self.multi_scale:
            nh, nw = restrict_size(img.shape[0], img.shape[1], self.max_size,
                                   self.align_corners, scale, self.min_size)
            im = (img if (nh, nw) == img.shape[:2] else
                  cv2.resize(img, dsize=(nw, nh),
                             interpolation=cv2.INTER_CUBIC))
            base = FrameSample(
                image=normalize_image(im), label=label, name=img_name,
                height=h, width=w, obj_num=self.obj_nums[idx],
                obj_idx=self.obj_indices[idx], flip=False, scale=scale)
            samples.append(base)
            if self.flip:
                samples.append(FrameSample(
                    image=base.image[:, ::-1].copy(),
                    label=None if label is None else label[:, ::-1].copy(),
                    name=img_name, height=h, width=w,
                    obj_num=self.obj_nums[idx],
                    obj_idx=self.obj_indices[idx], flip=True, scale=scale))
        return samples


def _seq_from_dir(image_root, label_root, seq_name,
                  first_label_only=True, all_labels=False, **kw):
    """DAVIS/VOST/LongVideos protocol uses ONLY the frame-0 annotation as a
    reference (reference eval_datasets.py:309, :387) even though the
    Annotations dir carries GT for every frame; feeding later GT would be
    oracle leakage. `all_labels` is the VOST oracle mode
    (eval_datasets.py:306-307)."""
    images = sorted(os.listdir(os.path.join(image_root, seq_name)))
    if all_labels:
        labels = [os.path.splitext(i)[0] + '.png' for i in images]
    elif first_label_only:
        labels = [os.path.splitext(images[0])[0] + '.png']
    else:
        labels = sorted(os.listdir(os.path.join(label_root, seq_name)))
    return VOSSequence(image_root, label_root, seq_name, images, labels,
                       **kw)


class EvalDataset:
    """Iterable of (seq_name, VOSSequence). Copies frame-0 GT into the
    result dir like the reference wrappers (eval_datasets.py:311-334)."""

    def __init__(self, sequences: Dict[str, VOSSequence],
                 result_root: Optional[str] = None):
        self.sequences = sequences
        self.result_root = result_root
        if result_root:
            for name, seq in sequences.items():
                os.makedirs(os.path.join(result_root, name), exist_ok=True)
                if seq.labels:
                    first = sorted(seq.labels)[0]
                    src = os.path.join(seq.label_root, name, first)
                    dst = os.path.join(result_root, name, first)
                    if os.path.exists(src) and not os.path.exists(dst):
                        shutil.copyfile(src, dst)

    def __len__(self):
        return len(self.sequences)

    def items(self):
        return self.sequences.items()


def build_davis_dataset(root: str, split='val', year=2017, full_res=False,
                        result_root=None, **seq_kw) -> EvalDataset:
    """Reference: eval_datasets.py:347-423 (DAVIS_Test)."""
    res = 'Full-Resolution' if full_res else '480p'
    image_root = os.path.join(root, 'JPEGImages', res)
    label_root = os.path.join(root, 'Annotations', res)
    split_file = os.path.join(root, 'ImageSets', str(year),
                              f'{split}.txt')
    with open(split_file) as f:
        seq_names = [s.strip() for s in f if s.strip()]
    single = year == 2016
    seqs = {name: _seq_from_dir(image_root, label_root, name,
                                single_obj=single, **seq_kw)
            for name in seq_names}
    return EvalDataset(seqs, result_root)


def build_vost_dataset(root: str, split='val', use_10fps=True,
                       oracle=False, result_root=None,
                       **seq_kw) -> EvalDataset:
    """Reference: eval_datasets.py:274-344 (VOST_Test, JPEGImages_10fps).
    oracle=True loads full-fps frames with a GT label for EVERY frame
    (:288, :306-307), consumed by the mask-conditioned encoder path."""
    image_root = os.path.join(root,
                              'JPEGImages' if oracle or not use_10fps
                              else 'JPEGImages_10fps')
    label_root = os.path.join(root, 'Annotations')
    split_file = os.path.join(root, 'ImageSets', f'{split}.txt')
    with open(split_file) as f:
        seq_names = [s.strip() for s in f if s.strip()]
    seqs = {name: _seq_from_dir(image_root, label_root, name,
                                all_labels=oracle, **seq_kw)
            for name in seq_names}
    return EvalDataset(seqs, result_root)


def build_youtubevos_dataset(root: str, year=2019, split='val',
                             all_frames=False, result_root=None,
                             **seq_kw) -> EvalDataset:
    """Reference: eval_datasets.py:121-271 (meta.json-driven;
    YOUTUBEVOS_DenseTest :190-261 for the all-frames split: evaluate every
    frame between the first and last annotated ones, and remember the
    sparse annotated subset for separate saving)."""
    base = os.path.join(root, f'{year}', 'valid' if split == 'val' else split)
    sparse_base = base
    if all_frames:
        base = base + '_all_frames'
    image_root = os.path.join(base, 'JPEGImages')
    label_root = os.path.join(sparse_base, 'Annotations')
    with open(os.path.join(sparse_base, 'meta.json')) as f:
        meta = json.load(f)['videos']
    seqs = {}
    for name in sorted(meta.keys()):
        images = sorted(os.listdir(os.path.join(image_root, name)))
        labels = sorted(os.listdir(os.path.join(label_root, name)))
        if all_frames:
            sparse = []
            for obj in meta[name]['objects'].values():
                sparse += [x + '.jpg' for x in obj['frames']]
            sparse = sorted(set(sparse))
            start, end = sparse[0], sparse[-1]
            images = [i for i in images if start <= i <= end]
        seq = VOSSequence(image_root, label_root, name, images, labels,
                          **seq_kw)
        if all_frames:
            seq.images_sparse = set(sparse)
        seqs[name] = seq
    return EvalDataset(seqs, result_root)


def build_long_videos_dataset(root: str, result_root=None,
                              **seq_kw) -> EvalDataset:
    """Reference: eval_datasets.py:426-494 (LONG_VIDEOS_Test)."""
    image_root = os.path.join(root, 'JPEGImages')
    label_root = os.path.join(root, 'Annotations')
    seq_names = sorted(os.listdir(image_root))
    seqs = {name: _seq_from_dir(image_root, label_root, name, **seq_kw)
            for name in seq_names}
    return EvalDataset(seqs, result_root)


class SyntheticSequence(VOSSequence):
    """EVAL_TEST-style synthetic sequence (eval_datasets.py:457-509):
    random frames + a one-object first-frame label, no disk access."""

    def __init__(self, seq_name='test', num_frames=10, size=(129, 129),
                 obj_num=2, seed=0, **kw):
        self.seq_name = seq_name
        self.images = [f'{i:05d}.jpg' for i in range(num_frames)]
        self.labels = {'00000.png'}
        self.rgb = True
        self.single_obj = False
        self.resolution = None
        self.max_size = kw.get('max_size', 800 * 1.3)
        self.min_size = None
        self.align_corners = kw.get('align_corners', True)
        self.multi_scale = kw.get('multi_scale', (1.0,))
        self.flip = kw.get('flip', False)
        self._size = size
        self._rng = np.random.RandomState(seed)
        self._obj = obj_num
        self.obj_nums = [obj_num] * num_frames
        self.obj_indices = [list(range(obj_num + 1))] * num_frames

    def frame(self, idx):
        h, w = self._size
        img = self._rng.rand(h, w, 3).astype(np.float32) * 255
        label = None
        if idx == 0:
            label = (self._rng.rand(h, w) * (self._obj + 1)).astype(np.uint8)
        samples = [FrameSample(
            image=normalize_image(img), label=label,
            name=self.images[idx], height=h, width=w,
            obj_num=self._obj, obj_idx=self.obj_indices[idx])]
        return samples


def build_synthetic_dataset(num_seqs=2, **kw) -> EvalDataset:
    seqs = {f'test_{i}': SyntheticSequence(f'test_{i}', seed=i, **kw)
            for i in range(num_seqs)}
    return EvalDataset(seqs, None)
