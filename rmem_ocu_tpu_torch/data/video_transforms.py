"""Train-time video clip transforms (host-side numpy/cv2).

The port's copy of the JAX package's `data/video_transforms.py`: the same
draws from the same `np.random.RandomState` in the same order, so a seeded
sample is identical in both packages. Reference:
aot_plus/dataloaders/video_transforms.py — RandomScale (:238-288),
BalancedRandomCrop (:118-235), RandomHorizontalFlip (:447-469), Resize with
random padding (:9-115), ToTensor normalization (:520-556).
A sample is {frames: [T][H,W,3] float32 RGB 0-255, labels: [T][H,W] uint8,
obj_num: int}; frame 0 is the reference frame.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from rmem_ocu_tpu_torch.data.eval_datasets import IMAGENET_MEAN, IMAGENET_STD


def random_scale(sample: Dict, rng: np.random.RandomState,
                 min_scale=0.7, max_scale=1.3, short_edge=480) -> Dict:
    import cv2
    sc = rng.uniform(min_scale, max_scale)
    h, w = sample['frames'][0].shape[:2]
    sc *= float(short_edge) / min(h, w)
    sample['frames'] = [
        cv2.resize(f, None, fx=sc, fy=sc, interpolation=cv2.INTER_CUBIC)
        for f in sample['frames']]
    sample['labels'] = [
        cv2.resize(l, None, fx=sc, fy=sc, interpolation=cv2.INTER_NEAREST)
        for l in sample['labels']]
    return sample


def balanced_random_crop(sample: Dict, rng: np.random.RandomState,
                         output_size: Tuple[int, int], max_step=10,
                         max_obj_num=10, min_obj_pixel_num=100) -> Dict:
    """Retry crops until the reference frame keeps at least one object;
    relabels kept object ids densely (reference :140-235)."""
    labels = sample['labels']
    h, w = labels[0].shape[:2]
    new_h = min(output_size[0], h)
    new_w = min(output_size[1], w)

    top = left = 0
    all_obj = [0]
    for _ in range(max_step):
        top = rng.randint(0, h - new_h + 1)
        left = rng.randint(0, w - new_w + 1)
        ref_crop = labels[0][top:top + new_h, left:left + new_w]
        fg = [o for o in np.sort(np.unique(ref_crop)) if o not in (0, 255)]
        kept = [o for o in fg
                if np.sum(ref_crop == o) > min_obj_pixel_num]
        if not kept:
            continue
        if len(kept) > max_obj_num:
            rng.shuffle(kept)
            kept = kept[:max_obj_num]
        all_obj = [0] + sorted(kept)
        break

    relabeled = []
    for elem in (l[top:top + new_h, left:left + new_w] for l in labels):
        new_elem = np.zeros_like(elem)
        for idx, obj_id in enumerate(all_obj[1:], start=1):
            new_elem[elem == obj_id] = idx
        new_elem[elem == 255] = 255
        relabeled.append(new_elem)

    sample['labels'] = relabeled
    sample['frames'] = [f[top:top + new_h, left:left + new_w]
                        for f in sample['frames']]
    sample['obj_num'] = len(all_obj) - 1
    return sample


def random_horizontal_flip(sample: Dict, rng: np.random.RandomState,
                           prob=0.5) -> Dict:
    if rng.rand() < prob:
        sample['frames'] = [f[:, ::-1].copy() for f in sample['frames']]
        sample['labels'] = [l[:, ::-1].copy() for l in sample['labels']]
    return sample


def resize_with_padding(sample: Dict, rng: np.random.RandomState,
                        output_size: Tuple[int, int]) -> Dict:
    """Random-position constant padding to the crop size
    (reference :65-115); mean-ish fill for images, 0 for labels."""
    import cv2
    h, w = sample['frames'][0].shape[:2]
    oh, ow = output_size
    if (h, w) == (oh, ow):
        return sample
    pad_h, pad_w = max(oh - h, 0), max(ow - w, 0)
    top = rng.randint(0, pad_h + 1)
    left = rng.randint(0, pad_w + 1)
    bottom, right = pad_h - top, pad_w - left
    sample['frames'] = [
        cv2.copyMakeBorder(f, top, bottom, left, right, cv2.BORDER_CONSTANT,
                           value=(124, 116, 104))
        for f in sample['frames']]
    sample['labels'] = [
        cv2.copyMakeBorder(l, top, bottom, left, right, cv2.BORDER_CONSTANT,
                           value=0)
        for l in sample['labels']]
    return sample


def normalize_stack(sample: Dict) -> Dict:
    """-> frames [T,H,W,3] float32 normalized, masks [T,H,W] int32."""
    frames = np.stack([((f / 255.0) - IMAGENET_MEAN) / IMAGENET_STD
                       for f in sample['frames']]).astype(np.float32)
    masks = np.stack(sample['labels']).astype(np.int32)
    return {'frames': frames, 'masks': masks,
            'obj_num': int(sample['obj_num'])}


def augment(sample: Dict, rng: np.random.RandomState, cfg, min_scale,
            max_scale, max_obj_num, flip_prob) -> Dict:
    """Scale, balanced crop, flip and pad to the crop size, then normalise:
    the order every training dataset applies them in."""
    sample = random_scale(sample, rng, min_scale, max_scale,
                          cfg.data_short_edge_len)
    sample = balanced_random_crop(sample, rng, cfg.data_randomcrop,
                                  cfg.data_max_crop_steps, max_obj_num)
    sample = random_horizontal_flip(sample, rng, flip_prob)
    sample = resize_with_padding(sample, rng, cfg.data_randomcrop)
    return normalize_stack(sample)


def train_transform(sample: Dict, rng: np.random.RandomState, cfg) -> Dict:
    """The reference's composed training pipeline
    (managers/trainer.py:290-302)."""
    return augment(sample, rng, cfg, cfg.data_min_scale_factor,
                   cfg.data_max_scale_factor, cfg.model.max_obj_num,
                   cfg.data_randomflip)
