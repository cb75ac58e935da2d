"""Stage a labelme extracted-frames directory into train + eval splits.

The reference's notebook fine-tune workflow trains on labelme-annotated
frames of one target video (reference train_datasets.py:870-1043,
ExtractedFramesTrain) and then runs inference on that same video. This tool
makes that workflow end-to-end reproducible here:

- train split -> `<out>/train/extracted_frames/` (jpg+json pairs consumed
  by ExtractedFramesTrainDataset via `--datasets extracted_frames`);
- a held-out contiguous tail -> `<out>/eval/` in the VOST layout
  (JPEGImages_10fps/<seq>/, Annotations/<seq>/, ImageSets/val.txt) consumed
  by `tools/eval.py --dataset vost` and scored by `eval/scorer.py`.

Object ids in the eval GT are assigned by label NAME in order of first
appearance — the raw labelme shape order is inconsistent across frames
(('peeling','Peeled') vs ('Peeled','peeling') both occur in the reference
data), which would silently swap object identities mid-video if rasterized
by polygon order the way training samples are (reference
train_datasets.py:857-867 — fine there because each training clip repeats a
single frame, so the ids are self-consistent within a clip).

The port's copy of the JAX package's `tools/prepare_extracted.py`.

Example:
    python -m rmem_ocu_tpu_torch.tools.prepare_extracted \
        --src ./extracted_frames --out ./peel_data --eval_frames 200
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil

import numpy as np

from rmem_ocu_tpu_torch.ops.masks import save_mask_png

FRAME_RE = re.compile(r'frame_(\d+)\.json$')


def _collect(src: str):
    """(frame_number, img_path, json_path) sorted by frame number."""
    out = []
    for fn in os.listdir(src):
        m = FRAME_RE.match(fn)
        if not m:
            continue
        stem = os.path.splitext(fn)[0]
        for ext in ('.jpg', '.png', '.jpeg'):
            img = os.path.join(src, stem + ext)
            if os.path.exists(img):
                out.append((int(m.group(1)), img, os.path.join(src, fn)))
                break
    out.sort()
    return out


def _rasterize(json_path: str, label_ids: dict) -> np.ndarray:
    """labelme polygons -> id mask with NAME-stable ids (see module doc)."""
    import cv2
    with open(json_path) as f:
        ann = json.load(f)
    h, w = ann['imageHeight'], ann['imageWidth']
    mask = np.zeros((h, w), np.uint8)
    for shape in ann.get('shapes', []):
        label = shape['label']
        if label not in label_ids:
            label_ids[label] = len(label_ids) + 1
        pts = np.array(shape['points'], np.int32)
        cv2.fillPoly(mask, [pts], color=int(label_ids[label]))
    return mask


def _link_or_copy(src: str, dst: str, symlink: bool):
    if os.path.lexists(dst):
        os.remove(dst)
    if symlink:
        os.symlink(os.path.abspath(src), dst)
    else:
        shutil.copyfile(src, dst)


def prepare(src: str, out: str, eval_frames: int = 200,
            seq_name: str = 'peel', symlink: bool = True):
    frames = _collect(src)
    if len(frames) <= eval_frames:
        raise SystemExit(f'only {len(frames)} annotated frames in {src}; '
                         f'need more than --eval_frames {eval_frames}')
    train, evl = frames[:-eval_frames], frames[-eval_frames:]

    train_dir = os.path.join(out, 'train', 'extracted_frames')
    img_dir = os.path.join(out, 'eval', 'JPEGImages_10fps', seq_name)
    ann_dir = os.path.join(out, 'eval', 'Annotations', seq_name)
    sets_dir = os.path.join(out, 'eval', 'ImageSets')
    for d in (train_dir, img_dir, ann_dir, sets_dir):
        os.makedirs(d, exist_ok=True)

    for _, img, js in train:
        _link_or_copy(img, os.path.join(
            train_dir, os.path.basename(img)), symlink)
        _link_or_copy(js, os.path.join(
            train_dir, os.path.basename(js)), symlink)

    label_ids: dict = {}
    for num, img, js in evl:
        stem = f'{num:06d}'
        _link_or_copy(img, os.path.join(
            img_dir, stem + os.path.splitext(img)[1]), symlink)
        save_mask_png(_rasterize(js, label_ids),
                      os.path.join(ann_dir, stem + '.png'))

    with open(os.path.join(sets_dir, 'val.txt'), 'w') as f:
        f.write(seq_name + '\n')

    print(json.dumps({
        'train_frames': len(train), 'eval_frames': len(evl),
        'eval_range': [evl[0][0], evl[-1][0]],
        'labels': label_ids,
        'train_root': os.path.join(out, 'train'),
        'eval_root': os.path.join(out, 'eval'),
    }))


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--src', required=True,
                   help='labelme dir of frame_<N>.jpg + frame_<N>.json')
    p.add_argument('--out', required=True)
    p.add_argument('--eval_frames', type=int, default=200,
                   help='hold out the last N frames as the eval sequence')
    p.add_argument('--seq_name', type=str, default='peel')
    p.add_argument('--copy', action='store_true',
                   help='copy files instead of symlinking')
    args = p.parse_args()
    prepare(args.src, args.out, args.eval_frames, args.seq_name,
            symlink=not args.copy)
