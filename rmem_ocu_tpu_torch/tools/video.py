"""Render saved VOS results as overlay videos (reference
aot_plus/tools/video.py; counterpart of the JAX package's
`tools/video.py`). Reads the PNG masks an evaluation wrote and composes
them over the source frames. Needs no model and no device.

Example:
    python -m rmem_ocu_tpu_torch.tools.video --image_root frames_root/ \
        --results_path results/.../eval/davis2017 --output vis/
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from rmem_ocu_tpu_torch.tools.demo import overlay_mask


def main():
    p = argparse.ArgumentParser(description='Render result overlays')
    p.add_argument('--image_root', required=True,
                   help='folder of per-sequence frame folders')
    p.add_argument('--results_path', required=True,
                   help='folder of per-sequence mask PNG folders')
    p.add_argument('--output', required=True)
    p.add_argument('--fps', type=int, default=10)
    p.add_argument('--alpha', type=float, default=0.5)
    args = p.parse_args()

    import cv2
    from rmem_ocu_tpu_torch.ops.masks import read_mask_png

    for seq in sorted(os.listdir(args.results_path)):
        seq_masks = os.path.join(args.results_path, seq)
        seq_imgs = os.path.join(args.image_root, seq)
        if not (os.path.isdir(seq_masks) and os.path.isdir(seq_imgs)):
            continue
        os.makedirs(args.output, exist_ok=True)
        writer = None
        for img_name in sorted(os.listdir(seq_imgs)):
            frame = cv2.imread(os.path.join(seq_imgs, img_name))
            mask_path = os.path.join(
                seq_masks, os.path.splitext(img_name)[0] + '.png')
            if not os.path.exists(mask_path):
                continue
            mask = read_mask_png(mask_path)
            if mask.shape[:2] != frame.shape[:2]:
                mask = cv2.resize(mask, (frame.shape[1], frame.shape[0]),
                                  interpolation=cv2.INTER_NEAREST)
            over = overlay_mask(frame[:, :, ::-1], mask,
                                args.alpha)[:, :, ::-1]
            if writer is None:
                writer = cv2.VideoWriter(
                    os.path.join(args.output, f'{seq}.mp4'),
                    cv2.VideoWriter_fourcc(*'mp4v'), args.fps,
                    (over.shape[1], over.shape[0]))
            writer.write(np.ascontiguousarray(over))
        if writer is not None:
            writer.release()
            print(f'wrote {seq}.mp4')


if __name__ == '__main__':
    main()
