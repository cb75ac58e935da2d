"""Demo: segment a folder of frames given a first-frame mask, render
overlays and an mp4 (reference aot_plus/tools/demo.py). Counterpart of the
JAX package's `tools/demo.py`, plus `--device`.

Example:
    python -m rmem_ocu_tpu_torch.tools.demo --img_dir frames/ \
        --mask first.png --ckpt_path model.pth --output out/
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

_PALETTE_RGB = np.array([
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (191, 0, 0),
    (64, 128, 0)], np.uint8)


def overlay_mask(img: np.ndarray, mask: np.ndarray,
                 alpha: float = 0.5) -> np.ndarray:
    color = _PALETTE_RGB[np.clip(mask, 0, len(_PALETTE_RGB) - 1)]
    out = img.copy()
    fg = mask > 0
    out[fg] = (alpha * img[fg] + (1 - alpha) * color[fg]).astype(np.uint8)
    return out


def main():
    p = argparse.ArgumentParser(description='VOS demo on a frame folder')
    p.add_argument('--img_dir', required=True)
    p.add_argument('--mask', required=True,
                   help='first-frame palette PNG mask')
    p.add_argument('--model', default='r50_deaotl')
    p.add_argument('--stage', default='pre_vost_2')
    p.add_argument('--ckpt_path', default=None)
    p.add_argument('--output', default='./demo_out')
    p.add_argument('--max_size', type=float, default=480 * 1.3)
    p.add_argument('--fps', type=int, default=10)
    p.add_argument('--device', default=None,
                   help="torch device; the card by default, 'cpu' only "
                        'when asked')
    args = p.parse_args()

    import cv2
    from rmem_ocu_tpu_torch.config import get_config
    from rmem_ocu_tpu_torch.data.eval_datasets import VOSSequence
    from rmem_ocu_tpu_torch.eval.evaluator import Evaluator
    from rmem_ocu_tpu_torch.models import build_vos_model
    from rmem_ocu_tpu_torch.ops.masks import read_mask_png
    from rmem_ocu_tpu_torch.utils.checkpoint import load_torch_pretrained

    exp = get_config(args.stage, 'demo', args.model)
    cfg = exp.model
    model = build_vos_model(cfg, device=args.device)
    if args.ckpt_path:
        load_torch_pretrained(args.ckpt_path, model)

    # stage the inputs as a one-sequence dataset
    img_dir = os.path.abspath(args.img_dir)
    seq_name = os.path.basename(img_dir.rstrip('/'))
    image_root = os.path.dirname(img_dir)
    os.makedirs(os.path.join(args.output, '_labels', seq_name),
                exist_ok=True)
    first_img = sorted(os.listdir(img_dir))[0]
    lbl_name = os.path.splitext(first_img)[0] + '.png'
    shutil.copyfile(args.mask,
                    os.path.join(args.output, '_labels', seq_name, lbl_name))

    seq = VOSSequence(image_root, os.path.join(args.output, '_labels'),
                      seq_name, sorted(os.listdir(img_dir)), [lbl_name],
                      max_size=args.max_size,
                      align_corners=cfg.align_corners)

    class _DS:
        def items(self):
            return [(seq_name, seq)]

        def __len__(self):
            return 1

    # pre-copy the frame-0 GT into the results, like the eval dataset
    # wrappers do (reference eval_datasets.py:311-334): the engine never
    # re-predicts the reference frame
    os.makedirs(os.path.join(args.output, 'masks', seq_name), exist_ok=True)
    shutil.copyfile(args.mask, os.path.join(args.output, 'masks', seq_name,
                                            lbl_name))

    ev = Evaluator(model, exp, os.path.join(args.output, 'masks'))
    ev.evaluate(_DS())

    # render overlays and an mp4
    mask_dir = os.path.join(args.output, 'masks', seq_name)
    overlay_dir = os.path.join(args.output, 'overlay', seq_name)
    os.makedirs(overlay_dir, exist_ok=True)
    writer = None
    for img_name in sorted(os.listdir(img_dir)):
        frame = cv2.imread(os.path.join(img_dir, img_name))
        mask_path = os.path.join(
            mask_dir, os.path.splitext(img_name)[0] + '.png')
        if not os.path.exists(mask_path):
            mask = read_mask_png(os.path.join(args.output, '_labels',
                                              seq_name, lbl_name))
        else:
            mask = read_mask_png(mask_path)
        over = overlay_mask(frame[:, :, ::-1], mask)[:, :, ::-1]
        cv2.imwrite(os.path.join(overlay_dir, img_name), over)
        if writer is None:
            writer = cv2.VideoWriter(
                os.path.join(args.output, f'{seq_name}.mp4'),
                cv2.VideoWriter_fourcc(*'mp4v'), args.fps,
                (over.shape[1], over.shape[0]))
        writer.write(over)
    if writer is not None:
        writer.release()
    print(f'demo written to {args.output}')


if __name__ == '__main__':
    main()
