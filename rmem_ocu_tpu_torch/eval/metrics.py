"""Benchmark metrics: region Jaccard J, boundary F, and statistics.

The port's copy of the JAX package's `eval/metrics.py` (reference
evaluation/source/metrics.py:6-197 and evaluation/source/utils.py:135-160:
pure numpy with the same void-pixel, empty-union and boundary-dilation
conventions; the dilation is cv2's).
"""
from __future__ import annotations

import warnings

import numpy as np


def db_eval_iou(annotation, segmentation, void_pixels=None):
    """Jaccard with void exclusion; empty-union frames score 1
    (reference metrics.py:6-37)."""
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    if void_pixels is None:
        void_pixels = np.zeros_like(segmentation)
    void_pixels = void_pixels.astype(bool)
    inters = np.sum((segmentation & annotation) & ~void_pixels,
                    axis=(-2, -1))
    union = np.sum((segmentation | annotation) & ~void_pixels, axis=(-2, -1))
    with np.errstate(divide='ignore', invalid='ignore'):
        j = inters / union
    if np.ndim(j) == 0:
        return 1.0 if np.isclose(union, 0) else float(j)
    j = np.asarray(j, np.float64)
    j[np.isclose(union, 0)] = 1.0
    return j


def _seg2bmap(seg):
    """1-pixel-wide boundary map (reference metrics.py:120-170).

    Deliberate simplification: the reference additionally rescales the
    boundary map when the requested (width, height) differ from the
    input (metrics.py:155-167). Its only caller passes no size
    (metrics.py:103-104 -> seg2bmap(seg) with width=seg.shape[1],
    height=seg.shape[0]), making the rescale branch a structural no-op,
    so it is not replicated here; at equal dims this map matches the
    reference bit-for-bit."""
    seg = np.asarray(seg, bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = seg ^ e | seg ^ s | seg ^ se
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = 0
    return b


def _disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk replacement."""
    r = int(radius)
    y, x = np.ogrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def f_measure(foreground_mask, gt_mask, void_pixels=None, bound_th=0.008):
    """Boundary F (reference metrics.py:57-117)."""
    import cv2
    if void_pixels is None:
        void_pixels = np.zeros_like(foreground_mask, bool)
    void_pixels = void_pixels.astype(bool)
    bound_pix = bound_th if bound_th >= 1 else int(np.ceil(
        bound_th * np.linalg.norm(foreground_mask.shape)))
    fg_boundary = _seg2bmap(foreground_mask * ~void_pixels)
    gt_boundary = _seg2bmap(gt_mask * ~void_pixels)
    kernel = _disk(bound_pix)
    fg_dil = cv2.dilate(fg_boundary.astype(np.uint8), kernel)
    gt_dil = cv2.dilate(gt_boundary.astype(np.uint8), kernel)
    gt_match = gt_boundary * fg_dil
    fg_match = fg_boundary * gt_dil
    n_fg = np.sum(fg_boundary)
    n_gt = np.sum(gt_boundary)
    if n_fg == 0 and n_gt > 0:
        return 0.0
    if n_fg > 0 and n_gt == 0:
        return 0.0
    if n_fg == 0 and n_gt == 0:
        return 1.0
    precision = np.sum(fg_match) / float(n_fg)
    recall = np.sum(gt_match) / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def db_eval_boundary(annotation, segmentation, void_pixels=None,
                     bound_th=0.008):
    if annotation.ndim == 3:
        return np.array([
            f_measure(segmentation[i], annotation[i],
                      None if void_pixels is None else void_pixels[i],
                      bound_th)
            for i in range(annotation.shape[0])])
    return f_measure(segmentation, annotation, void_pixels, bound_th)


def db_statistics(per_frame_values):
    """(mean, recall>0.5, decay) (reference utils.py:135-160)."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', category=RuntimeWarning)
        m = np.nanmean(per_frame_values)
        o = np.nanmean(per_frame_values > 0.5)
    n_bins = 4
    ids = np.round(np.linspace(1, len(per_frame_values), n_bins + 1)
                   + 1e-10) - 1
    ids = ids.astype(np.int64)
    d_bins = [per_frame_values[ids[i]:ids[i + 1] + 1] for i in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', category=RuntimeWarning)
        d = np.nanmean(d_bins[0]) - np.nanmean(d_bins[3])
    return m, o, d
