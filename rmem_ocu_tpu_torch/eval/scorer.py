"""Benchmark scorer: J / J_last / F over saved PNG masks.

The port's copy of the JAX package's `eval/scorer.py` (reference
evaluation/evaluation_method.py + evaluation/source/
{evaluation,dataset,results}.py). Per-sequence scoring runs in a thread pool
(the reference fans out mp.Process with a Semaphore(8),
evaluation.py:55-115); first and last annotated frames are dropped and
J_last covers the final 25% (:88-102).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from math import floor
from typing import Dict, List, Sequence

import numpy as np

from rmem_ocu_tpu_torch.eval import metrics as M

VOID_LABEL = 255


class GTDataset:
    """Annotated-frames-only GT reader (reference source/dataset.py:8-109)."""

    def __init__(self, root: str, subset: str = 'val',
                 sequences='all'):
        self.root = root
        self.mask_path = os.path.join(root, 'Annotations')
        self.imagesets_path = os.path.join(root, 'ImageSets')
        if sequences == 'all':
            with open(os.path.join(self.imagesets_path,
                                   f'{subset}.txt')) as f:
                sequences = [x.strip() for x in f if x.strip()]
        self.seq_masks: Dict[str, List[str]] = {}
        for seq in sequences:
            masks = sorted(glob(os.path.join(self.mask_path, seq, '*.png')))
            if not masks:
                raise FileNotFoundError(f'no annotations for {seq}')
            self.seq_masks[seq] = masks

    def get_sequences(self):
        return list(self.seq_masks.keys())

    def get_all_masks(self, seq: str, separate_objects: bool = True):
        from PIL import Image
        paths = self.seq_masks[seq]
        first = np.array(Image.open(paths[0]))
        masks = np.zeros((len(paths),) + first.shape, np.uint8)
        ids = []
        for i, p in enumerate(paths):
            masks[i] = np.array(Image.open(p))
            ids.append(os.path.splitext(os.path.basename(p))[0])
        void = masks == VOID_LABEL
        masks = np.where(void, 0, masks)
        if separate_objects:
            num_objects = int(masks[0].max())
            obj_ids = np.arange(1, num_objects + 1)[:, None, None, None]
            masks = masks[None] == obj_ids
        return masks, void, ids


class ResultsReader:
    """PNG results reader (reference source/results.py:7-36)."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir

    def read_masks(self, seq: str, mask_ids: Sequence[str],
                   num_objects: int):
        from PIL import Image
        out = None
        for i, mid in enumerate(mask_ids):
            path = os.path.join(self.root_dir, seq, f'{mid}.png')
            m = np.array(Image.open(path))
            if out is None:
                out = np.zeros((len(mask_ids),) + m.shape, np.uint8)
            out[i] = m
        out = np.where(out == VOID_LABEL, 0, out)
        obj_ids = np.arange(1, num_objects + 1)[:, None, None, None]
        return out[None] == obj_ids


def evaluate_semisupervised(dataset: GTDataset, results_path: str,
                            with_boundary: bool = False,
                            max_workers: int = 8) -> Dict:
    """Returns {'J': {...}, 'J_last': {...}, ('F': {...})} with M/R/D lists
    and per-object means."""
    results = ResultsReader(results_path)
    metric_names = ['J', 'J_last'] + (['F'] if with_boundary else [])
    res = {m: {'M': [], 'R': [], 'D': [], 'M_per_object': {}}
           for m in metric_names}

    def eval_seq(seq):
        gt_masks, void, mask_ids = dataset.get_all_masks(seq, True)
        # drop first and last annotated frames (reference evaluation.py:86)
        gt_masks, mask_ids_t = gt_masks[:, 1:-1], mask_ids[1:-1]
        n = len(mask_ids_t)
        last_q = int(floor(n * 0.75))
        pred = results.read_masks(seq, mask_ids_t, gt_masks.shape[0])
        rows = []
        for ii in range(gt_masks.shape[0]):
            j = M.db_eval_iou(gt_masks[ii], pred[ii], None)
            f = (M.db_eval_boundary(gt_masks[ii], pred[ii], None)
                 if with_boundary else None)
            rows.append((f'{seq}_{ii + 1}', j, f, last_q))
        return rows

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        all_rows = list(ex.map(eval_seq, dataset.get_sequences()))

    for rows in all_rows:
        for name, j, f, last_q in rows:
            jm, jr, jd = M.db_statistics(j)
            res['J']['M'].append(jm)
            res['J']['R'].append(jr)
            res['J']['D'].append(jd)
            res['J']['M_per_object'][name] = jm
            jm, jr, jd = M.db_statistics(j[last_q:])
            res['J_last']['M'].append(jm)
            res['J_last']['R'].append(jr)
            res['J_last']['D'].append(jd)
            res['J_last']['M_per_object'][name] = jm
            if with_boundary:
                fm, fr, fd = M.db_statistics(f)
                res['F']['M'].append(fm)
                res['F']['R'].append(fr)
                res['F']['D'].append(fd)
                res['F']['M_per_object'][name] = fm
    return res


def summarize(res: Dict) -> Dict[str, float]:
    out = {}
    for m, vals in res.items():
        out[f'{m}_mean'] = float(np.mean(vals['M'])) if vals['M'] else float(
            'nan')
    if 'J' in res and 'F' in res:
        out['J&F'] = (out['J_mean'] + out['F_mean']) / 2
    return out


def score_results(results_path: str, dataset_root: str, split: str = 'val',
                  boundary: bool = False) -> str:
    """Score saved masks; write global + per-sequence CSVs next to the
    results (reference evaluation_method.py:36-75 incl. CSV caching).
    Returns the global CSV path."""
    import csv
    import json
    gpath = os.path.join(results_path, f'global_results-{split}.csv')
    ppath = os.path.join(results_path, f'per-sequence_results-{split}.csv')
    if os.path.isfile(gpath) and os.path.isfile(ppath):
        print(f'cached scores found: {gpath} (reference '
              'evaluation_method.py:36-39)')
        return gpath
    ds = GTDataset(dataset_root, split)
    res = evaluate_semisupervised(ds, results_path, with_boundary=boundary)
    summary = summarize(res)
    print(json.dumps(summary, indent=2))
    with open(gpath, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(list(summary.keys()))
        w.writerow([round(v, 6) for v in summary.values()])
    with open(ppath, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['Sequence', 'J-Mean', 'J_last-Mean'])
        for name in res['J']['M_per_object']:
            w.writerow([name, res['J']['M_per_object'][name],
                        res['J_last']['M_per_object'][name]])
    return gpath


def main():
    import argparse
    p = argparse.ArgumentParser(description='Score saved VOS PNG masks '
                                '(J / J_last / F)')
    p.add_argument('--results_path', required=True)
    p.add_argument('--dataset_root', required=True)
    p.add_argument('--split', default='val')
    p.add_argument('--boundary', action='store_true')
    args = p.parse_args()
    score_results(args.results_path, args.dataset_root, args.split,
                  args.boundary)


if __name__ == '__main__':
    main()
