"""Streaming evaluator: per-sequence semi-supervised VOS inference.

Counterpart of the JAX package's `eval/evaluator.py` (reference
aot_plus/networks/managers/evaluator.py:30-631). As there:

- sequences are partitioned statically by rank (seq_idx % world),
- more than max_obj_num objects fold into groups on the engine's batch
  axis: one batched pass, not a list of engines (aot_engine.py:675-700),
- each multi-scale / flip augmentation keeps its own engine state, and
  their softmaxes are averaged (evaluator.py:436-441),
- per-frame time is host wall time, ended on the card by
  `torch.cuda.synchronize()`,
- with `oracle` (VOST, the mask-conditioned TopDown encoder), every
  labelled frame's ground truth conditions the encoder and is not
  re-referenced (reference evaluator.py:407-417).
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from rmem_ocu_tpu_torch.config import ExpConfig
from rmem_ocu_tpu_torch.data.eval_datasets import EvalDataset, FrameSample
from rmem_ocu_tpu_torch.engine.infer_engine import EngineState, InferEngine
from rmem_ocu_tpu_torch.models.vos_model import VOSModel
from rmem_ocu_tpu_torch.ops.masks import save_mask_png
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear


def adaptive_mem_gap(num_frames: int, base_gap: int,
                     no_memory_gap: bool = False) -> int:
    """gap = max(round(frames / 30), 5), quartered under NO_MEMORY_GAP
    (reference evaluator.py:328-335)."""
    gap = max(int(round(num_frames / 30.0)), 5)
    if no_memory_gap:
        gap = int(round(gap / 4.0))
    return gap


def sequence_mem_gap(exp, cfg, num_frames: int) -> int:
    """Per-sequence write gap: the reference's adaptive value always wins
    (evaluator.py:356 overwrites the engine's configured gap) unless
    test_fixed_mem_gap pins test_long_term_mem_gap (--gap)."""
    if exp.test_fixed_mem_gap:
        return exp.test_long_term_mem_gap
    return adaptive_mem_gap(num_frames, exp.test_long_term_mem_gap,
                            cfg.no_memory_gap)


def separate_mask_groups(mask: np.ndarray, n_groups: int,
                         group_size: int) -> np.ndarray:
    """Split a label map into per-group masks with ids 1..group_size
    (reference aot_engine.py:604-628). mask [H, W] -> [n_groups, H, W]."""
    out = np.zeros((n_groups,) + mask.shape, mask.dtype)
    for g in range(n_groups):
        start = g * group_size + 1
        end = (g + 1) * group_size
        fg = (mask >= start) & (mask <= end)
        out[g] = np.where(fg, mask - start + 1, 0)
    return out


def soft_aggregate_group_logits(logits: torch.Tensor, obj_num: int,
                                group_size: int) -> torch.Tensor:
    """Merge per-group logits [G, group_size+1, H, W] into one
    [1, G*group_size+1, H, W] map: bg = product of the groups' bg
    probabilities (reference aot_engine.py:650-673)."""
    g = logits.shape[0]
    if g == 1:
        return logits
    prob = torch.softmax(logits.float(), dim=1)
    bg = torch.prod(prob[:, 0], dim=0)[None, None]
    fgs = [prob[i:i + 1, 1:1 + group_size] for i in range(g)]
    merged = torch.cat([bg] + fgs, dim=1).clamp(1e-5, 1 - 1e-5)
    return torch.log(merged) - torch.log1p(-merged)


def min_aggregate_group_logits(logits: torch.Tensor, obj_num: int,
                               group_size: int) -> torch.Tensor:
    """Alternative merge, bg = min over the groups' bg logits (reference
    aot_engine.py:630-648). Same layout as soft_aggregate_group_logits."""
    g = logits.shape[0]
    if g == 1:
        return logits
    bg = torch.amin(logits[:, 0], dim=0)[None, None]
    fgs = [logits[i:i + 1, 1:1 + group_size] for i in range(g)]
    return torch.cat([bg] + fgs, dim=1)


@dataclass
class EvalStats:
    total_time: float = 0.0
    total_frames: int = 0
    seq_fps: List[float] = field(default_factory=list)
    frame_times: List[float] = field(default_factory=list)
    max_mem_mb: float = 0.0

    @property
    def p50_latency_ms(self) -> float:
        if not self.frame_times:
            return 0.0
        return float(np.median(self.frame_times) * 1e3)


@dataclass
class _AugState:
    state: EngineState
    flip: bool
    in_size: tuple
    grid: tuple


class Evaluator:
    """Runs a dataset through the model; saves palette PNG masks under
    result_root. The device is the model's."""

    def __init__(self, model: VOSModel, exp: ExpConfig, result_root: str,
                 rank: int = 0, world: int = 1, frame_log: bool = False,
                 probe: bool = False, write: bool = True):
        self.model = model
        self.exp = exp
        self.cfg = model.cfg
        self.result_root = result_root
        self.rank = rank
        self.world = world
        # the masks are written (False on the ranks of a model group but
        # its first, which serve the same sequences)
        self.write = write
        # per-frame timing prints (reference TEST_FRAME_LOG,
        # evaluator.py:530-536)
        self.frame_log = frame_log
        # per-frame fixed-pixel logit probe (reference DEBUG_FIX_RANDOM,
        # evaluator.py:424-425)
        self.probe = probe
        # one engine for the whole dataset; the per-sequence gap lives in
        # each state (EngineState.mem_gap)
        self.engine = InferEngine(model, exp)
        self.device = self.engine.device
        self.aggregate = (min_aggregate_group_logits
                          if exp.test_aggregation == 'min'
                          else soft_aggregate_group_logits)
        # one PNG-writer pool for the Evaluator's lifetime; each sequence
        # drains its futures, so write failures surface there
        self._io_pool = ThreadPoolExecutor(max_workers=4)

    def evaluate(self, dataset: EvalDataset, verbose: bool = True
                 ) -> EvalStats:
        stats = EvalStats()
        for seq_idx, (seq_name, seq) in enumerate(dataset.items()):
            if seq_idx % self.world != self.rank:
                continue
            t = self._eval_sequence(seq_name, seq, verbose)
            stats.total_time += t[0]
            stats.total_frames += t[1]
            stats.frame_times.extend(t[2])
            if t[1]:
                stats.seq_fps.append(t[1] / max(t[0], 1e-9))
        if self.device.type == 'cuda':
            # the reference reports torch.cuda.max_memory_allocated
            # (evaluator.py:584-586)
            stats.max_mem_mb = (torch.cuda.max_memory_allocated(self.device)
                                / 2.0 ** 20)
        if verbose and stats.total_frames:
            print(f'[rank {self.rank}] all-frame FPS: '
                  f'{stats.total_frames / stats.total_time:.2f}, '
                  f'p50 latency: {stats.p50_latency_ms:.1f}ms, '
                  f'max mem: {stats.max_mem_mb:.0f}MB')
        return stats

    # -------------------------------------------------------------- #
    def _grid(self, in_size):
        if self.cfg.align_corners:
            return ((in_size[0] - 1) // 16 + 1, (in_size[1] - 1) // 16 + 1)
        return (in_size[0] // 16, in_size[1] // 16)

    def _images(self, sample: FrameSample, n_groups: int) -> torch.Tensor:
        img = torch.from_numpy(np.ascontiguousarray(sample.image[None]))
        return img.to(self.device).repeat(n_groups, 1, 1, 1)

    def _groups(self, label: np.ndarray, aug: _AugState,
                n_groups: int) -> torch.Tensor:
        """A label map at the original size -> the aug's per-group masks
        [n_groups, H, W] at its input size."""
        lbl = label[:, ::-1] if aug.flip else label
        groups = separate_mask_groups(self._label_at(lbl, aug.in_size),
                                      n_groups, self.cfg.max_obj_num)
        return torch.from_numpy(groups.astype(np.int64))

    def _oracle_mask(self, label: np.ndarray, aug: _AugState,
                     n_groups: int) -> torch.Tensor:
        """A ground-truth label at the original size -> the aug's encoder
        conditioning [n_groups, H, W, 1] at its input size (the encoder
        ignore-clears and binarises it)."""
        lbl = self._label_at(label[:, ::-1] if aug.flip else label,
                             aug.in_size)
        return torch.from_numpy(lbl[None, ..., None].astype(np.int64)).to(
            self.device).repeat(n_groups, 1, 1, 1)

    def _add_ref_all(self, augs, samples, label_ori, n_groups, obj_nums):
        """(Re-)add a reference label (original resolution) to every aug."""
        for aug, sample in zip(augs, samples):
            aug.state = self.engine.add_reference_frame(
                aug.state, self._images(sample, n_groups),
                self._groups(label_ori, aug, n_groups), obj_nums)

    def _eval_sequence(self, seq_name: str, seq, verbose: bool):
        exp, cfg = self.exp, self.cfg
        gap = sequence_mem_gap(exp, cfg, len(seq))
        engine = self.engine
        group_size = cfg.max_obj_num

        os.makedirs(os.path.join(self.result_root, seq_name), exist_ok=True)

        augs: Optional[List[_AugState]] = None
        n_groups = 1
        total_time, timed_frames = 0.0, 0
        frame_times = []
        # PNG writes overlap the next frame's compute (the reference saves
        # masks on background threads, utils/image.py:103-105); they are
        # submitted outside the timed region and drained before returning
        io_futures = []

        for frame_idx in range(len(seq)):
            samples = seq.frame(frame_idx)
            base: FrameSample = samples[0]
            obj_idx = base.obj_idx
            ori_size = (base.height, base.width)

            if frame_idx == 0:
                assert base.label is not None
                n_groups = max(int(np.ceil(base.obj_num / group_size)), 1)
                # the reference passes obj_nums=[max_aot_obj_num] to every
                # inner engine (aot_engine.py:694-698): ids above the live
                # object count are never masked at eval
                obj_nums = torch.full((n_groups,), group_size)
                augs = []
                for s in samples:
                    in_size = s.image.shape[:2]
                    grid = self._grid(in_size)
                    augs.append(_AugState(
                        state=engine.init_state(n_groups, grid, mem_gap=gap),
                        flip=s.flip, in_size=in_size, grid=grid))
                self._add_ref_all(augs, samples, base.label, n_groups,
                                  obj_nums)
                continue

            # VOST oracle: the ground truth conditions the encoder and is
            # consumed there, not re-referenced (reference
            # evaluator.py:407-417)
            oracle = cfg.oracle and base.label is not None

            t0 = time.perf_counter()
            prob_sum = None
            for aug, sample in zip(augs, samples):
                logits, aug.state = engine.propagate(
                    aug.state, self._images(sample, n_groups),
                    self._oracle_mask(base.label, aug, n_groups) if oracle
                    else None)
                # upsample per-group logits BEFORE the nonlinear group
                # aggregation, like the reference (aot_engine.py:704-712)
                logits = interpolate_bilinear(logits.permute(0, 3, 1, 2),
                                              ori_size, cfg.align_corners)
                logits = self.aggregate(logits, base.obj_num, group_size)
                if self.probe:
                    # first 7 channels at a fixed pixel (reference
                    # DEBUG_FIX_RANDOM, evaluator.py:424-425)
                    py, px = (min(100, ori_size[0] - 1),
                              min(100, ori_size[1] - 1))
                    vals = logits[0, :7, py, px].float().cpu().numpy()
                    print(f'\n [{self.rank}] : {seq_name} {base.name} '
                          f'logits[{py},{px},:7] = {vals}')
                if aug.flip:
                    logits = logits.flip(-1)
                prob = torch.softmax(logits.float(), dim=1)
                del logits
                if prob_sum is None:
                    prob_sum = prob
                else:
                    prob_sum += prob
                del prob
            pred_ori = prob_sum.argmax(dim=1)[0].to(torch.uint8).cpu().numpy()
            del prob_sum

            # mid-video new objects (YouTube-VOS): ground truth wins where
            # labelled, then the merged map is re-added as the reference
            # (reference :484-508); re-adding resets the memory
            if base.label is not None and not oracle:
                new_label = self._label_at(base.label, ori_size)
                pred_ori = np.where(new_label == 0, pred_ori,
                                    new_label).astype(np.uint8)
                n_groups_new = max(int(np.ceil(int(pred_ori.max())
                                               / group_size)), 1)
                if n_groups_new != n_groups:
                    n_groups = n_groups_new
                    for aug in augs:
                        aug.state = engine.init_state(n_groups, aug.grid,
                                                      mem_gap=gap)
                obj_nums = torch.full((n_groups,), group_size)
                self._add_ref_all(augs, samples, pred_ori, n_groups,
                                  obj_nums)
            else:
                for aug in augs:
                    aug.state = engine.update_memory(
                        aug.state, self._groups(pred_ori, aug, n_groups))

            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            frame_time = time.perf_counter() - t0
            total_time += frame_time
            timed_frames += 1
            frame_times.append(frame_time)
            if self.frame_log:
                print(f'[rank {self.rank}] {seq_name} frame '
                      f'{base.name.split(".")[0]} - Obj Num: '
                      f'{base.obj_num}, Time: {int(frame_time * 1e3)}ms')

            if not self.write:
                continue
            out_path = os.path.join(
                self.result_root, seq_name,
                os.path.splitext(base.name)[0] + '.png')
            io_futures.append(self._io_pool.submit(
                save_mask_png, pred_ori, out_path, squeeze_idx=list(obj_idx)))
            # all-frames split: also save the annotated (sparse) subset
            # (reference evaluator.py:548-560)
            sparse = getattr(seq, 'images_sparse', None)
            if sparse is not None and base.name in sparse:
                sp = os.path.join(self.result_root + '_sparse', seq_name)
                os.makedirs(sp, exist_ok=True)
                io_futures.append(self._io_pool.submit(
                    save_mask_png, pred_ori, os.path.join(
                        sp, os.path.splitext(base.name)[0] + '.png'),
                    squeeze_idx=list(obj_idx)))

        for fut in io_futures:
            fut.result()

        if verbose and timed_frames:
            print(f'[rank {self.rank}] {seq_name}: '
                  f'{timed_frames / total_time:.2f} fps '
                  f'({len(seq)} frames, gap {gap})')
        return total_time, timed_frames, frame_times

    @staticmethod
    def _label_at(label: np.ndarray, size):
        """Bit-faithful torch F.interpolate(mode='nearest') on labels
        (reference evaluator.py:498-503): src = floor(dst * float32(in/out))
        -- torch computes the scale in float32, so the exact integer floor
        (dst * in // out) diverges by one row/col at some size ratios
        (e.g. 500 -> 480); cv2.INTER_NEAREST rounds differently still."""
        label = np.ascontiguousarray(label).astype(np.uint8)
        if label.shape[:2] == tuple(size):
            return label
        h, w = label.shape[:2]
        oh, ow = int(size[0]), int(size[1])
        rows = np.floor(np.arange(oh, dtype=np.float32)
                        * (np.float32(h) / np.float32(oh))).astype(np.int64)
        cols = np.floor(np.arange(ow, dtype=np.float32)
                        * (np.float32(w) / np.float32(ow))).astype(np.int64)
        return label[np.minimum(rows, h - 1)][:, np.minimum(cols, w - 1)]
