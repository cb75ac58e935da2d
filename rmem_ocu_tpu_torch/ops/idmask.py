"""Integer label map -> one-hot id mask for the patch-wise id bank.

Counterpart of the JAX package's `ops/s2d.py:space_to_depth_label` plus
`InferEngine._id_emb_from_label` (engine/infer_engine.py:168-191). The JAX
package folds the one-hot into a space-to-depth block layout because a
17x17/s16 conv on 12 channels maps badly onto the TPU's matrix unit; here
the id bank is a plain strided `nn.Conv2d`, so only the one-hot remains.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def label_to_one_hot(label: torch.Tensor, max_obj_num: int,
                     ignore_token: bool, dtype: torch.dtype) -> torch.Tensor:
    """label: int [B, H, W] (or [B, H, W, 1]) -> one-hot [B, H, W, n_ch].

    Channels 0..max_obj_num are the ids. With ignore_token there is one
    more channel: pixels labelled 255 light only that last channel (the
    reference folds them out of the background, aot_engine.py:208-232).
    Ids >= max_obj_num + 1 (and 255 without ignore_token) get all-zero
    channels, like the reference's one_hot_mask."""
    if label.dim() == 4:
        label = label[..., 0]
    n_ids = max_obj_num + 1
    n_ch = n_ids + (1 if ignore_token else 0)
    raw = label.long()
    lab = torch.where(raw >= n_ids, n_ch, raw)
    if ignore_token:
        lab = torch.where(raw == 255, n_ch - 1, lab)
    return F.one_hot(lab, n_ch + 1)[..., :n_ch].to(dtype)
