"""Train-time IoU (reference aot_plus/utils/metric.py:4-36, pytorch_iou)."""
from __future__ import annotations

import torch

from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.parallel.dist import World


def batched_iou(pred: torch.Tensor, target: torch.Tensor,
                obj_nums: torch.Tensor, max_obj: int,
                epsilon: float = 1e-6, world: World = World()
                ) -> torch.Tensor:
    """pred / target: int [B, H, W]; obj_nums: [B]. Per sample the mean
    IoU over ids 1..obj_num, then the mean over samples with objects; 1.0
    when no sample has one. Returns a scalar f32. Under spatial sharding
    pred and target are a band of rows, and the intersections and unions
    are summed over the model group `world`."""
    ids = torch.arange(1, max_obj + 1, device=pred.device)
    p = pred[:, None] == ids[None, :, None, None]            # [B, O, H, W]
    t = target[:, None] == ids[None, :, None, None]
    inter = (p & t).sum(dim=(2, 3)).float()
    union = (p | t).sum(dim=(2, 3)).float()
    dist.all_reduce_([inter, union], world)
    iou = (inter + epsilon) / (union + epsilon)
    valid = ids[None] <= obj_nums[:, None]
    per_item = (torch.where(valid, iou, 0.0).sum(dim=1)
                / valid.sum(dim=1).clamp_min(1))
    has_obj = obj_nums > 0
    n = has_obj.sum()
    mean = torch.where(has_obj, per_item, 0.0).sum() / n.clamp_min(1)
    return torch.where(n > 0, mean, 1.0)
