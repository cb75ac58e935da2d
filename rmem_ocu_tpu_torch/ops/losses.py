"""Training losses: top-k hard-mining cross-entropy and soft Jaccard.

Counterpart of the JAX package's `ops/losses.py` (reference
aot_plus/networks/layers/loss.py:118-194). Unused-id logits arrive masked
to -1e10 (the engine's `_mask_unused`), so the softmax over all ids equals
the reference's per-sample slicing, and the reductions are batched.

Under spatial sharding (`bands`, parallel/spatial.py) the logits and
labels are a band of rows, and each loss is the whole image's: the top-k
threshold comes from the group's gathered, detached pixel losses, and the
band's sums are summed over the group. The loss is then alike on every
rank, so these sums take an identity backward (`reduce_from_model`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.layers import reduce_from_model
from rmem_ocu_tpu_torch.parallel.spatial import Bands


def _topk_sum(x: torch.Tensor, k: int, bands: Optional[Bands] = None
              ) -> torch.Tensor:
    """Sum of the k largest entries of each row of x [B, P] (non-negative
    f32), k in [1, P]. Returns [B].

    As in the JAX package, the exact k-th largest value t of each row is
    found first (without gradient; one sort in place of its radix
    bisection: torch's CUDA kthvalue runs one block per row, tens of ms on
    a few rows of 216k pixels), then the sum is sum(x[x > t]) + (k - m)
    / n_ties * sum(x[x == t]) with m entries above t and n_ties at it: the
    value of the sorted top-k sum, with the gradient 1 above t and split
    fairly among the ties at t. (`torch.topk` under autograd would hand the tied
    share to arbitrary entries.) abs() clears the sign of -0.0, the loss
    of a pixel classified perfectly; the comparisons are IEEE (-0.0 ==
    0.0). With `bands`, x [B, h * W] is a band of rows: t, m and n_ties
    come from the whole, the sums from the band, summed over the group."""
    with torch.no_grad():
        xs = x.detach()
        whole = xs if bands is None else spatial.gather_rows(
            xs.reshape(xs.shape[0], -1, bands.size[1]), bands).flatten(1)
        t = whole.abs().sort(dim=1, descending=True).values[:, k - 1:k]
        m = (whole > t).sum(dim=1).float()
        n_ties = (whole == t).sum(dim=1).float().clamp_min(1.0)
        frac = (k - m) / n_ties
    sums = torch.stack([torch.where(xs > t, x, 0.0).sum(dim=1),
                        torch.where(xs == t, x, 0.0).sum(dim=1)])
    if bands is not None:
        sums = reduce_from_model(sums, bands.world)
    return sums[0] + frac * sums[1]


def hard_mining_k(num_pixels: int, step, total_hard_mining_steps: float,
                  top_k_percent: float = 0.15) -> int:
    """Pixels the top-k cross entropy keeps at `step`: all of them at step
    0, falling linearly to top_k_percent of them at
    total_hard_mining_steps (reference loss.py:176-187). f32 arithmetic
    truncated to an integer, as the JAX package's astype(int32)."""
    f32 = torch.float32
    ratio = torch.clamp(torch.tensor(float(step), dtype=f32)
                        / torch.tensor(total_hard_mining_steps + 1e-5,
                                       dtype=f32), max=1.0)
    k = ((ratio * torch.tensor(top_k_percent, dtype=f32) + (1.0 - ratio))
         * num_pixels)
    return int(k)


def topk_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, step,
                       total_hard_mining_steps: float,
                       top_k_percent: float = 0.15,
                       bands: Optional[Bands] = None) -> torch.Tensor:
    """logits: [B, H, W, C]; labels: int [B, H, W] (255 = ignore). The
    mean of the k largest pixel losses (hard_mining_k); ignored pixels
    lose 0 and still take top-k places, as torch CE with
    ignore_index=255. Returns the per-sample loss [B]. With `bands`, a
    band of rows, and the loss of the whole image."""
    b, h, w, c = logits.shape
    num_pixels = h * w
    logits = logits.reshape(b, num_pixels, c).float()
    labels = labels.reshape(b, num_pixels)
    valid = labels != 255
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    one_hot = (safe[..., None] == torch.arange(c, device=logits.device)
               ).to(logp.dtype)
    nll = -(logp * one_hot).sum(dim=-1)
    pixel_losses = torch.where(valid, nll, 0.0)
    if bands is not None:
        num_pixels = bands.size[0] * bands.size[1]
    k = hard_mining_k(num_pixels, step, total_hard_mining_steps,
                      top_k_percent)
    return _topk_sum(pixel_losses, k, bands) / max(k, 1)


def soft_jaccard_loss(logits: torch.Tensor, labels: torch.Tensor,
                      obj_nums=None, bands: Optional[Bands] = None
                      ) -> torch.Tensor:
    """Soft Jaccard (Tversky alpha = beta = 1) averaged over the classes
    present in each sample's labels (and, given obj_nums [B], c <=
    obj_num). logits: [B, H, W, C]; labels: int [B, H, W]. Returns [B].
    With `bands`, a band of rows, and the loss of the whole image."""
    b, h, w, c = logits.shape
    probs = torch.softmax(logits.float(), dim=-1).reshape(b, h * w, c)
    labels = labels.reshape(b, h * w)
    valid = (labels != 255)[..., None].float()
    cls = torch.arange(c, device=logits.device)
    fg = (labels[..., None] == cls).float() * valid          # [B, P, C]
    p = probs * valid
    sums = torch.stack([(p * fg).sum(dim=1), p.sum(dim=1),
                        fg.sum(dim=1)])                      # [3, B, C]
    if bands is not None:
        sums = reduce_from_model(sums, bands.world)
    inter, p_sum, fg_sum = sums
    denom = p_sum + fg_sum - inter
    per_class = 1.0 - inter / (denom + 1e-6)
    present = fg_sum > 0
    if obj_nums is not None:
        present = present & (cls[None] <= obj_nums[:, None])
    present = present.float()
    return (per_class * present).sum(dim=-1) / present.sum(dim=-1).clamp_min(
        1.0)


def segmentation_loss(logits, labels, step, cfg_total_steps,
                      hard_mining_ratio: float = 0.5,
                      top_k_percent: float = 0.15, obj_nums=None,
                      bands: Optional[Bands] = None):
    """0.5 * top-k CE + 0.5 * soft Jaccard (reference
    engines/aot_engine.py:130-146). Returns the per-sample loss [B]; with
    `bands`, of the whole image from a band of rows."""
    ce = topk_cross_entropy(logits, labels, step,
                            hard_mining_ratio * cfg_total_steps,
                            top_k_percent, bands)
    return 0.5 * ce + 0.5 * soft_jaccard_loss(logits, labels, obj_nums,
                                              bands)
