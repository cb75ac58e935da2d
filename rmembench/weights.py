"""Seeded random weights, made on the device in a few large draws.

The rules follow the measured package's own initialisation: lecun-normal
convolutions and linears (fan-in from the kernel's shape) with zero
biases, unit norms, identity frozen batch norms, an orthogonal id bank
with gain k^-2, truncated-normal temporal PE (std 0.05) and Swin relative
biases (std 0.02), both cut at two standard deviations. Only the names and
shapes of the state_dict are taken from the program; the values are drawn
here, from the seed, in three calls on the device: one normal draw for
every lecun-normal tensor, one uniform draw for every truncated normal
(through the inverse normal CDF) and one normal draw for the id bank's
orthogonal matrix.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BN_EPS = 1e-5
TRUNC_STD = {'relative_position_bias_table': 0.02, 'cur_pos_emb': 0.05,
             'mem_pos_emb': 0.05}
ID_BANK = 'patch_wise_id_bank.weight'


def _trunc_std(key: str):
    for name, std in TRUNC_STD.items():
        if key.endswith(name):
            return std
    return None


def seeded_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                   device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{key: tensor of `dtype` on `device`} for every key of `shapes`."""
    g = torch.Generator(device=device).manual_seed(seed)
    dev = torch.device(device)
    lecun, trunc = [], []
    out = {}
    for key, shape in shapes.items():
        if key == ID_BANK:
            continue
        if _trunc_std(key) is not None:
            trunc.append(key)
        elif len(shape) >= 2:
            lecun.append(key)
        elif key.endswith('running_var'):
            out[key] = torch.full(shape, 1.0 - BN_EPS, device=dev)
        elif key.endswith('weight'):
            out[key] = torch.ones(shape, device=dev)
        else:
            out[key] = torch.zeros(shape, device=dev)
    numel = lambda k: math.prod(shapes[k])
    flat = torch.randn(sum(map(numel, lecun)), generator=g, device=dev)
    at = 0
    for key in lecun:
        n = numel(key)
        fan_in = n // shapes[key][0]
        out[key] = flat[at:at + n].view(shapes[key]) * fan_in ** -0.5
        at += n
    # truncated normal on [-2 std, 2 std] by the inverse CDF
    u = torch.rand(sum(map(numel, trunc)), generator=g, device=dev,
                   dtype=torch.float64)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
    at = 0
    for key in trunc:
        n = numel(key)
        out[key] = (z[at:at + n].view(shapes[key]) * _trunc_std(key)).float()
        at += n
    if ID_BANK in shapes:
        shape = shapes[ID_BANK]
        rows, cols = shape[0], math.prod(shape[1:])
        a = torch.randn((max(rows, cols), min(rows, cols)), generator=g,
                        device=dev)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None]
        if rows < cols:
            q = q.t()
        out[ID_BANK] = q.reshape(shape) * shape[-1] ** -2.0
    return {k: out[k].to(dtype) for k in shapes}
