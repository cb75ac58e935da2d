"""DeAOT model facade.

Counterpart of the JAX package's `models/vos_model.py` (reference
aot_plus/networks/models/deaot.py). The engine drives it through its
methods (encode_image, get_id_emb, lstt_forward, decode_id_logits,
fuse_memory_values) and keeps every piece of memory state outside it.
Submodule names follow the reference so that its state_dict keys load
unchanged (see utils/convert.py).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from rmem_ocu_tpu_torch.config import ModelConfig
from rmem_ocu_tpu_torch.models.decoders.fpn import FPNSegmentationHead
from rmem_ocu_tpu_torch.models.encoders import build_encoder
from rmem_ocu_tpu_torch.models.gpm import GPMStack
from rmem_ocu_tpu_torch.ops.layers import EPS, tokens_from_2d
from rmem_ocu_tpu_torch.ops.position import sine_position_embedding
from rmem_ocu_tpu_torch.utils.device import resolve_device


class VOSModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.vos != 'deaot':
            raise NotImplementedError('only the DeAOT family is ported yet')
        self.cfg = cfg
        d = cfg.encoder_embedding_dim
        self.encoder = build_encoder(cfg.encoder)
        self.encoder_projector = nn.Conv2d(cfg.encoder_dim[-1], d, 1)
        self.LSTT = GPMStack(num_layers=cfg.lstt_num, d_model=d,
                             self_heads=cfg.self_heads,
                             att_heads=cfg.att_heads)
        self.decoder = FPNSegmentationHead(
            in_dim=2 * d, out_dim=cfg.max_obj_num + 1,
            shortcut_dims=cfg.encoder_dim, hidden_dim=d,
            align_corners=cfg.align_corners)
        # patch-wise identity bank (reference aot.py:64-83): a strided conv
        # of the one-hot id mask down to the 16x grid
        k = 17 if cfg.align_corners else 16
        self.patch_wise_id_bank = nn.Conv2d(
            cfg.id_dim, d, k, stride=16, padding=8 if cfg.align_corners else 0)
        self.id_norm = nn.LayerNorm(d, eps=EPS)
        if cfg.use_temporal_pe:
            slots = 4 if cfg.temporal_pe_slot_4 else 2
            self.cur_pos_emb = nn.Parameter(torch.zeros(1, d // 2))
            self.mem_pos_emb = nn.Parameter(torch.zeros(slots, d // 2))

    def encode_image(self, img: torch.Tensor) -> List[torch.Tensor]:
        """img: [B, H, W, 3] -> encoder maps [4x, 8x, 16x, 16x] as NCHW,
        the last one projected to the embedding width."""
        xs = self.encoder(img.permute(0, 3, 1, 2))
        xs[-1] = self.encoder_projector(xs[-1])
        return xs

    def get_id_emb(self, one_hot: torch.Tensor) -> torch.Tensor:
        """one_hot: [B, H, W, id_dim] -> id tokens [B, HW/256, d]."""
        x = self.patch_wise_id_bank(one_hot.permute(0, 3, 1, 2))
        return self.id_norm(tokens_from_2d(x))

    def get_pos_emb(self, size_2d: Tuple[int, int]) -> torch.Tensor:
        """Sine position embedding [1, HW, d] (the GPM itself uses none)."""
        d = self.cfg.encoder_embedding_dim
        pe = sine_position_embedding(size_2d[0], size_2d[1], d // 2)
        return pe.reshape(1, size_2d[0] * size_2d[1], d)

    def temporal_pe(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.cfg.use_temporal_pe:
            return None
        return self.cur_pos_emb, self.mem_pos_emb

    def lstt_forward(self, curr_emb_16x, long_mem, short_mem, curr_id_emb,
                     size_2d, temporal_pe=None, need_mass: bool = False):
        """curr_emb_16x: [B, C, h, w]; see GPMStack.forward."""
        return self.LSTT(tokens_from_2d(curr_emb_16x), long_mem, short_mem,
                         curr_id_emb, size_2d, temporal_pe,
                         need_mass=need_mass)

    def decode_id_logits(self, lstt_outputs: List[torch.Tensor],
                         shortcuts: List[torch.Tensor]) -> torch.Tensor:
        """Decode the last GPM output; returns logits [B, H4, W4, O+1]."""
        b, _, h, w = shortcuts[-1].shape
        x = lstt_outputs[-1].transpose(1, 2).reshape(b, -1, h, w)
        return self.decoder(x, shortcuts).permute(0, 2, 3, 1)

    def fuse_memory_values(self, curr_id_vs: List[Optional[torch.Tensor]],
                           id_emb: torch.Tensor) -> List[torch.Tensor]:
        """Per-layer ID_V = fuse_value_id(curr_id_v, id_emb) for the pending
        memories of the last propagation (reference transformer.py:833-848);
        layer 0 has no curr_id_v (None)."""
        return [block.fuse_value_id(id_v, id_emb)
                for block, id_v in zip(self.LSTT.layers, curr_id_vs)]


@torch.no_grad()
def init_weights(model: VOSModel, generator: torch.Generator) -> None:
    """Random init from an explicit generator, following the JAX package's
    initializers: lecun-normal convs and linears with zero biases, the
    orthogonal id bank with gain k^-2 (reference aot.py:170-177) and
    truncated-normal temporal PE (std 0.05, cut at 2 std)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
    w = model.patch_wise_id_bank.weight
    nn.init.orthogonal_(w.view(w.shape[0], -1), gain=w.shape[-1] ** -2.0,
                        generator=generator)
    if model.cfg.use_temporal_pe:
        for p in (model.cur_pos_emb, model.mem_pos_emb):
            nn.init.trunc_normal_(p, std=0.05, a=-0.1, b=0.1,
                                  generator=generator)


def build_vos_model(cfg: ModelConfig, device=None, seed: int = 0
                    ) -> VOSModel:
    """The eval-mode DeAOT model with random weights from `seed`, on
    `device` (CUDA unless the caller passes 'cpu'). Load trained weights
    with `model.load_state_dict`."""
    device = resolve_device(device)
    model = VOSModel(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
