"""AOT / DeAOT model facade.

Counterpart of the JAX package's `models/vos_model.py` (reference
aot_plus/networks/models/aot.py and deaot.py); one module covers both
families. The engine drives it through its methods (encode_image,
get_id_emb, get_pos_emb, lstt_forward, decode_id_logits,
fuse_memory_values, compress_evicted_slots) and keeps every piece of memory
state outside it. Submodule names follow the reference so that its state_dict keys load
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
from rmem_ocu_tpu_torch.models.lstt import LSTTStack
from rmem_ocu_tpu_torch.ops.layers import EPS, tokens_from_2d
from rmem_ocu_tpu_torch.ops.position import sine_position_embedding
from rmem_ocu_tpu_torch.utils.device import resolve_device


_INT_TYPES = (torch.uint8, torch.int8, torch.int16, torch.int32,
              torch.int64)


class VOSModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.vos not in ('aot', 'deaot'):
            raise ValueError(f'unknown model family {cfg.vos!r}')
        self.cfg = cfg
        self.is_deaot = cfg.vos == 'deaot'
        d = cfg.encoder_embedding_dim
        self.encoder = build_encoder(cfg.encoder, use_mask=cfg.use_mask)
        self.encoder_projector = nn.Conv2d(cfg.encoder_dim[-1], d, 1)
        if self.is_deaot:
            self.LSTT = GPMStack(num_layers=cfg.lstt_num, d_model=d,
                                 self_heads=cfg.self_heads,
                                 att_heads=cfg.att_heads)
        else:
            self.LSTT = LSTTStack(
                num_layers=cfg.lstt_num, d_model=d,
                self_heads=cfg.self_heads, att_heads=cfg.att_heads,
                linear_q=cfg.linear_q, gru_memory=cfg.gru_memory,
                intermediate_norm=cfg.decoder_intermediate_lstt)
        # a GPM layer puts out [tgt, tgt_id], an LSTT layer tgt
        d_out = 2 * d if self.is_deaot else d
        self.decoder = FPNSegmentationHead(
            in_dim=(d + cfg.lstt_num * d_out if cfg.decoder_intermediate_lstt
                    else d_out),
            out_dim=cfg.max_obj_num + 1, shortcut_dims=cfg.encoder_dim,
            hidden_dim=d,
            decode_intermediate_input=cfg.decoder_intermediate_lstt,
            align_corners=cfg.align_corners)
        # patch-wise identity bank (reference aot.py:64-83): a strided conv
        # of the one-hot id mask down to the 16x grid
        k = 17 if cfg.align_corners else 16
        self.patch_wise_id_bank = nn.Conv2d(
            cfg.id_dim, d, k, stride=16, padding=8 if cfg.align_corners else 0)
        if self.is_deaot:
            self.id_norm = nn.LayerNorm(d, eps=EPS)
        if cfg.use_temporal_pe:
            pe_dim = d // 2 if self.is_deaot else d
            slots = 4 if cfg.temporal_pe_slot_4 else 2
            self.cur_pos_emb = nn.Parameter(torch.zeros(1, pe_dim))
            self.mem_pos_emb = nn.Parameter(torch.zeros(slots, pe_dim))

    def encode_image(self, img: torch.Tensor,
                     mask: Optional[torch.Tensor] = None
                     ) -> List[torch.Tensor]:
        """img: [B, H, W, 3] -> encoder maps [4x, 8x, 16x, 16x] as NCHW,
        the last one projected to the embedding width.

        mask conditions the mask-conditioned TopDown encoder (cfg.use_mask;
        reference aot.py:115-129); other models ignore it. An int label map
        [B, H, W, 1] is ignore-cleared (255 -> 0) and binarised; float
        probabilities [B, H, W, O+1] become 1 - P(background). Anything
        else raises."""
        x = img.permute(0, 3, 1, 2)
        if self.cfg.use_mask and mask is not None:
            if mask.shape[-1] == 1 and mask.dtype in _INT_TYPES:
                m = (torch.where(mask == 255, 0, mask) > 0).to(img.dtype)
            elif mask.shape[-1] > 1 and mask.is_floating_point():
                m = 1.0 - mask[..., 0:1].to(img.dtype)
            else:
                raise ValueError(
                    f'use_mask conditioning expects an int label '
                    f'[B,H,W,1] or float probabilities [B,H,W,O+1]; got '
                    f'{mask.dtype} {tuple(mask.shape)} (reference '
                    f'aot.py:115-124)')
            xs = self.encoder(x, m.permute(0, 3, 1, 2))
        else:
            xs = self.encoder(x)
        xs[-1] = self.encoder_projector(xs[-1])
        return xs

    def get_id_emb(self, one_hot: torch.Tensor) -> torch.Tensor:
        """one_hot: [B, H, W, id_dim] -> id tokens [B, HW/256, d]."""
        x = tokens_from_2d(self.patch_wise_id_bank(
            one_hot.permute(0, 3, 1, 2)))
        return self.id_norm(x) if self.is_deaot else x

    def get_pos_emb(self, size_2d: Tuple[int, int]) -> torch.Tensor:
        """Sine position embedding [1, HW, d]: the LSTT's self-attention
        position (the GPM uses none)."""
        d = self.cfg.encoder_embedding_dim
        pe = sine_position_embedding(size_2d[0], size_2d[1], d // 2)
        return pe.reshape(1, size_2d[0] * size_2d[1], d)

    def temporal_pe(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if not self.cfg.use_temporal_pe:
            return None
        return self.cur_pos_emb, self.mem_pos_emb

    def lstt_forward(self, curr_emb_16x, long_mem, short_mem, curr_id_emb,
                     self_pos, size_2d, temporal_pe=None,
                     need_mass: bool = False):
        """curr_emb_16x: [B, C, h, w]; see LSTTStack.forward and
        GPMStack.forward (which takes no self_pos)."""
        tgt = tokens_from_2d(curr_emb_16x)
        if self.is_deaot:
            return self.LSTT(tgt, long_mem, short_mem, curr_id_emb, size_2d,
                             temporal_pe, need_mass=need_mass)
        return self.LSTT(tgt, long_mem, short_mem, curr_id_emb, self_pos,
                         size_2d, temporal_pe, need_mass=need_mass)

    def decode_id_logits(self, lstt_outputs: List[torch.Tensor],
                         shortcuts: List[torch.Tensor]) -> torch.Tensor:
        """Decode the LSTT / GPM outputs ([B, HW, C] per layer); returns
        logits [B, H4, W4, O+1]."""
        b, _, h, w = shortcuts[-1].shape
        inputs = [shortcuts[-1]] + [
            x.transpose(1, 2).reshape(b, -1, h, w) for x in lstt_outputs]
        return self.decoder(inputs, shortcuts).permute(0, 2, 3, 1)

    def fuse_memory_values(self, memories: List[dict], id_emb: torch.Tensor
                           ) -> List[dict]:
        """Apply the per-layer value-fusion projections to the pending
        memories of the last propagation, per layer a dict ready for the
        bank append and the short-term push.

        AOT (reference transformer.py:276-299): long V =
        linear_V(curr_v + id), short V = linear_VMem(local_v + id).
        DeAOT (reference transformer.py:833-848): ID_V =
        fuse_value_id(curr_id_v, id), shared by both memories; layer 0 has
        no curr_id_v (None)."""
        fused = []
        for block, mems in zip(self.LSTT.layers, memories):
            if self.is_deaot:
                id_v = block.fuse_value_id(mems['curr_id_v'], id_emb)
                fused.append(dict(long_k=mems['curr_k'],
                                  long_v=mems['curr_v'], long_id_v=id_v,
                                  short_k=mems['curr_k'],
                                  short_v=mems['curr_v'], short_id_v=id_v))
            else:
                fused.append(dict(
                    long_k=mems['curr_k'],
                    long_v=block.fuse_curr_value(mems['curr_v'], id_emb),
                    long_id_v=None, short_k=mems['local_k'],
                    short_v=block.fuse_local_value(mems['local_v'], id_emb),
                    short_id_v=None))
        return fused

    def compress_evicted_slots(self, k_slots, v_slots, hidden_k, hidden_v,
                               size_2d):
        """ConvGRU-compress evicted (K, V) slots per layer (AOT
        gru_memory). Returns ((out_k, out_v), (hidden_k, hidden_v)), each a
        per-layer list of [B, HW, C]."""
        outs_k, outs_v, hks, hvs = [], [], [], []
        for idx, block in enumerate(self.LSTT.layers):
            (ok, ov), (hk, hv) = block.compress_evicted(
                k_slots[idx], v_slots[idx], hidden_k[idx], hidden_v[idx],
                size_2d)
            outs_k.append(ok)
            outs_v.append(ov)
            hks.append(hk)
            hvs.append(hv)
        return (outs_k, outs_v), (hks, hvs)


@torch.no_grad()
def init_weights(model: VOSModel, generator: torch.Generator) -> None:
    """Random init from an explicit generator, following the JAX package's
    initializers: lecun-normal convs, transposed convs and linears with
    zero biases, the orthogonal id bank with gain k^-2 (reference
    aot.py:170-177), truncated-normal temporal PE (std 0.05, cut at 2 std)
    and Swin relative-position biases (std 0.02), and the TopDown
    encoder's normal prompt and identity transform."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # the fan-in flax takes from the kernel's shape
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        if hasattr(mod, 'relative_position_bias_table'):
            nn.init.trunc_normal_(mod.relative_position_bias_table, std=0.02,
                                  a=-0.04, b=0.04, generator=generator)
        if hasattr(mod, 'top_down_transform'):
            mod.prompt.normal_(generator=generator)
            nn.init.eye_(mod.top_down_transform)
    w = model.patch_wise_id_bank.weight
    nn.init.orthogonal_(w.view(w.shape[0], -1), gain=w.shape[-1] ** -2.0,
                        generator=generator)
    if model.cfg.use_temporal_pe:
        for p in (model.cur_pos_emb, model.mem_pos_emb):
            nn.init.trunc_normal_(p, std=0.05, a=-0.1, b=0.1,
                                  generator=generator)


def build_vos_model(cfg: ModelConfig, device=None, seed: int = 0
                    ) -> VOSModel:
    """The eval-mode AOT / DeAOT model with random weights from `seed`, on
    `device` (CUDA unless the caller passes 'cpu'). Load trained weights
    with `model.load_state_dict`."""
    device = resolve_device(device)
    model = VOSModel(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
