"""AOT / DeAOT model facade.

Counterpart of the JAX package's `models/vos_model.py` (reference
aot_plus/networks/models/aot.py and deaot.py); one module covers both
families. The engine drives it through its methods (encode_image,
get_id_emb, get_pos_emb, lstt_forward, decode_id_logits,
fuse_memory_values, compress_evicted_slots) and keeps every piece of memory
state outside it; `forward(method, ...)` calls one of them by name, which
lets `torch.func.functional_call` run any of them on other parameters (the
training engine's bf16 copies). Submodule names follow the reference so
that its state_dict keys load unchanged (see utils/convert.py).

The train-time rates (drop-path, the embedding, id, long- and short-term
dropouts) come from the experiment config (`build_vos_model(..., exp=)`)
and act only in training mode.

`parallel.tp.shard_model(model, world.model)` cuts the model into a
rank's shard of a model group (`model.tp`, `model.tp_layout`): the
transformer's projections split, everything else whole on every rank.

Under spatial sharding (`parallel.spatial.banded`, entered by the training
engine) the encoder, the id bank and the decoder run on the rank's band of
rows. The 16x map and the id tokens become whole tokens for the
transformer through a gather whose backward only slices (the transformer's
entry sums the ranks' parts of their gradient, so it is alike on every
rank), and the decoder takes its band of the transformer's outputs, whose
backward gathers the ranks' gradients.
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
from rmem_ocu_tpu_torch.ops.layers import (EPS, DropPath, dropout,
                                           tokens_from_2d)
from rmem_ocu_tpu_torch.ops.position import sine_position_embedding
from rmem_ocu_tpu_torch.parallel import spatial
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.utils.device import resolve_device


_INT_TYPES = (torch.uint8, torch.int8, torch.int16, torch.int32,
              torch.int64)


class VOSModel(nn.Module):
    def __init__(self, cfg: ModelConfig, droppath: float = 0.1,
                 droppath_scaling: bool = False, emb_dropout: float = 0.0,
                 id_dropout: float = 0.0, lt_dropout: float = 0.0,
                 st_dropout: float = 0.0, droppath_lst: bool = False):
        super().__init__()
        if cfg.vos not in ('aot', 'deaot'):
            raise ValueError(f'unknown model family {cfg.vos!r}')
        self.cfg = cfg
        self.is_deaot = cfg.vos == 'deaot'
        self.id_dropout = id_dropout
        # the model group this model is a shard of (parallel/tp.py)
        self.tp = World()
        self.tp_layout = {}
        d = cfg.encoder_embedding_dim
        self.encoder = build_encoder(cfg.encoder, use_mask=cfg.use_mask,
                                     frozen_bn=cfg.freeze_bn)
        self.encoder_projector = nn.Conv2d(cfg.encoder_dim[-1], d, 1)
        rates = dict(emb_dropout=emb_dropout, droppath=droppath,
                     droppath_scaling=droppath_scaling)
        if self.is_deaot:
            self.LSTT = GPMStack(num_layers=cfg.lstt_num, d_model=d,
                                 self_heads=cfg.self_heads,
                                 att_heads=cfg.att_heads,
                                 lt_dropout=lt_dropout, st_dropout=st_dropout,
                                 droppath_lst=droppath_lst, **rates)
        else:
            self.LSTT = LSTTStack(
                num_layers=cfg.lstt_num, d_model=d,
                self_heads=cfg.self_heads, att_heads=cfg.att_heads,
                linear_q=cfg.linear_q, gru_memory=cfg.gru_memory,
                intermediate_norm=cfg.decoder_intermediate_lstt, **rates)
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
        self.patch_wise_id_bank = spatial.Conv2d(
            cfg.id_dim, d, k, stride=16, padding=8 if cfg.align_corners else 0)
        if self.is_deaot:
            self.id_norm = nn.LayerNorm(d, eps=EPS)
        if cfg.use_temporal_pe:
            pe_dim = d // 2 if self.is_deaot else d
            slots = 4 if cfg.temporal_pe_slot_4 else 2
            self.cur_pos_emb = nn.Parameter(torch.zeros(1, pe_dim))
            self.mem_pos_emb = nn.Parameter(torch.zeros(slots, pe_dim))

    def memory_dims(self) -> Tuple[int, int, bool]:
        """(key width, value width, the bank holds ID_V) of this rank's
        memory: AOT's keys and values split by heads over the model group,
        DeAOT's keys whole and its values by channel."""
        cfg = self.cfg
        d, m = cfg.encoder_embedding_dim, self.tp.size
        if not self.is_deaot:
            return d // m, d // m, False
        d_att = d // 2 if cfg.att_heads == 1 else d // cfg.att_heads
        return d_att * cfg.att_heads, 2 * d // m, True

    def forward(self, method: str, *args, **kwargs):
        """Call the method named `method` (one of the engine's entry points
        above); the module's forward, so that functional_call can run it on
        other parameters."""
        return getattr(self, method)(*args, **kwargs)

    def encode_image(self, img: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     var_loss: bool = False):
        """img: [B, H, W, 3] -> encoder maps [4x, 8x, 16x, 16x] as NCHW,
        the last one projected to the embedding width.

        mask conditions the mask-conditioned TopDown encoder (cfg.use_mask;
        reference aot.py:115-129); other models ignore it. An int label map
        [B, H, W, 1] is ignore-cleared (255 -> 0) and binarised; float
        probabilities [B, H, W, O+1] become 1 - P(background). Anything
        else raises. With `var_loss` (TopDown only) returns (maps, the
        encoder's reconstruction loss)."""
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
            m = m.permute(0, 3, 1, 2)
        else:
            m = None
        kw = dict(var_loss=True) if var_loss else {}
        xs = (self.encoder(x, m, **kw) if m is not None or var_loss
              else self.encoder(x))
        loss = None
        if var_loss:
            xs, loss = xs
        xs[-1] = self.encoder_projector(xs[-1])
        return (xs, loss) if var_loss else xs

    def get_id_emb(self, one_hot: torch.Tensor) -> torch.Tensor:
        """one_hot: [B, H, W, id_dim] -> id tokens [B, HW/256, d], dropped
        at id_dropout in training (reference aot.py:84, 113). On a band of
        rows under spatial sharding, whole tokens alike on every rank."""
        x = tokens_from_2d(_whole_rows(self.patch_wise_id_bank(
            one_hot.permute(0, 3, 1, 2))))
        x = self.id_norm(x) if self.is_deaot else x
        return dropout(x, self.id_dropout, self.training)

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
        """curr_emb_16x: [B, C, h, w] (a band of its rows under spatial
        sharding); see LSTTStack.forward and GPMStack.forward (which takes
        no self_pos)."""
        tgt = tokens_from_2d(_whole_rows(curr_emb_16x))
        if self.is_deaot:
            return self.LSTT(tgt, long_mem, short_mem, curr_id_emb, size_2d,
                             temporal_pe, need_mass=need_mass)
        return self.LSTT(tgt, long_mem, short_mem, curr_id_emb, self_pos,
                         size_2d, temporal_pe, need_mass=need_mass)

    def decode_id_logits(self, lstt_outputs: List[torch.Tensor],
                         shortcuts: List[torch.Tensor]) -> torch.Tensor:
        """Decode the LSTT / GPM outputs ([B, HW, C] per layer); returns
        logits [B, H4, W4, O+1]. Under spatial sharding the shortcuts and
        the logits are bands of rows and the outputs whole."""
        b, _, h, w = shortcuts[-1].shape
        bands = spatial.current()
        if bands is None:
            to_2d = lambda x: x.transpose(1, 2).reshape(b, -1, h, w)
        else:
            h = bands.whole_rows(spatial.GRID_STRIDE)
            to_2d = lambda x: spatial.scatter_rows(
                x.transpose(1, 2).reshape(b, -1, h, w), bands)
        inputs = [shortcuts[-1]] + [to_2d(x) for x in lstt_outputs]
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


def _whole_rows(x: torch.Tensor) -> torch.Tensor:
    """x, or under spatial sharding the whole map of which x is a band."""
    bands = spatial.current()
    return x if bands is None else spatial.gather_rows(x, bands)


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


def zero_dropout(model: VOSModel) -> VOSModel:
    """Set every train-time rate of the model to 0 (dropouts, drop-path,
    the gated attentions' channel dropout), so that a training-mode pass is
    deterministic; for checks against another implementation."""
    model.id_dropout = 0.0
    for mod in model.modules():
        if isinstance(mod, DropPath):
            mod.rate = 0.0
        elif hasattr(mod, 'dropout') and isinstance(mod.dropout, float):
            mod.dropout = 0.0
        for name in ('emb_dropout', 'lst_dropout'):
            if hasattr(mod, name):
                setattr(mod, name, 0.0)
    return model


def build_vos_model(cfg: ModelConfig, device=None, seed: int = 0,
                    exp=None) -> VOSModel:
    """The eval-mode AOT / DeAOT model with random weights from `seed`, on
    `device` (CUDA unless the caller passes 'cpu'). `exp` (ExpConfig)
    supplies the train-time rates (train_lstt_droppath and its scaling, the
    embedding, id, long- and short-term dropouts, droppath_lst); without it
    the reference defaults apply. Load trained weights with
    `model.load_state_dict`."""
    device = resolve_device(device)
    if exp is None:
        model = VOSModel(cfg)
    else:
        model = VOSModel(
            cfg, droppath=exp.train_lstt_droppath,
            droppath_scaling=exp.train_lstt_droppath_scaling,
            emb_dropout=exp.train_lstt_emb_dropout,
            id_dropout=exp.train_lstt_id_dropout,
            lt_dropout=exp.train_lstt_lt_dropout,
            st_dropout=exp.train_lstt_st_dropout,
            droppath_lst=exp.train_lstt_droppath_lst)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
