"""Per-video streaming inference engine (AOT and DeAOT).

Counterpart of the JAX package's `engine/infer_engine.py` (reference
aot_plus/networks/engines/aot_engine.py). The per-video state is an
`EngineState` dataclass of tensors; streams ride the batch axis. The
public loop mirrors the JAX one, without the params argument (the model
owns its weights):

    state = engine.init_state(batch, grid)
    state = engine.add_reference_frame(state, img, mask, obj_nums)
    logits, state = engine.propagate(state, img)
    pred = engine.predict_mask(logits, (H, W))
    state = engine.update_memory(state, pred)

Each call updates `state` IN PLACE (bank slot writes, new per-frame
tensors) and returns it. Under torch.profiler each call and its parts
are spans (`utils/tracing.py`, which lists them), and bank writes and
evictions are counted.

A model cut into a rank's shard of a model group (parallel/tp.py
`shard_model`) runs unchanged, every rank of the group calling the same
methods on the same inputs: the bank holds the rank's shard, and where
the heads split (AOT) the engine averages the eviction mass over the
group, so that every rank scores and evicts alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from rmem_ocu_tpu_torch.config import ExpConfig
from rmem_ocu_tpu_torch.memory import bank as membank
from rmem_ocu_tpu_torch.models.vos_model import VOSModel
from rmem_ocu_tpu_torch.ops.idmask import label_to_one_hot
from rmem_ocu_tpu_torch.ops.position import interpolated_memory_pe
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
from rmem_ocu_tpu_torch.parallel import dist
from rmem_ocu_tpu_torch.utils import tracing
from rmem_ocu_tpu_torch.utils.precision import compute_dtype_of

UNUSED_ID_LOGIT = -1e10


@dataclass
class EngineState:
    bank: membank.MemoryBank
    short: membank.ShortTermMemory
    # per-layer memories captured at the last propagation, [B, HW, C] each.
    # DeAOT writes the same K/V to both memories; AOT's short-term pair is
    # its own (local_k, local_v)
    pending_long_k: List[torch.Tensor]
    pending_long_v: List[torch.Tensor]
    pending_short_k: List[torch.Tensor]
    pending_short_v: List[torch.Tensor]
    # DeAOT curr_id_v, layer 0 holds zeros (unused); None for AOT
    pending_id_v: Optional[List[torch.Tensor]]
    pending_mass: torch.Tensor            # [B, HW, T_cap] eviction mass
    pred_logits_4x: torch.Tensor          # [B, H4, W4, O+1]
    frame_step: int
    last_mem_step: int
    mem_gap: int                          # long-term write interval
    obj_nums: torch.Tensor                # [B]
    # ConvGRU hidden states (AOT gru_memory), else None
    gru_hidden_k: Optional[List[torch.Tensor]] = None
    gru_hidden_v: Optional[List[torch.Tensor]] = None


def _mask_unused_ids(logits: torch.Tensor, obj_nums: torch.Tensor
                     ) -> torch.Tensor:
    """Logits of ids > obj_num become -1e10 (reference
    aot_engine.py:450-453). logits: [B, H, W, C]."""
    c = logits.shape[-1]
    keep = torch.arange(c, device=logits.device)[None] <= obj_nums[:, None]
    return torch.where(keep[:, None, None, :], logits, UNUSED_ID_LOGIT)


class InferEngine:
    """Binds a model and its experiment config to the streaming loop. The
    device is the model's."""

    def __init__(self, model: VOSModel, exp_cfg: ExpConfig,
                 long_term_mem_gap: Optional[int] = None,
                 short_term_mem_skip: Optional[int] = None):
        self.model = model
        self.cfg = model.cfg
        self.exp = exp_cfg
        self.gap = (long_term_mem_gap if long_term_mem_gap is not None
                    else exp_cfg.test_long_term_mem_gap)
        self.skip = (short_term_mem_skip if short_term_mem_skip is not None
                     else exp_cfg.test_short_term_mem_skip)
        self.dtype = compute_dtype_of(exp_cfg)
        self.device = next(model.parameters()).device
        self.is_deaot = self.cfg.vos == 'deaot'
        self._self_pos = {}

    def _self_pos_emb(self, size_2d, dtype):
        """The LSTT's sine position embedding on the device, made once per
        grid size (AOT only; the GPM uses none)."""
        if self.is_deaot:
            return None
        key = (size_2d, dtype)
        if key not in self._self_pos:
            self._self_pos[key] = self.model.get_pos_emb(size_2d).to(
                self.device, dtype)
        return self._self_pos[key]

    def init_state(self, batch: int, size_2d: Tuple[int, int],
                   mem_gap: Optional[int] = None) -> EngineState:
        """Empty state for `batch` streams on the encoder grid size_2d,
        writing the long-term bank every `mem_gap` frames (the engine's
        gap by default; the evaluator sets it per sequence)."""
        cfg = self.cfg
        hw = size_2d[0] * size_2d[1]
        ck, cv, with_id = self.model.memory_dims()
        d = cfg.encoder_embedding_dim
        n_layers, cap = cfg.lstt_num, cfg.mem_bank_capacity
        gru = cfg.gru_memory and not self.is_deaot
        dev, dt = self.device, self.dtype

        def zeros(c):
            return [torch.zeros((batch, hw, c), dtype=dt, device=dev)
                    for _ in range(n_layers)]
        h4 = 4 * size_2d[0] - 3 if cfg.align_corners else 4 * size_2d[0]
        w4 = 4 * size_2d[1] - 3 if cfg.align_corners else 4 * size_2d[1]
        return EngineState(
            bank=membank.init_bank(n_layers, batch, cap, hw, ck, cv, dt, dev,
                                   with_id=with_id),
            short=membank.init_short_term(n_layers, batch, self.skip, hw, ck,
                                          cv, dt, dev, with_id=with_id),
            pending_long_k=zeros(ck), pending_long_v=zeros(cv),
            pending_short_k=zeros(ck), pending_short_v=zeros(cv),
            pending_id_v=zeros(d) if with_id else None,
            pending_mass=torch.zeros((batch, hw, cap), dtype=torch.float32,
                                     device=dev),
            pred_logits_4x=torch.zeros((batch, h4, w4, cfg.max_obj_num + 1),
                                       dtype=dt, device=dev),
            frame_step=0, last_mem_step=-1,
            mem_gap=self.gap if mem_gap is None else mem_gap,
            obj_nums=torch.ones(batch, dtype=torch.long, device=dev),
            # whole on every rank of a model group: the GRU mixes channels
            gru_hidden_k=zeros(d) if gru else None,
            gru_hidden_v=zeros(d) if gru else None)

    def _id_emb_from_label(self, label: torch.Tensor, dtype: torch.dtype):
        return self.model.get_id_emb(label_to_one_hot(
            label.to(self.device), self.cfg.max_obj_num,
            self.cfg.ignore_token, dtype))

    def _temporal_pe(self, length: torch.Tensor,
                     pos: Optional[torch.Tensor] = None):
        """(cur_pe [C], mem_pe [B, T_cap, C]) interpolated to the live
        memory length (reference transformer.py:594-629), permuted onto the
        bank's physical slots by `pos`; free slots get zero PE."""
        pe = self.model.temporal_pe()
        if pe is None:
            return None
        cur, mem = pe
        mem_i = interpolated_memory_pe(mem, length,
                                       self.cfg.mem_bank_capacity)
        if pos is not None:
            gathered = torch.gather(
                mem_i, 1, pos.clamp_min(0)[..., None].expand_as(mem_i))
            mem_i = torch.where((pos >= 0)[..., None], gathered, 0.0)
        return cur[0], mem_i

    @torch.no_grad()
    def add_reference_frame(self, state: EngineState, img: torch.Tensor,
                            mask: torch.Tensor, obj_nums: torch.Tensor
                            ) -> EngineState:
        """img: [B, H, W, 3]; mask: int [B, H, W]; obj_nums: [B]. Re-adding
        a reference frame resets the memory (reference init_LSTT_memory,
        aot_engine.py:321-323) and the ConvGRU hidden states."""
        with tracing.span('add_reference_frame', state.frame_step):
            membank.reset_bank(state.bank)
            membank.reset_short_term(state.short)
            state.pending_mass.zero_()
            for hidden in ((state.gru_hidden_k or [])
                           + (state.gru_hidden_v or [])):
                hidden.zero_()
            img = img.to(self.device, self.dtype)
            # a mask-conditioned encoder sees the reference label too
            # (reference aot_engine.py:157-160, 258-260)
            xs = self.model.encode_image(
                img, mask[..., None].to(self.device) if self.cfg.use_mask
                else None)
            b, _, h, w = xs[-1].shape
            size_2d = (h, w)
            id_emb = self._id_emb_from_label(mask, img.dtype)
            tpe = self._temporal_pe(torch.ones(b, dtype=torch.long,
                                               device=self.device))
            if tpe is not None:
                tpe = (tpe[0], tpe[1][:, :1])            # one virtual slot
            inters, mems, _ = self.model.lstt_forward(
                xs[-1], None, None, id_emb,
                self._self_pos_emb(size_2d, img.dtype), size_2d,
                temporal_pe=tpe)
            obj_nums = obj_nums.to(self.device)
            logits = _mask_unused_ids(
                self.model.decode_id_logits(inters, xs), obj_nums)

            def stack(key):
                return [m[key] for m in mems]
            long_k = stack('curr_k')
            if self.is_deaot:
                long_v = stack('curr_v')
                long_id_v = stack('global_id_v_fused')
                short_k, short_v, short_id_v = long_k, long_v, long_id_v
            else:
                long_v, long_id_v = stack('global_v_fused'), None
                short_k, short_v, short_id_v = (stack('local_k'),
                                                stack('local_v'), None)
            membank.append_frame(state.bank, long_k, long_v, long_id_v,
                                 state.frame_step)
            tracing.count('bank.writes', b)
            membank.push_short_term(state.short, short_k, short_v, short_id_v)
            state.pred_logits_4x = logits
            state.last_mem_step = state.frame_step
            state.obj_nums = obj_nums
            return state

    @torch.no_grad()
    def propagate(self, state: EngineState, img: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, EngineState]:
        """One frame against the memory. `mask` conditions a
        mask-conditioned encoder (the oracle's ground truth, an int label
        [B, H, W, 1]; reference aot_engine.py:404-417); other models ignore
        it. Returns (logits [B, H4, W4, O+1], state)."""
        state.frame_step += 1
        with tracing.span('propagate', state.frame_step):
            img = img.to(self.device, self.dtype)
            with tracing.span('propagate/encode'):
                xs = self.model.encode_image(
                    img, None if mask is None else mask.to(self.device))
            _, _, h, w = xs[-1].shape
            with tracing.span('propagate/gpm'):
                bank = state.bank
                tpe = self._temporal_pe(bank.length, bank.pos)
                short_k, short_v, short_id_v = state.short.read()
                if self.is_deaot:
                    long_mem = (bank.k, bank.v, bank.id_v, bank.slot_valid)
                    short_mem = (short_k, short_v, short_id_v)
                else:
                    long_mem = (bank.k, bank.v, bank.slot_valid)
                    short_mem = (short_k, short_v)
                inters, mems, mass = self.model.lstt_forward(
                    xs[-1], long_mem, short_mem, None,
                    self._self_pos_emb((h, w), img.dtype), (h, w),
                    temporal_pe=tpe, need_mass=True)
                tp = self.model.tp
                if tp.size > 1 and not self.is_deaot and mass is not None:
                    # the LSTT splits its heads: each rank's mass is the mean
                    # over its own, the same number of heads on every rank
                    dist.all_reduce_([mass], tp)
                    mass /= tp.size
            with tracing.span('propagate/decode'):
                logits = _mask_unused_ids(
                    self.model.decode_id_logits(inters, xs), state.obj_nums)
            state.pending_long_k = [m['curr_k'] for m in mems]
            state.pending_long_v = [m['curr_v'] for m in mems]
            if self.is_deaot:
                d = self.cfg.encoder_embedding_dim
                state.pending_short_k = state.pending_long_k
                state.pending_short_v = state.pending_long_v
                # layer 0 has no id branch input yet; its slot is never read
                state.pending_id_v = [
                    m['curr_id_v'] if m['curr_id_v'] is not None
                    else torch.zeros_like(m['curr_v'][..., :d]) for m in mems]
            else:
                state.pending_short_k = [m['local_k'] for m in mems]
                state.pending_short_v = [m['local_v'] for m in mems]
            state.pending_mass = mass
            state.pred_logits_4x = logits
            return logits, state

    @torch.no_grad()
    def update_memory(self, state: EngineState, mask: torch.Tensor
                      ) -> EngineState:
        """mask: int [B, H, W] (the predicted label map). Pushes the
        short-term memory every frame and, every `mem_gap` frames, appends
        to the long-term bank and evicts once over budget (reference
        aot_engine.py:327-369, transformer.py:269-436)."""
        with tracing.span('update_memory', state.frame_step):
            cfg = self.cfg
            bank = state.bank
            with tracing.span('update_memory/fuse'):
                id_emb = self._id_emb_from_label(mask, bank.k[0].dtype)
                per_layer = []
                for idx in range(cfg.lstt_num):
                    m = dict(curr_k=state.pending_long_k[idx],
                             curr_v=state.pending_long_v[idx],
                             local_k=state.pending_short_k[idx],
                             local_v=state.pending_short_v[idx])
                    if self.is_deaot:
                        m['curr_id_v'] = (None if idx == 0
                                          else state.pending_id_v[idx])
                    per_layer.append(m)
                fused = self.model.fuse_memory_values(per_layer, id_emb)

            def stack(key):        # the id_v entries are None for AOT
                return [f[key] for f in fused]
            with tracing.span('update_memory/short_push'):
                membank.push_short_term(state.short, stack('short_k'),
                                        stack('short_v'), stack('short_id_v'))
            if cfg.no_long_memory:
                return state
            if state.frame_step - state.last_mem_step < state.mem_gap:
                return state
            with tracing.span('update_memory/bank_append'):
                membank.append_frame(bank, stack('long_k'), stack('long_v'),
                                     stack('long_id_v'), state.frame_step)
                tracing.count('bank.writes', mask.shape[0])
                over = bank.length > cfg.former_mem_len + cfg.latter_mem_len
            with tracing.span('update_memory/bank_score'):
                # GPM scores on every long-term write (reference
                # transformer.py:880-964 has no early return), LSTT only once
                # over budget (:332-334)
                drop_idx = membank.eviction_scores_and_update(
                    bank, state.pending_mass,
                    fg_proba=self._foreground_proba(state),
                    gru_memory=cfg.gru_memory,
                    enabled=None if self.is_deaot else over,
                    former_len=cfg.former_mem_len)
            with tracing.span('update_memory/bank_evict'):
                compressed = None
                if cfg.gru_memory and not self.is_deaot:
                    compressed = self._compress_evicted(state, drop_idx, over)
                membank.evict_frame(bank, drop_idx, enabled=over,
                                    compressed_kv=compressed)
                tracing.count('bank.evictions', over)
            state.last_mem_step = state.frame_step
            return state

    def _compress_evicted(self, state: EngineState, drop_idx: torch.Tensor,
                          over: torch.Tensor):
        """ConvGRU-compress the slot about to be evicted; returns the
        per-layer (K, V) to write into logical slot 1. The hidden state
        advances only where a drop happens (`over`; reference
        restrict_long_memories returns early while within budget,
        transformer.py:332-334, and updates hidden_states only inside the
        is_drop branch, :420-430)."""
        bank = state.bank
        rows = torch.arange(drop_idx.shape[0], device=drop_idx.device)
        phys = bank.phys_of(drop_idx)
        (out_k, out_v), (hid_k, hid_v) = self.model.compress_evicted_slots(
            [k[rows, phys] for k in bank.k], [v[rows, phys] for v in bank.v],
            state.gru_hidden_k, state.gru_hidden_v, self._enc_size_2d(state))
        sel = over[:, None, None]
        state.gru_hidden_k = [torch.where(sel, new, old) for new, old
                              in zip(hid_k, state.gru_hidden_k)]
        state.gru_hidden_v = [torch.where(sel, new, old) for new, old
                              in zip(hid_v, state.gru_hidden_v)]
        return out_k, out_v

    def _enc_size_2d(self, state: EngineState) -> Tuple[int, int]:
        """The encoder grid, recovered from the stored 4x logits."""
        h4, w4 = state.pred_logits_4x.shape[1:3]
        if self.cfg.align_corners:
            return (h4 + 3) // 4, (w4 + 3) // 4
        return h4 // 4, w4 // 4

    def _foreground_proba(self, state: EngineState) -> torch.Tensor:
        """1 - P(background) on the encoder grid, [B, HW] (reference
        aot_engine.py:355-362; always align_corners=True there)."""
        logits = interpolate_bilinear(state.pred_logits_4x.permute(0, 3, 1, 2),
                                      self._enc_size_2d(state), True)
        fg = 1.0 - torch.softmax(logits.float(), dim=1)[:, 0]
        return fg.reshape(fg.shape[0], -1)

    @torch.no_grad()
    def predict_mask(self, logits_4x: torch.Tensor,
                     output_size: Tuple[int, int]) -> torch.Tensor:
        """Upsample [B, H4, W4, C] logits to output_size and argmax
        (reference aot_engine.py:467-483). Returns int64 [B, H, W]."""
        with tracing.span('predict_mask'):
            logits = interpolate_bilinear(logits_4x.permute(0, 3, 1, 2),
                                          output_size, self.cfg.align_corners)
            return logits.argmax(dim=1)
