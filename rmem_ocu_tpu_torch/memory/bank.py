"""Fixed-capacity long-term memory bank with RMem eviction scoring.

Counterpart of the JAX package's `memory/bank.py`, with the same
logical-position indirection:

- the K/V/ID_V buffers are unordered physical slots; `pos[b, t]` is the
  logical position of physical slot t (0 = oldest live frame, -1 = free),
- append writes one slot (the first free physical slot) and sets its pos
  to the current length,
- evict touches no data: positions above the dropped one decrement and the
  dropped slot's pos becomes -1,
- attention reads the bank in physical order (softmax over masked slots is
  permutation-invariant); the temporal PE and the former/latter semantics
  are functions of `pos`.

Unlike the JAX package the inference engine updates the bank IN PLACE:
`append_frame` writes the new frame's slot into the K/V/ID_V buffers, and
the other functions replace the bank's small per-slot tensors. Training
differentiates through the memory, where an in-place write would corrupt
the tensors autograd saved: the training engine uses the functional
`append_frame_functional`, `evict_frame_functional` and
`push_short_term_functional`, which build new tensors and return a new
bank or window, as the JAX package's do. The K/V/ID_V buffers are lists
of per-layer tensors [B, T_cap, HW, C]; the AOT family has no ID_V
(`id_v` is None).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import torch

LayerArrays = List[torch.Tensor]


@dataclass
class MemoryBank:
    k: LayerArrays                  # L x [B, T_cap, HW, Ck]
    v: LayerArrays                  # L x [B, T_cap, HW, Cv]
    id_v: Optional[LayerArrays]     # L x [B, T_cap, HW, Cv] (DeAOT) | None
    length: torch.Tensor            # [B] int64 live length
    pos: torch.Tensor               # [B, T_cap] int64 logical position, -1 free
    frame_ids: torch.Tensor         # [B, T_cap] int64 (-1 = empty), physical
    attn_ema: torch.Tensor          # [B, T_cap] f32 usage moving mean
    ema_present: torch.Tensor       # [B, T_cap] bool
    visits: torch.Tensor            # [B, T_cap] f32 UCB visit counts

    @property
    def capacity(self) -> int:
        return self.k[0].shape[1]

    @property
    def slot_valid(self) -> torch.Tensor:
        """[B, T_cap] bool: the physical slot holds a live frame."""
        return self.pos >= 0

    def logical_to_phys(self) -> torch.Tensor:
        """[B, T_cap]: perm[b, j] = physical slot of logical position j
        (0 for j >= length)."""
        cap = self.capacity
        b = self.pos.shape[0]
        tgt = torch.where(self.pos >= 0, self.pos, cap)
        perm = torch.zeros((b, cap + 1), dtype=torch.long,
                           device=self.pos.device)
        src = torch.arange(cap, device=self.pos.device).expand(b, cap)
        perm.scatter_(1, tgt, src)
        return perm[:, :cap]

    @property
    def ordered_frame_ids(self) -> torch.Tensor:
        """[B, T_cap] frame ids in logical order, -1 past length."""
        ids = torch.gather(self.frame_ids, 1, self.logical_to_phys())
        j = torch.arange(self.capacity, device=ids.device)[None]
        return torch.where(j < self.length[:, None], ids, -1)

    def phys_of(self, logical_idx: torch.Tensor) -> torch.Tensor:
        """[B] physical slot holding logical position `logical_idx` ([B]);
        0 if it is not live."""
        return (self.pos == logical_idx[:, None]).to(torch.uint8).argmax(-1)


@dataclass
class ShortTermMemory:
    """Sliding window of the last `skip` frames' K/V; attention reads the
    oldest entry (reference transformer.py:293-299)."""
    k: LayerArrays                  # L x [B, S, HW, Ck]
    v: LayerArrays
    id_v: Optional[LayerArrays]
    count: torch.Tensor             # [B] frames pushed so far

    def read(self):
        return ([k[:, 0] for k in self.k], [v[:, 0] for v in self.v],
                None if self.id_v is None else [i[:, 0] for i in self.id_v])


def _layer_groups(mem, new_k, new_v, new_id_v):
    """(buffers, new frames) pairs of a bank or window: K, V and, where
    it has one, ID_V."""
    groups = [(mem.k, new_k), (mem.v, new_v)]
    if mem.id_v is not None:
        groups.append((mem.id_v, new_id_v))
    return groups


def init_bank(num_layers: int, batch: int, capacity: int, hw: int, ck: int,
              cv: int, dtype: torch.dtype, device,
              with_id: bool = True) -> MemoryBank:
    def zeros(c):
        return [torch.zeros((batch, capacity, hw, c), dtype=dtype,
                            device=device) for _ in range(num_layers)]
    slots = (batch, capacity)
    return MemoryBank(
        k=zeros(ck), v=zeros(cv), id_v=zeros(cv) if with_id else None,
        length=torch.zeros(batch, dtype=torch.long, device=device),
        pos=torch.full(slots, -1, dtype=torch.long, device=device),
        frame_ids=torch.full(slots, -1, dtype=torch.long, device=device),
        attn_ema=torch.zeros(slots, dtype=torch.float32, device=device),
        ema_present=torch.zeros(slots, dtype=torch.bool, device=device),
        visits=torch.zeros(slots, dtype=torch.float32, device=device))


def reset_bank(bank: MemoryBank) -> None:
    """Empty the bank in place (reference init_LSTT_memory on a re-added
    reference frame, transformer.py:438-453)."""
    for arr in bank.k + bank.v + (bank.id_v or []):
        arr.zero_()
    bank.length.zero_()
    bank.pos.fill_(-1)
    bank.frame_ids.fill_(-1)
    bank.attn_ema.zero_()
    bank.ema_present.zero_()
    bank.visits.zero_()


def _write_slot(arr: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
                idx: torch.Tensor, enabled: torch.Tensor) -> None:
    """In-place one-slot write per batch element: arr [B, T, HW, C], new
    [B, HW, C], rows = arange(B), idx [B]; where `enabled` ([B] bool) is
    False the slot keeps its content."""
    arr[rows, idx] = torch.where(enabled[:, None, None], new.to(arr.dtype),
                                 arr[rows, idx])


def append_frame(bank: MemoryBank, new_k: LayerArrays, new_v: LayerArrays,
                 new_id_v: Optional[LayerArrays], frame_idx: int,
                 enabled: Optional[torch.Tensor] = None) -> None:
    """Write the new frame ([B, HW, C] per layer) into the first free
    physical slot, in place, and bump the length; where `enabled` ([B]
    bool) is False the bank is unchanged. Callers keep length < capacity
    before an append; if no slot is free the newest logical slot is
    overwritten (never the protected former frame)."""
    cap = bank.capacity
    b = bank.length.shape[0]
    dev = bank.pos.device
    if enabled is None:
        enabled = torch.ones(b, dtype=torch.bool, device=dev)
    t = torch.arange(cap, device=dev)[None]
    idx = torch.where(bank.pos < 0, t, cap).min(dim=-1).values
    newest = bank.phys_of((bank.length - 1).clamp_min(0))
    idx = torch.where(idx >= cap, newest, idx)
    rows = torch.arange(b, device=dev)
    for arrs, news in _layer_groups(bank, new_k, new_v, new_id_v):
        for arr, new in zip(arrs, news):
            _write_slot(arr, new, rows, idx, enabled)
    sel = (t == idx[:, None]) & enabled[:, None]
    bank.pos = torch.where(sel, bank.length.clamp_max(cap - 1)[:, None],
                           bank.pos)
    bank.frame_ids = torch.where(sel, frame_idx, bank.frame_ids)
    bank.attn_ema = torch.where(sel, 0.0, bank.attn_ema)
    bank.ema_present = bank.ema_present & ~sel
    bank.visits = torch.where(sel, 0.0, bank.visits)
    bank.length = torch.where(enabled, (bank.length + 1).clamp_max(cap),
                              bank.length)


def _free_slot(bank: MemoryBank) -> torch.Tensor:
    """[B] the first free physical slot, or, if none is free, the newest
    logical slot (never the protected former frame)."""
    cap = bank.capacity
    t = torch.arange(cap, device=bank.pos.device)[None]
    idx = torch.where(bank.pos < 0, t, cap).min(dim=-1).values
    newest = bank.phys_of((bank.length - 1).clamp_min(0))
    return torch.where(idx >= cap, newest, idx)


def append_frame_functional(bank: MemoryBank, new_k: LayerArrays,
                            new_v: LayerArrays,
                            new_id_v: Optional[LayerArrays], frame_idx,
                            enabled: Optional[torch.Tensor] = None
                            ) -> MemoryBank:
    """`append_frame` without writing in place: returns a new bank whose
    buffers select the new frame ([B, HW, C] per layer) at its slot and
    the old content elsewhere, so autograd sees every write (the JAX
    package's `append_frame`). frame_idx: int or [B]."""
    cap = bank.capacity
    dev = bank.pos.device
    if enabled is None:
        enabled = torch.ones_like(bank.length, dtype=torch.bool)
    idx = _free_slot(bank)
    t = torch.arange(cap, device=dev)[None]
    sel = (t == idx[:, None]) & enabled[:, None]             # [B, T]

    def write(arrs, news):
        return [torch.where(sel[:, :, None, None], new.to(arr.dtype)[:, None],
                            arr) for arr, new in zip(arrs, news)]
    return replace(
        bank, k=write(bank.k, new_k), v=write(bank.v, new_v),
        id_v=None if bank.id_v is None else write(bank.id_v, new_id_v),
        pos=torch.where(sel, bank.length.clamp_max(cap - 1)[:, None],
                        bank.pos),
        frame_ids=torch.where(sel, torch.as_tensor(frame_idx, device=dev)
                              .reshape(-1, 1), bank.frame_ids),
        attn_ema=torch.where(sel, 0.0, bank.attn_ema),
        ema_present=bank.ema_present & ~sel,
        visits=torch.where(sel, 0.0, bank.visits),
        length=torch.where(enabled, (bank.length + 1).clamp_max(cap),
                           bank.length))


def evict_frame_functional(bank: MemoryBank, drop_idx: torch.Tensor,
                           enabled: Optional[torch.Tensor] = None
                           ) -> MemoryBank:
    """`evict_frame` returning a new bank (no data moves either way)."""
    if enabled is None:
        enabled = torch.ones_like(drop_idx, dtype=torch.bool)
    en = enabled[:, None]
    dropped = (bank.pos == drop_idx[:, None]) & en
    shift = (bank.pos > drop_idx[:, None]) & en
    pos = torch.where(shift, bank.pos - 1, bank.pos)
    return replace(
        bank, pos=torch.where(dropped, -1, pos),
        length=torch.where(enabled, (bank.length - 1).clamp_min(0),
                           bank.length),
        frame_ids=torch.where(dropped, -1, bank.frame_ids))


def default_drop_index(bank: MemoryBank, former_len: int,
                       gru_memory: bool = False) -> torch.Tensor:
    """The training's drop slot, without attention scoring, as a LOGICAL
    position (reference transformer.py:335-337)."""
    return torch.full_like(bank.length, former_len + (1 if gru_memory
                                                      else 0))


def evict_frame(bank: MemoryBank, drop_idx: torch.Tensor,
                enabled: Optional[torch.Tensor] = None,
                compressed_kv=None) -> None:
    """Drop the frame at LOGICAL position drop_idx ([B]) where `enabled`
    ([B] bool); no data moves (reference transformer.py:432-434).

    compressed_kv: optional (k1, v1) per-layer lists of [B, HW, C], written
    into LOGICAL slot 1 after the drop (ConvGRU compression, reference
    transformer.py:420-430; the scoring protects logical slots 0 and 1 in
    that mode, so slot 1's physical slot is not the dropped one)."""
    if enabled is None:
        enabled = torch.ones_like(drop_idx, dtype=torch.bool)
    en = enabled[:, None]
    dropped = (bank.pos == drop_idx[:, None]) & en
    shift = (bank.pos > drop_idx[:, None]) & en
    pos = torch.where(shift, bank.pos - 1, bank.pos)
    bank.pos = torch.where(dropped, -1, pos)
    bank.length = torch.where(enabled, (bank.length - 1).clamp_min(0),
                              bank.length)
    bank.frame_ids = torch.where(dropped, -1, bank.frame_ids)
    if compressed_kv is not None:
        phys1 = bank.phys_of(torch.ones_like(drop_idx))
        rows = torch.arange(drop_idx.shape[0], device=drop_idx.device)
        for arrs, news in zip((bank.k, bank.v), compressed_kv):
            for arr, new in zip(arrs, news):
                _write_slot(arr, new, rows, phys1, enabled)


def eviction_scores_and_update(bank: MemoryBank, frame_mass: torch.Tensor,
                               fg_proba: Optional[torch.Tensor] = None,
                               gru_memory: bool = False,
                               enabled: Optional[torch.Tensor] = None,
                               former_len: int = 1,
                               moving_mean_factor: float = 0.8,
                               ucb_add: float = 8.0, ucb_mul: float = 1.5
                               ) -> torch.Tensor:
    """RMem attention-usage + UCB eviction (reference
    transformer.py:339-411).

    frame_mass: [B, HWq, T_cap] mass each PHYSICAL slot received at the
    last propagation (the just-appended newest frame and free slots have
    none); fg_proba: optional [B, HWq] foreground weighting. Updates the
    EMA and visit state in place where `enabled` and returns the LOGICAL
    position to drop ([B]); the caller evicts only when over budget. With
    gru_memory, logical slot 1 (the ConvGRU's compressed slot) is protected
    and pinned like the former frame."""
    pos = bank.pos
    if enabled is None:
        enabled = torch.ones_like(bank.length, dtype=torch.bool)
    n_scored = (bank.length - 1).clamp_min(0)
    scored = (pos >= 0) & (pos < n_scored[:, None])
    live = pos >= 0

    w = frame_mass.float()
    if fg_proba is not None:
        w = w * fg_proba[..., None]
    w = w.sum(dim=1)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)

    ema = torch.where(bank.ema_present & scored,
                      (1 - moving_mean_factor) * bank.attn_ema
                      + moving_mean_factor * w, w)
    ema = torch.where(scored, ema, bank.attn_ema)
    ema_present = bank.ema_present | scored
    visits = torch.where(live, bank.visits + 1.0, bank.visits)

    # the former slot's count is pinned to the candidate count (:394-396)
    pinned = n_scored.float()[:, None]
    n = torch.where(pos == 0, pinned, visits)
    if gru_memory:
        n = torch.where((pos == 1) & (n_scored[:, None] > 1), pinned, n)
    n_sum = torch.where(scored, n, 0.0).sum(dim=-1, keepdim=True)
    bonus = ucb_mul * torch.sqrt(torch.log(n_sum.clamp_min(1.0))
                                 / (n + ucb_add))
    score = ema + bonus

    # the former frame (and the GRU's slot 1) is protected; the newest (no
    # mass) is not scored
    candidate = scored & (pos >= (2 if gru_memory else 1))
    phys_min = torch.where(candidate, score, torch.inf).argmin(dim=-1)
    drop_idx = torch.gather(pos, 1, phys_min[:, None])[:, 0]
    has_candidate = candidate.any(dim=-1) & enabled
    fallback = former_len + (1 if gru_memory else 0)
    drop_idx = torch.where(has_candidate, drop_idx,
                           torch.full_like(drop_idx, fallback))

    en = enabled[:, None]
    bank.attn_ema = torch.where(en, ema, bank.attn_ema)
    bank.ema_present = torch.where(en, ema_present, bank.ema_present)
    bank.visits = torch.where(en, visits, bank.visits)
    return drop_idx


def init_short_term(num_layers: int, batch: int, skip: int, hw: int,
                    ck: int, cv: int, dtype: torch.dtype, device,
                    with_id: bool = True) -> ShortTermMemory:
    def zeros(c):
        return [torch.zeros((batch, skip, hw, c), dtype=dtype, device=device)
                for _ in range(num_layers)]
    return ShortTermMemory(k=zeros(ck), v=zeros(cv),
                           id_v=zeros(cv) if with_id else None,
                           count=torch.zeros(batch, dtype=torch.long,
                                             device=device))


def reset_short_term(short: ShortTermMemory) -> None:
    for arr in short.k + short.v + (short.id_v or []):
        arr.zero_()
    short.count.zero_()


def push_short_term(short: ShortTermMemory, new_k: LayerArrays,
                    new_v: LayerArrays,
                    new_id_v: Optional[LayerArrays]) -> None:
    """Append to the sliding window in place, dropping the oldest entry
    once it is full (reference transformer.py:293-299)."""
    s = short.k[0].shape[1]
    b = short.count.shape[0]
    rows = torch.arange(b, device=short.count.device)
    full = (short.count >= s)[:, None, None, None]
    slot = short.count.clamp_max(s - 1)
    for arrs, news in _layer_groups(short, new_k, new_v, new_id_v):
        for arr, new in zip(arrs, news):
            new = new.to(arr.dtype)
            if s == 1:
                arr[:, 0] = new
                continue
            shifted = torch.cat([arr[:, 1:], new[:, None]], dim=1)
            grown = arr.clone()
            grown[rows, slot] = new
            arr.copy_(torch.where(full, shifted, grown))
    short.count += 1


def push_short_term_functional(short: ShortTermMemory, new_k: LayerArrays,
                               new_v: LayerArrays,
                               new_id_v: Optional[LayerArrays]
                               ) -> ShortTermMemory:
    """`push_short_term` returning a new window of new tensors."""
    s = short.k[0].shape[1]
    full = (short.count >= s)[:, None, None, None]
    slot = short.count.clamp_max(s - 1)
    at = (torch.arange(s, device=short.count.device)[None]
          == slot[:, None])[:, :, None, None]               # [B, S, 1, 1]

    def push(arrs, news):
        out = []
        for arr, new in zip(arrs, news):
            new = new.to(arr.dtype)[:, None]
            if s == 1:
                out.append(new)
                continue
            shifted = torch.cat([arr[:, 1:], new], dim=1)
            grown = torch.where(at, new, arr)
            out.append(torch.where(full, shifted, grown))
        return out
    return replace(
        short, k=push(short.k, new_k), v=push(short.v, new_v),
        id_v=None if short.id_v is None else push(short.id_v, new_id_v),
        count=short.count + 1)
