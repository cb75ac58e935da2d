"""The program's own spans and counters.

- `span(label, step=None)` marks a stage of the work. While a
  torch.profiler session runs it opens the profiler range
  `'stage: ' + label` (on the trace's timeline with the kernels it
  launches, and the range the census places them by) and keeps a `Span`:
  its label, the host's monotonic clock at its start and end, the span
  it sits in, and `step` (the engine's `frame_step`; a span given none
  takes its parent's). Without a session it does nothing beyond one flag
  check; there is no other switch. The newest `MAX_SPANS` spans are kept.
- `count(name, n=1)` counts on the innermost recording span, if one is
  open, so that a reader can take a counter over exactly the profiled
  work. An int is also added to a process-wide counter, always on. A
  device tensor (say a [B] bool mask) is kept by reference on the span
  alone, and summed only when read: a count adds no host sync, and none
  is launched or held without a profiler.
- `spans()` and `counters()` read the record; `clear()` empties it.

The package's spans (labels after `STAGE`) and counters:

- `InferEngine.propagate`: `propagate` with `propagate/encode`,
  `propagate/gpm` and `propagate/decode`.
- `InferEngine.predict_mask`: `predict_mask` (no step: it takes no state).
- `InferEngine.update_memory`: `update_memory` with `update_memory/fuse`,
  `update_memory/short_push`, and at a bank write
  `update_memory/bank_append`, `update_memory/bank_score` and
  `update_memory/bank_evict`; `bank.writes` (an int) and `bank.evictions`
  (the streams over budget, a device mask): a stream-write and a stream's
  eviction each.
- `InferEngine.add_reference_frame`: `add_reference_frame`; `bank.writes`.
- kernels B1, B2, B3: `kernels.b1.launches`, `kernels.b2.launches`,
  `kernels.b3.launches`.

The engine's four top-level labels are `ENGINE_STAGES`. A label keeps the
census's component of the range it sits in (`utils/profiling.classify`):
a `propagate/` label holds no component's needle (so `decode`, not
`decoder`), an `update_memory/` label keeps `update_memory`.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import torch
from torch.autograd.profiler import record_function

STAGE = 'stage: '
ENGINE_STAGES = ('add_reference_frame', 'propagate', 'predict_mask',
                 'update_memory')
MAX_SPANS = 100_000

Count = Union[int, torch.Tensor]


@dataclass(eq=False)
class Span:
    label: str
    start_ns: int = 0
    end_ns: Optional[int] = None         # None while open
    parent: Optional['Span'] = None
    step: Optional[int] = None
    counts: Dict[str, List[Count]] = field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def counted(self, name: str) -> int:
        """What was counted under `name` while this span was the innermost
        one recording (a sync where a device tensor was counted)."""
        return sum(int(p.sum()) if isinstance(p, torch.Tensor) else p
                   for p in self.counts.get(name, ()))


_spans: deque = deque(maxlen=MAX_SPANS)
_open: List[Span] = []
_counters: Dict[str, int] = {}
_OFF = nullcontext()
_profiling = torch.autograd._profiler_enabled


class _Recording:
    __slots__ = ('span', 'range')

    def __init__(self, label: str, step: Optional[int]):
        parent = _open[-1] if _open else None
        if step is None and parent is not None:
            step = parent.step
        self.span = Span(label, parent=parent, step=step)
        self.range = record_function(STAGE + label)

    def __enter__(self) -> Span:
        self.range.__enter__()
        _open.append(self.span)
        _spans.append(self.span)
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.perf_counter_ns()
        _open.pop()
        self.range.__exit__(*exc)


def span(label: str, step: Optional[int] = None):
    """A context manager: the span `label` while a profiler session runs,
    else nothing."""
    if not _profiling():
        return _OFF
    return _Recording(label, step)


def count(name: str, n: Count = 1) -> None:
    if not isinstance(n, torch.Tensor):
        _counters[name] = _counters.get(name, 0) + n
    if _open:
        _open[-1].counts.setdefault(name, []).append(n)


def spans() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return list(_spans)


def counters() -> Dict[str, int]:
    """The process-wide counters (ints alone: a device tensor's count is
    on its span)."""
    return dict(_counters)


def clear() -> None:
    """Empties the spans and counters (spans still open stay open)."""
    _spans.clear()
    _counters.clear()
