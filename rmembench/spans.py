"""The program's own spans in the traced steps, for the readers of host
time and counts by stage.

The program records a span (`rmem_ocu_tpu_torch.utils.tracing`) for each
of its stages while torch.profiler runs, which in a run is the traced
steps alone. A step is one top-level `propagate` span; the traced steps
are the last `traced_steps` of them, with every span recorded from the
first of them on. A program without that module, or one that recorded no
such steps, gives None.
"""
from __future__ import annotations

from typing import Iterable, Optional


def traced(run) -> Optional[list]:
    """The spans of the run's traced steps, or None."""
    try:
        from rmem_ocu_tpu_torch.utils import tracing
    except ImportError:
        return None
    k = run.traffic['traced_steps']
    recorded = tracing.spans()
    steps = [i for i, s in enumerate(recorded)
             if s.label == 'propagate' and s.parent is None]
    if k <= 0 or len(steps) < k:
        return None
    return recorded[steps[-k]:]


def host_ms(run, labels: Iterable[str]) -> Optional[float]:
    """Host milliseconds a traced step inside the spans `labels`; None where
    no span of theirs was recorded."""
    spans = traced(run)
    labels = set(labels)
    mine = [s for s in spans or () if s.label in labels]
    if not mine:
        return None
    return sum(s.ms for s in mine) / run.traffic['traced_steps']


def counted(run, name: str) -> Optional[float]:
    """The counter `name` counted in the traced steps, a step."""
    spans = traced(run)
    if spans is None:
        return None
    return sum(s.counted(name) for s in spans) / run.traffic['traced_steps']
