"""The device's timeline in the traced steps: busy time, idle gaps and what
the host was doing in each, the operations that took most time.

Every kernel, memcpy and memset of the profile is an interval on the
device's timeline; busy time is the length of their union inside the
window (the harness's `bench: window` range), idle time the rest. An idle
gap is named after the innermost range open on the host when it began
(the harness's own ranges around each call into the program, the
census's stage and module ranges inside them).
"""
from __future__ import annotations

from collections import Counter
from typing import List, Tuple

from rmembench.census import is_cpu

WINDOW = 'bench: window'
HOST_RANGES = ('bench: ', 'stage: ', 'module: ')
TOP = 10


def device_timeline(events) -> dict:
    """busy_s, window_s, the ten longest idle gaps [[host range, s]] and
    the ten device operations that took most time [[name, s]]."""
    window = [e for e in events if e.name == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f'{len(window)} "{WINDOW}" ranges in the trace')
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    spans, by_name = [], Counter()
    for e in events:
        if (is_cpu(e) or e.name.startswith(HOST_RANGES)
                or getattr(e, 'is_user_annotation', False)):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            spans.append((s, t))
            by_name[e.name] += t - s
    if not spans:
        raise RuntimeError('no device activity inside the traced window')
    spans.sort()
    busy, gaps, cursor = 0.0, [], w0
    for s, t in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append((cursor, w1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if is_cpu(e) and e.name.startswith(HOST_RANGES)),
                  key=lambda r: (r[0], -r[1]))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = [[_host_range(host, g[0]), (g[1] - g[0]) / 1e6] for g in longest]
    return {
        'busy_s': busy / 1e6,
        'trace_window_s': (w1 - w0) / 1e6,
        'idle_gaps': named,
        'device_ops': [[n, us / 1e6] for n, us in by_name.most_common(TOP)],
    }


def _host_range(host: List[Tuple[float, float, str]], at: float) -> str:
    """The innermost host range open at `at` (the last-starting one that
    contains it)."""
    inner = 'outside any range'
    for s, t, name in host:
        if s > at:
            break
        if t >= at:
            inner = name
    return inner
