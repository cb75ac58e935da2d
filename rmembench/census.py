"""Where the device time of the traced steps goes, by model component.

A frozen copy of the inference half of the measured package's profiler
census (`utils/profiling.py`: `classify`, `ranged_modules`, `annotate`,
`census_from_profile`), kept here so that a later change to the
program's own census cannot move the benchmark's numbers. It opens
torch.profiler ranges around the program's modules from outside (forward
hooks, and the attention modules' `bank_read` / `multi_value_call`
methods) and around the engine's stages, and places every kernel, memcpy
and memset at the runtime call that launched it (same correlation id):
the innermost range above that call names its component. Device time is
summed over kernels, never taken from a range's span.
"""
from __future__ import annotations

import re
from collections import Counter
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch
from torch.autograd.profiler import record_function

# kernel-name fragments -> group, first match wins
KERNEL_GROUPS = (
    ('B3 memory_read_attention', ('attentionread',)),
    ('B1 memory_read', ('memory_read',)),
    ('B2 local_attn', ('local_attn',)),
    ('convolution', ('conv', 'fprop', 'implicit', 'winograd', 'cudnn')),
    ('matmul', ('gemm', 'cutlass', 'cublas', 'xmma', 'nvjet')),
    ('normalisation', ('norm',)),
    ('softmax', ('softmax',)),
    ('other', ('',)),
)

# module-path or range substring -> component, first match wins
COMPONENTS = (
    ('short_term_attn', 'short_term_attn'),
    ('long_term_attn', 'long_term_attn'),
    ('self_attn', 'self_attn'),
    ('lstt', 'lstt_other'),
    ('encoder', 'encoder'),
    ('decoder', 'decode'),
    ('patch_wise_id_bank', 'id_embed'),
    ('fuse_memory', 'memory_update'),
    ('update_memory', 'memory_update'),
    ('interpolate', 'resize'),
)

UNMATCHED = 'unmatched'
MODULE = 'module: '
STAGE = 'stage: '
BENCH = 'bench: '           # the harness's own ranges
ENGINE_STAGES = ('add_reference_frame', 'propagate', 'predict_mask',
                 'update_memory')
CALL_METHODS = ('bank_read', 'multi_value_call')
# the Swin encoder's parts read apart: its window attention (with the qkv
# and proj linears inside it) and its MLPs
SWIN_PARTS = ('WindowAttention', 'Mlp')


def classify(name: str) -> str:
    low = name.lower()
    for needle, label in COMPONENTS:
        if needle in low:
            return label
    return 'other'


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def is_range(name: str) -> bool:
    return name.startswith((MODULE, STAGE))


def _label(range_name: str) -> str:
    return range_name.split(': ', 1)[1]


def ranged_modules(model) -> List[Tuple[str, torch.nn.Module]]:
    """Each module whose component differs from its parent's, and the Swin
    parts."""
    out = []
    for path, mod in model.named_modules():
        if not path:
            continue
        parent = path.rsplit('.', 1)[0] if '.' in path else ''
        part = type(mod).__name__ in SWIN_PARTS
        if part or classify(path) != classify(parent):
            out.append((path, mod))
    return out


def _wrap(obj, name: str, range_name: str, undo: list) -> None:
    had = name in vars(obj)
    fn = getattr(obj, name)

    def ranged(*args, **kwargs):
        with record_function(range_name):
            return fn(*args, **kwargs)
    setattr(obj, name, ranged)
    undo.append(lambda: setattr(obj, name, fn) if had else delattr(obj, name))


@contextmanager
def annotate(model, engine):
    """The census's ranges while the block runs; all removed on exit, also
    when the block raises."""
    handles, undo, open_ranges = [], [], []
    try:
        for path, mod in ranged_modules(model):
            def enter(_mod, _args, name=MODULE + path):
                rf = record_function(name)
                rf.__enter__()
                open_ranges.append(rf)

            def leave(_mod, _args, _out):
                open_ranges.pop().__exit__(None, None, None)
            handles.append(mod.register_forward_pre_hook(enter))
            handles.append(mod.register_forward_hook(leave, always_call=True))
            for method in CALL_METHODS:
                if hasattr(mod, method):
                    _wrap(mod, method, MODULE + path, undo)
        for stage in ENGINE_STAGES:
            _wrap(engine, stage, STAGE + stage, undo)
        yield
    finally:
        for h in handles:
            h.remove()
        for fn in reversed(undo):
            fn()
        while open_ranges:
            open_ranges.pop().__exit__(None, None, None)


def is_cpu(evt) -> bool:
    return not str(evt.device_type).endswith(('CUDA', 'PrivateUse1'))


def _contexts(events) -> Dict[int, tuple]:
    """id(event) -> the census ranges above it, innermost first."""
    ctx = {}
    for e in events:
        ranges = (ctx.get(id(e.cpu_parent), ()) if e.cpu_parent is not None
                  else ())
        if is_range(e.name):
            ranges = (e.name,) + ranges
        ctx[id(e)] = ranges
    return ctx


def census(events, n_steps: int) -> dict:
    """Device ms a step by component, kernel group and part, with the
    kernels, memcpys and memsets a step, from the profiler's events of
    `n_steps` steps. Raises when the events hold no kernel."""
    events = sorted(events, key=lambda e: (e.time_range.start,
                                           -e.time_range.end))
    cpu_events = [e for e in events if is_cpu(e)]
    ctx = _contexts(cpu_events)
    runtime = {e.id: e for e in cpu_events if e.name.startswith('cu')}
    comps, groups, parts = Counter(), Counter(), Counter()
    group_calls = Counter()
    launches = copies = 0
    for e in events:
        if (is_cpu(e) or e.name.startswith((MODULE, STAGE, BENCH))
                or getattr(e, 'is_user_annotation', False)):
            continue
        us = e.time_range.end - e.time_range.start
        call = runtime.get(e.id)
        ranges = ctx[id(call)] if call is not None else ()
        comps[classify(_label(ranges[0])) if ranges else UNMATCHED] += us
        group = kernel_group(e.name)
        groups[group] += us
        if e.name.startswith(('Memcpy', 'Memset')):
            copies += 1
        else:
            launches += 1
            group_calls[group] += 1
        for key in {re.sub(r'\.\d+(?=\.|$)', '.N', _label(r))
                    for r in ranges if r.startswith(MODULE)}:
            parts[key] += us
    if launches == 0:
        raise RuntimeError('the profiler saw no kernel on the card: device '
                           'time cannot be measured')
    ms = lambda us: us / 1e3 / n_steps
    return {
        'components': {k: ms(v) for k, v in comps.most_common()},
        'groups': {k: ms(v) for k, v in groups.most_common()},
        'group_launches': {k: v / n_steps for k, v in group_calls.items()},
        'parts': {k: ms(v) for k, v in parts.most_common()},
        'launches': launches / n_steps,
        'copies': copies / n_steps,
    }
