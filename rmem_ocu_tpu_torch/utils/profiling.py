"""The profiler census: where the time of a frame, an eval window or a
training step goes, by model component, by stage and by kernel group.

Counterpart of the JAX package's census tools (`tools/trace_census.py`,
`hlo_census.py`, `train_census.py`, `bench_breakdown.py`); the modes that
drive a workload are in `tools/census.py`. The JAX tools join each XLA
kernel to the module path in its HLO `op_name`; here the same labels come
from torch.profiler ranges:

- The engine's stages are the program's own spans (`utils/tracing.py`):
  `InferEngine` opens a `stage: ` range around each call and its parts
  (`propagate/encode`, `update_memory/bank_score`, ...) whenever a
  profiler runs.
- `annotate(model, trainer)` opens a range around every module
  whose path starts a component (`classify`; the path changes component
  there) and around the Swin encoder's window attention, its qkv and proj
  linears and its MLPs (forward hooks), and around the trainer's stages
  (instance attributes: the loss, the optimizer, the episode, and under
  remat the recompute through the checkpoint's `context_fn`). None of
  these ranges lives in the package's code, so an un-profiled run pays
  nothing for them. Everything is removed on exit, also on an
  exception.
- `census_from_profile(prof, window_ms, n)` turns a finished profile into
  one dict. Each kernel (each memcpy and memset too) is placed at the
  runtime call that launched it, found by its correlation id; the CPU
  events above that call give its ranges. A forward kernel goes to the
  innermost range. A kernel under autograd's `evaluate_function: XBackward0`
  goes to the component of the forward op that made the node: the event
  carries that op's `sequence_nr` and thread, and the forward op's own
  ranges name it. A kernel under a range inside the backward is the remat
  recompute (the checkpoint's forward again), counted apart. What maps to
  nothing, a node with `sequence_nr == -1` (AccumulateGrad, the graph
  root) included, is `unmatched`.

Kernels are counted, never range spans: a range's device-side twin spans
the gaps between its kernels. On a profile of the CPU alone (`--device
cpu`) the same dict counts each op's CPU self time, and op dispatches in
place of launches; `census['source']` says which.
"""
from __future__ import annotations

import re
import subprocess
import time
from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Tuple

import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from rmem_ocu_tpu_torch.utils.tracing import STAGE

# kernel-name fragments -> group, first match wins (cuDNN's implicit-GEMM
# convolutions before cuBLAS's GEMMs); B1, B2 and B3 are groups of their own
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

# module-path substring -> component label, first match wins: the JAX
# package's train_census._COMPONENTS
_COMPONENTS = [
    ('short_term_attn', 'short_term_attn'),
    ('long_term_attn', 'long_term_attn'),
    ('self_attn', 'self_attn'),
    ('lstt', 'lstt_other'),
    ('encoder', 'encoder'),
    ('decoder', 'decode'),
    ('patch_wise_id_bank', 'id_embed'),
    ('fuse_memory', 'memory_update'),
    ('update_memory', 'memory_update'),
    ('loss', 'loss'),
    ('cross_entropy', 'loss'),
    ('interpolate', 'resize'),
    ('adam', 'optimizer'),
    ('ema', 'optimizer'),
    ('transpose(jvp', None),        # generic autodiff wrapper: keep going
]

UNMATCHED = 'unmatched'
PHASES = ('forward', 'backward', 'recompute')
MODULE = 'module: '
# the training stages' range names (the engine's are its own spans,
# `tracing.ENGINE_STAGES`): the episode, the loss, the optimizer with the
# EMA (the name carries the component's key, 'adam'), the remat recompute
EPISODE, LOSS, OPTIMIZER, RECOMPUTE = ('episode', 'loss', 'adam + ema',
                                       'recompute')
EVALUATOR = 'evaluator'
# the methods by which the model calls an attention module in place of its
# forward (the bank reads, one probability matrix for several values)
CALL_METHODS = ('bank_read', 'multi_value_call')
_EVALUATE = 'autograd::engine::evaluate_function'


def classify(op_name: str) -> str:
    """The component of a module path or range name (the JAX package's
    train_census.classify)."""
    low = op_name.lower()
    for needle, label in _COMPONENTS:
        if label and needle in low:
            return label
    # fall back to the innermost flax module scope, e.g.
    # jit(..)/while/body/../VOSModel.lstt_forward/... -> lstt_forward
    mods = re.findall(r'VOSModel\.(\w+)', op_name)
    if mods:
        return mods[-1]
    return 'other'


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def _is_range(name: str) -> bool:
    return name.startswith((MODULE, STAGE))


def _label(range_name: str) -> str:
    return range_name.split(': ', 1)[1]


# ---------------------------------------------------------------- ranges
def ranged_modules(model) -> List[Tuple[str, torch.nn.Module]]:
    """The modules `annotate` opens a range around: each module whose
    component differs from its parent's (so every kernel of the model falls
    under the range that names its component), and the Swin encoder's
    window attention with its qkv and proj linears and its MLPs, parts of
    the encoder that PERF.md reads apart."""
    from rmem_ocu_tpu_torch.models.encoders.swin import Mlp, WindowAttention
    out = []
    for path, mod in model.named_modules():
        if not path:
            continue
        parent = path.rsplit('.', 1)[0] if '.' in path else ''
        part = isinstance(mod, (WindowAttention, Mlp)) or (
            isinstance(mod, torch.nn.Linear)
            and path.rsplit('.', 1)[-1] in ('qkv', 'proj')
            and isinstance(model.get_submodule(parent), WindowAttention))
        if part or classify(path) != classify(parent):
            out.append((path, mod))
    return out


def _wrap(obj, name: str, range_name: str, undo: list) -> None:
    """obj.name, on the instance, runs inside a profiler range."""
    had = name in vars(obj)
    fn = getattr(obj, name)

    def ranged(*args, **kwargs):
        with record_function(range_name):
            return fn(*args, **kwargs)
    setattr(obj, name, ranged)
    undo.append(lambda: setattr(obj, name, fn) if had else delattr(obj, name))


@contextmanager
def annotate(model, trainer=None):
    """Profiler ranges for the census while the block runs: the model's
    component roots and Swin parts (forward hooks, and the attention
    modules' `CALL_METHODS`; under remat they run again in the recompute)
    and the trainer's stages (`EPISODE`, `LOSS`, `OPTIMIZER`, and
    `RECOMPUTE` through the checkpoint's context_fn); the engine opens its
    stages' ranges itself. The hooks and wrappers are removed and any range
    left open is closed on exit, also when the block raises."""
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
        if trainer is not None:
            eng = trainer.engine
            _wrap(eng, 'episode_loss', STAGE + EPISODE, undo)
            _wrap(eng, '_frame_loss', STAGE + LOSS, undo)
            _wrap(trainer, '_update', STAGE + OPTIMIZER, undo)
            remat = eng.remat_context
            eng.remat_context = lambda: (nullcontext(),
                                         record_function(STAGE + RECOMPUTE))
            undo.append(lambda: setattr(eng, 'remat_context', remat))
        yield
    finally:
        for h in handles:
            h.remove()
        for fn in reversed(undo):
            fn()
        while open_ranges:
            open_ranges.pop().__exit__(None, None, None)


# ---------------------------------------------------------------- window
class Window:
    """torch.profiler over a window of work on `device`, timed by CUDA
    events on the card and by the host's clock on the CPU. `start()` and
    `stop()` may be called from inside the work (the eval window), or use
    it as a context manager. After `stop()`: `prof` and `window_ms`."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == 'cuda'
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts)
        self.window_ms = None

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
        self.prof.start()
        if self.cuda:
            self._events[0].record()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self._events[1].record()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prof.stop()
        self.window_ms = (self._events[0].elapsed_time(self._events[1])
                          if self.cuda else (t1 - self._t0) * 1e3)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.stop()
        else:
            self.prof.stop()


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them (on the
    CPU: 'cpu, no card')."""
    if torch.device(device).type != 'cuda':
        return 'cpu, no card'
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- census
def _contexts(events) -> Dict[int, tuple]:
    """id(event) -> (evaluate_function event or None, the module ranges
    below it innermost first, the innermost stage): what an event sits
    in, from its ancestors (events come parents first)."""
    ctx = {}
    root = (None, (), None)
    for e in events:
        ef, ranges, stage = (ctx[id(e.cpu_parent)] if e.cpu_parent is not None
                             and id(e.cpu_parent) in ctx else root)
        if e.name.startswith(_EVALUATE):
            ef, ranges = e, ()
        elif _is_range(e.name):
            ranges = (e.name,) + ranges
            if e.name.startswith(STAGE):
                stage = e.name
        ctx[id(e)] = (ef, ranges, stage)
    return ctx


def _place(ctx, seq_map) -> Tuple[str, str]:
    """(component, phase) of work done in `ctx`."""
    ef, ranges, _ = ctx
    if ef is None:
        return (classify(_label(ranges[0])) if ranges else UNMATCHED,
                'forward')
    if ranges:
        return classify(_label(ranges[0])), 'recompute'
    if ef.sequence_nr < 0:
        return UNMATCHED, 'backward'
    return seq_map.get((ef.fwd_thread, ef.sequence_nr), UNMATCHED), 'backward'


def _cpu(evt) -> bool:
    return not str(evt.device_type).endswith(('CUDA', 'PrivateUse1'))


def census_from_profile(prof, window_ms: float, n: int,
                        per: str = 'frame', top: int = 10) -> dict:
    """The census of a finished torch.profiler profile of `n` frames or
    steps (`per`) over a window of `window_ms`; every time and count is
    per frame or step. Raises when a profile of the card holds no kernel:
    a profile that cannot see the device must not pass for an idle one."""
    cuda = ProfilerActivity.CUDA in prof.activities
    events = sorted(prof.events(),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    cpu_events = [e for e in events if _cpu(e)]
    ctx = _contexts(cpu_events)
    seq_map = {}
    for e in cpu_events:
        ef, _, _ = ctx[id(e)]
        if (e.sequence_nr >= 0 and ef is None and not _is_range(e.name)
                and not e.name.startswith('cu')):
            seq_map[(e.thread, e.sequence_nr)] = _place(ctx[id(e)], {})[0]

    # the work items: (name, us, is a launch, ctx, launching op)
    items = []
    if cuda:
        runtime = {e.id: e for e in cpu_events if e.name.startswith('cu')}
        for e in events:
            if _cpu(e) or getattr(e, 'is_user_annotation', False) or \
                    _is_range(e.name):
                continue
            us = e.time_range.end - e.time_range.start
            launch = not e.name.startswith(('Memcpy', 'Memset'))
            call = runtime.get(e.id)
            if call is None:
                items.append((e.name, us, launch, (None, (), None), None))
                continue
            parent = call.cpu_parent
            op = (parent.name if parent is not None
                  and not _is_range(parent.name) else kernel_group(e.name))
            items.append((e.name, us, launch, ctx[id(call)], op))
        if not items:
            raise RuntimeError(
                'the profiler saw no kernel on the card: the device time '
                'cannot be measured, and an empty profile is not an idle '
                'device')
    else:
        for e in cpu_events:
            if not _is_range(e.name):
                items.append((e.name, e.self_cpu_time_total, True,
                              ctx[id(e)], e.name))

    comps = defaultdict(lambda: dict.fromkeys(PHASES, 0.0))
    groups, group_launches = Counter(), Counter()
    by_name, name_count = Counter(), Counter()
    parts, by_op = Counter(), Counter()
    stages = defaultdict(lambda: {'ms': 0.0, 'launches': 0,
                                  'by_op': Counter()})
    busy = kernel = launches = copies = 0.0
    for name, us, launch, c, op in items:
        comp, phase = _place(c, seq_map)
        comps[comp][phase] += us
        busy += us
        group = kernel_group(name)
        groups[group] += us
        by_name[name] += us
        name_count[name] += 1
        # keyed by the top-level stage: 'propagate' for 'propagate/gpm'
        stage = _label(c[2]).split('/')[0] if c[2] else 'none'
        stages[stage]['ms'] += us
        if launch:
            kernel += us
            launches += 1
            group_launches[group] += 1
            by_op[op] += 1
            stages[stage]['launches'] += 1
            stages[stage]['by_op'][op] += 1
        else:
            copies += 1
        if phase != 'backward':
            for key in {re.sub(r'\.\d+(?=\.|$)', '.N', _label(r))
                        for r in c[1] if r.startswith(MODULE)}:
                parts[key] += us

    ms = lambda us: us / 1e3 / n
    per_n = lambda x: x / n
    unmatched = comps.get(UNMATCHED, dict.fromkeys(PHASES, 0.0))
    bwd = sum(v['backward'] for v in comps.values())
    return {
        'device': 'cuda' if cuda else 'cpu',
        'source': ('kernels, memcpy and memset on the card' if cuda else
                   'CPU self time of ops; launches are op dispatches'),
        'per': per, 'n': n,
        'window_ms': window_ms / n,
        'busy_ms': ms(busy),
        'kernel_ms': ms(kernel),
        'copy_ms': ms(busy - kernel),
        'idle_share': max(0.0, 1.0 - busy / 1e3 / window_ms),
        'launches': per_n(launches),
        'copies': per_n(copies),
        'matched_share': (1.0 - sum(unmatched.values()) / busy if busy
                          else 0.0),
        'backward_matched_share': (1.0 - unmatched['backward'] / bwd if bwd
                                   else None),
        'components': {k: {p: ms(t) for p, t in v.items()} for k, v in
                       sorted(comps.items(), key=lambda x: -sum(
                           x[1].values()))},
        'groups': {g: ms(groups[g]) for g, _ in KERNEL_GROUPS},
        'group_launches': {g: per_n(group_launches[g])
                           for g, _ in KERNEL_GROUPS},
        'parts': {k: ms(t) for k, t in parts.most_common()},
        'stages': {s: {'ms': ms(v['ms']), 'launches': per_n(v['launches']),
                       'by_op': {o: per_n(c) for o, c in
                                 v['by_op'].most_common()}}
                   for s, v in stages.items()},
        'by_op': {o: per_n(c) for o, c in by_op.most_common()},
        'top': [{'name': k, 'ms': ms(t), 'launches': per_n(name_count[k])}
                for k, t in by_name.most_common(top)],
    }


def _pct(t: float, total: float) -> str:
    return f'{100 * t / total:.1f}%' if total else '-'


def format_census(c: dict, tag: str, stage_by_stage: bool = False
                  ) -> List[str]:
    """The printed lines of a census dict. On the card: `profile <tag>:
    ... device busy <x> ms/<per>` (tools/ab_main_path.py reads it)."""
    per, busy = c['per'], c['busy_ms']
    if c['device'] == 'cuda':
        busy_s, launch_s = 'device busy', 'kernels'
    else:
        busy_s, launch_s = 'CPU op self time', 'op dispatches'
    lines = [
        f'profile {tag}: {c["window_ms"]:.3f} ms/{per} window, {busy_s} '
        f'{busy:.3f} ms/{per}, idle share {c["idle_share"]:.3f}, '
        f'{c["launches"]:.0f} {launch_s}/{per}'
        + (f' and {c["copies"]:g} memcpy and memset/{per}'
           if c['device'] == 'cuda' else '')
        + f'; by group per {per}: '
        + ', '.join(f'{g} {t:.3f} ms ({_pct(t, busy)})' for g, t in sorted(
            c['groups'].items(), key=lambda x: -x[1]) if t > 0)]
    lines.append(f'profile {tag}: {launch_s} by op per {per}: ' + ', '.join(
        f'{o} {k:g}' for o, k in list(c['by_op'].items())[:12]))
    comps = c['components']
    phases = [p for p in PHASES if any(v[p] for v in comps.values())]
    lines.append(
        f'profile {tag}: by component per {per} ('
        + ' / '.join(phases) + ' ms): ' + ', '.join(
            f'{k} ' + ' / '.join(f'{v[p]:.3f}' for p in phases)
            + f' ({_pct(sum(v.values()), busy)})' for k, v in comps.items())
        + f'; matched share {c["matched_share"]:.4f}')
    if c['parts']:
        lines.append(f'profile {tag}: by part per {per}: ' + ', '.join(
            f'{k} {t:.3f} ms ({_pct(t, busy)})' for k, t in
            c['parts'].items()))
    if stage_by_stage:
        for s, v in c['stages'].items():
            ops = ', '.join(f'{o} {n:g}' for o, n in
                            list(v['by_op'].items())[:12])
            lines.append(f'profile {tag}: stage {s}: {v["ms"]:.3f} ms/{per},'
                         f' {v["launches"]:g} {launch_s}/{per}; by op: {ops}')
    for k in c['top']:
        lines.append(f'  top kernel {tag}: {k["ms"]:.3f} ms/{per}, '
                     f'{k["launches"]:g}/{per}, {k["name"][:90]}')
    return lines
