"""One run of one cell: set-up, the timed window, the traced steps, the
check, the metrics.

Everything that belongs to a cell comes from files, found by name:
`BENCHMARK.json` names the cell's configuration and traffic; the
configuration's file (`configs/`), whose `reference` key names its
reference family (`reference/<family>.py`: the plain model the check
follows, the FLOP count and each kernel's work), the traffic file
(`traffic/`), the cell's limits (`limits/<cell>.json`) and one reader per
per-layer metric (`metrics/<metric>.py`) hold the rest.

Set-up: the model through the package's entry points, its weights drawn
on the device from the seed, the clips' pool staged in pinned memory,
the reference frame, and `fill_frames` steps that fill the bank to
steady state (at gap 5, 45 frames: the reference frame and 8 writes, and
the first eviction), which also warm every shape the window uses.

A step serves one frame of every stream: the frames' host-to-device copy
from the pinned pool, `propagate`, `predict_mask` at the input size,
`update_memory` with that mask, and the masks' copy to the host as uint8;
it ends when the masks are on the host, and the next starts then (a
closed loop). The window runs steps for `seconds`, untraced. With
`trace`, `traced_steps` more steps then run under torch.profiler with the
census's ranges.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import random
import re
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, List

import torch
from torch.autograd.profiler import record_function

from rmembench import census, check, program, trace
from rmembench import traffic as traffic_mod
from rmembench.weights import seeded_weights

GIB = 2 ** 30
# what the harness reaches a reference family through
FAMILY_INTERFACE = ('Reference', 'step_flops', 'kernel_work')


def load_family(config: dict) -> ModuleType:
    """The module `rmembench.reference.<family>` that the configuration's
    `reference` key names; raises where the key, the module or a part of
    the family's interface is missing."""
    family = config.get('reference')
    if not isinstance(family, str) or not re.fullmatch(r'[A-Za-z0-9_]+',
                                                       family):
        raise KeyError(f'configuration {config.get("name")!r}: no '
                       f'"reference" key naming its reference family, '
                       f'the module rmembench/reference/<family>.py')
    module = f'rmembench.reference.{family}'
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ModuleNotFoundError(
            f'configuration {config.get("name")!r} names the reference '
            f'family {family!r}: no module {module} '
            f'(rmembench/reference/{family}.py)', name=module) from None
    missing = [n for n in FAMILY_INTERFACE if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f'{module} is no reference family: it has no '
                             f'{", ".join(missing)}')
    return mod


def load_cell(root: Path, workload: str) -> dict:
    """The cell `workload` of root/BENCHMARK.json with its files read."""
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    cell = cells[workload]
    configs = {c['name']: c for c in spec['configs']}
    config = json.loads((root / configs[cell['config']]['file'])
                        .read_text())

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get('workloads', [workload])]
    return {
        'name': workload,
        'chips': cell['chips'],
        'config': config,
        'family': load_family(config),
        'traffic': traffic_mod.load(root, cell['traffic']),
        'limits': json.loads((root / 'rmembench' / 'limits'
                              / f'{workload}.json').read_text()),
        'end_to_end': mine(spec['end_to_end']),
        'per_layer': mine(spec['per_layer']),
        'root': root,
    }


def checked_streams(n_streams: int, n_checked: int, seed: int) -> List[int]:
    """One stream from each of n_checked contiguous groups, drawn from the
    seed (so that a fault in any half of the batch meets a checked
    stream)."""
    rng = random.Random(seed)
    n = min(n_checked, n_streams)
    bounds = [n_streams * i // n for i in range(n + 1)]
    return [rng.randrange(bounds[i], bounds[i + 1]) for i in range(n)]


class Stepper:
    """The step loop over one engine state, with what the check and the
    metrics read: each step's time, the host time of the calls into the
    engine, and the checked streams' masks and bank frame ids."""

    def __init__(self, eng, state, clips, streams: List[int], device,
                 capacity: int):
        self.eng, self.state, self.clips = eng, state, clips
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        b = clips.pool.shape[1]
        self.size = clips.size
        self.host_masks = torch.empty((b, *self.size), dtype=torch.uint8,
                                      pin_memory=self.cuda)
        cap = state.bank.frame_ids.shape[1]
        self.host_ids = torch.empty((b, cap), dtype=torch.long,
                                    pin_memory=self.cuda)
        self.streams = streams
        self.t = 0
        # the checked streams' masks and bank ids after every frame, in
        # memory allocated and touched here: an allocation of a mask's size
        # inside the window costs more than a millisecond
        self.masks = torch.zeros((capacity, len(streams), *self.size),
                                 dtype=torch.uint8)
        self.bank_ids = torch.zeros((capacity, len(streams), cap),
                                    dtype=torch.long)
        self.bank_ids[0] = state.bank.frame_ids[streams]
        self.step_ms, self.host_ms = [], []

    def grow(self, capacity: int) -> None:
        """Room for at least `capacity` frames in all."""
        more = capacity - len(self.masks)
        if more > 0:
            self.masks = torch.cat([self.masks, torch.zeros(
                (more, *self.masks.shape[1:]), dtype=torch.uint8)])
            self.bank_ids = torch.cat([self.bank_ids, torch.zeros(
                (more, *self.bank_ids.shape[1:]), dtype=torch.long)])

    def step(self, ranges: bool = False) -> None:
        rf = record_function if ranges else nullcontext
        self.t += 1
        eng = self.eng
        t0 = time.perf_counter()
        with rf('bench: h2d'):
            img = self.clips.pool[traffic_mod.ping_pong(
                self.t, self.clips.n_frames)].to(self.device,
                                                 non_blocking=True)
        t1 = time.perf_counter()
        with rf('bench: propagate'):
            logits, self.state = eng.propagate(self.state, img)
        with rf('bench: predict_mask'):
            pred = eng.predict_mask(logits, self.size)
        with rf('bench: update_memory'):
            self.state = eng.update_memory(self.state, pred)
        t2 = time.perf_counter()
        with rf('bench: d2h'):
            self.host_masks.copy_(pred.to(torch.uint8), non_blocking=True)
            self.host_ids.copy_(self.state.bank.frame_ids,
                                non_blocking=True)
            if self.cuda:
                torch.cuda.current_stream(self.device).synchronize()
        t3 = time.perf_counter()
        self.step_ms.append((t3 - t0) * 1e3)
        self.host_ms.append((t2 - t1) * 1e3)
        if self.t >= len(self.masks):
            self.grow(2 * len(self.masks))
        # one contiguous copy a stream (index_select of uint8 takes ~30x
        # as long)
        for j, s in enumerate(self.streams):
            self.masks[self.t, j].copy_(self.host_masks[s])
            self.bank_ids[self.t, j].copy_(self.host_ids[s])


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _device_allocs(device) -> int:
    """cudaMalloc calls the caching allocator has made so far."""
    if torch.device(device).type != 'cuda':
        return 0
    return torch.cuda.memory_stats(device).get('num_device_alloc', 0)


def _step_summary(step_ms: List[float], gap: int, first: int,
                  allocs: int) -> str:
    """One line on the window's step times: where the slow ones fall, and
    the median step of each half of the window."""
    med = statistics.median(step_ms)
    slow = [i for i, t in enumerate(step_ms) if t > 1.5 * med]
    writes = sum((first + 1 + i) % gap == 0 for i in slow)
    half = len(step_ms) // 2
    halves = [statistics.median(step_ms[:half] or step_ms),
              statistics.median(step_ms[half:])]
    return (f'steps: {len(step_ms)}, median {med:.3f} ms (halves '
            f'{halves[0]:.3f}, {halves[1]:.3f}), mean '
            f'{statistics.fmean(step_ms):.3f}, max {max(step_ms):.3f}; '
            f'{len(slow)} over 1.5x the median ({writes} of them writes), '
            f'{sum(step_ms[i] for i in slow):.1f} ms in all; {allocs} '
            f'cudaMalloc calls in the window')


def _host_sample() -> dict:
    """What the host did so far: this process's CPU seconds and involuntary
    context switches, its garbage collections, the machine's CPU ticks
    (all, and stolen by other guests) and the cores' clock."""
    out = {'cpu_s': sum(os.times()[:2]),
           'gc': sum(g['collections'] for g in gc.get_stats())}
    try:
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith('nonvoluntary_ctxt_switches'):
                    out['preempted'] = int(line.split()[1])
        with open('/proc/stat') as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
        out['ticks'], out['steal'] = sum(ticks[:8]), ticks[7]
        with open('/proc/cpuinfo') as f:
            mhz = [float(line.split(':')[1]) for line in f
                   if line.startswith('cpu MHz')]
        out['mhz'] = statistics.fmean(mhz) if mhz else 0.0
    except (OSError, IndexError, ValueError):
        pass
    return out


def _host_change(a: dict, b: dict, window_s: float) -> str:
    """One line on the host in the window (for reading a run's spread)."""
    line = (f'host: {(b["cpu_s"] - a["cpu_s"]) / window_s:.3f} CPU s a '
            f'second, {b["gc"] - a["gc"]} garbage collections')
    if 'preempted' in a and 'preempted' in b:
        line += f', {b["preempted"] - a["preempted"]} times preempted'
    if 'ticks' in a and 'ticks' in b and b['ticks'] > a['ticks']:
        stolen = (b['steal'] - a['steal']) / (b['ticks'] - a['ticks'])
        line += f', {stolen:.4f} of the machine\'s CPU time stolen'
    if b.get('mhz'):
        cores = len(os.sched_getaffinity(0))
        line += f', cores at {b["mhz"]:.0f} MHz; on {cores} cores'
    return line


def load_reader(root: Path, name: str) -> Callable:
    path = root / 'rmembench' / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'rmembench_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        age: Callable[[], float], log=None, control: bool = False) -> dict:
    """One run; returns the result line's object. `age()` gives the
    seconds since the process started. `control` also runs the check's
    float8 control (`rmembench/calibrate.py`; the benchmark's runs do
    not): its readings come back under `control_readings`."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    config, tr = cell['config'], cell['traffic']
    device = torch.device(device)
    cuda = device.type == 'cuda'
    mc = config['model']
    size = traffic_mod.input_size(tr, mc['align_corners'])
    grid = program.grid_of(size, mc['align_corners'])
    b = tr['streams']
    log(f'{cell["name"]}: {config["name"]} at {size[0]}x{size[1]} (grid '
        f'{grid[0]}x{grid[1]}), {b} streams, seed {seed}')

    # ---------------------------------------------------------- set-up
    parts = {'imports': age()}
    tick = time.perf_counter()

    def part(name):
        nonlocal tick
        now = time.perf_counter()
        parts[name] = now - tick
        tick = now
    exp, model = program.build_model(config, device)
    shapes = program.shapes_of(model)
    part('model')
    weights = seeded_weights(shapes, seed, device,
                             program.DTYPES[config['compute_dtype']])
    model.load_state_dict(weights)
    _sync(device)
    part('weights')
    clips = traffic_mod.Clips(tr, size, seed + 1, device)
    streams = checked_streams(b, tr['checked_streams'], seed)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    part('clips')
    eng = program.engine(model, exp, tr['gap'])
    state = eng.init_state(b, grid)
    state = eng.add_reference_frame(
        state, clips.pool[0].to(device), clips.label0,
        torch.full((b,), tr['objects'], dtype=torch.long))
    traced_steps = tr['traced_steps'] if traced else 0
    stepper = Stepper(eng, state, clips, streams, device,
                      tr['fill_frames'] + traced_steps + 1)
    _sync(device)
    part('reference frame')
    for _ in range(tr['fill_frames']):
        stepper.step()
    # room for the window's frames at the fill's fastest step, and more
    stepper.grow(len(stepper.masks) + int(
        1.25 * seconds * 1e3 / min(stepper.step_ms)) + 16)
    _sync(device)
    gc.collect()
    part('fill')
    setup_s = age()
    log('set-up parts, s: ' + ', '.join(f'{k} {v:.2f}'
                                        for k, v in parts.items()))

    # ---------------------------------------------------------- window
    # Python's garbage collector stays on, as in a deployment
    n_fill = len(stepper.step_ms)
    allocs = _device_allocs(device)
    host0 = _host_sample()
    start = time.perf_counter()
    while True:
        stepper.step()
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    host = _host_change(host0, _host_sample(), window_s)
    allocs = _device_allocs(device) - allocs
    n_steps = len(stepper.step_ms) - n_fill
    step_ms = stepper.step_ms[n_fill:]
    host_ms = stepper.host_ms[n_fill:]
    log(_step_summary(step_ms, tr['gap'], n_fill, allocs))
    log(host)

    # ---------------------------------------------------------- traced
    timeline = cen = None
    if traced:
        k = traced_steps
        _sync(device)
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            with census.annotate(model, eng):
                with record_function(trace.WINDOW):
                    t_tr = time.perf_counter()
                    for _ in range(k):
                        stepper.step(ranges=True)
                    _sync(device)
                    traced_s = time.perf_counter() - t_tr
        events = prof.events()
        if cuda:
            timeline = trace.device_timeline(events)
            timeline['window_s'] = traced_s
            cen = census.census(events, k)
        del prof, events
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bank_bytes = program.state_bytes(stepper.state)

    # ---------------------------------------------------------- check
    n = stepper.t + 1
    masks, bank_ids = stepper.masks[:n], stepper.bank_ids[:n]
    del stepper, state, eng, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    family = cell['family']
    readings = check.judge(family, weights, config, tr, clips, streams,
                           masks, bank_ids, device, control=control, log=log)
    correct = check.verdict(readings, cell['limits'])

    # ---------------------------------------------------------- metrics
    run_info = SimpleNamespace(
        config=config, traffic=tr, size=size, grid=grid, streams=b,
        steps_ms=step_ms, host_ms=host_ms, window_s=window_s,
        n_steps=n_steps, census=cen, timeline=timeline,
        bank_bytes=bank_bytes, shapes=shapes,
        flops_per_frame=lambda: family.step_flops(
            shapes, mc, size, mc['former_mem_len'] + mc['latter_mem_len']),
        kernel_work=lambda: family.kernel_work(mc, b, grid))
    metrics = {}
    if traced:
        for m in cell['per_layer']:
            value = load_reader(cell['root'], m['name'])(run_info)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        e2e = {
            'frames_per_s': lambda: b * n_steps / window_s,
            'step_ms_p95': lambda: (statistics.quantiles(step_ms, n=20)[-1]
                                    if len(step_ms) > 1 else step_ms[0]),
            'peak_mem_gib': lambda: memory_peak / GIB,
            'setup_s': lambda: setup_s,
        }
        for m in cell['end_to_end']:
            metrics[m['name']] = {'value': e2e[m['name']](),
                                  'unit': m['unit']}
    result = {
        'correct': correct,
        'attempted': b * n_steps,
        'failed': 0,
        'metrics': metrics,
        'device': {
            'platform': 'gpu' if cuda else 'cpu',
            'kind': (torch.cuda.get_device_name(device) if cuda
                     else 'cpu'),
            'count': 1,
            'memory_peak_bytes': memory_peak,
        },
    }
    if traced and timeline is not None:
        result['device']['busy_s'] = timeline['busy_s']
        result['device']['window_s'] = timeline['window_s']
        result['breakdown'] = {'device_ops': timeline['device_ops'],
                               'idle_gaps': timeline['idle_gaps']}
    result['checks'] = {k: {'value': readings[k],
                            'limit': cell['limits'][k]['limit']}
                        for k in check.NUMBERS}
    if control:
        result['control_readings'] = readings
    log(f'window: {n_steps} steps in {window_s:.3f} s, set-up '
        f'{setup_s:.2f} s, peak {memory_peak / GIB:.3f} GiB')
    return result
