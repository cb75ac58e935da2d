"""The port's profiler census (rmem_ocu_tpu_torch/utils/profiling.py,
tools/census.py) on the CPU, where it counts the CPU self time of ops and
op dispatches in place of kernels: the component labels against the JAX
package's train_census.classify, the frame, eval and training censuses at
small sizes (65x65, T=3, B=1), and the trace reader against the JAX
package's trace_census. The card's case is in test_torch_kernels_cuda.py.
"""
import gzip
import json
import os
import warnings
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function

import tests.torch_threads  # noqa: F401  (one torch thread)
from rmem_ocu_tpu.tools import train_census as jax_train_census
from rmem_ocu_tpu.tools import trace_census as jax_trace_census
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.tools import ab_main_path, census
from rmem_ocu_tpu_torch.utils import profiling, tracing

SIZE = (65, 65)
# DeAOT-T (MobileNetV2, one GPM layer): the components of DeAOT-L with a
# third of its ops, which the CPU profiler records one by one
MODEL = 'deaott'


def _total(c):
    return sum(sum(v.values()) for v in c['components'].values())


def _no_annotation_left(model, *objs):
    for m in model.modules():
        assert not m._forward_hooks and not m._forward_pre_hooks
        assert not set(vars(m)) & set(profiling.CALL_METHODS)
    for obj in objs:
        assert not set(vars(obj)) & {*tracing.ENGINE_STAGES, 'episode_loss',
                                     '_frame_loss', '_update'}


@pytest.mark.parametrize('model', ['r50_deaotl', 'r50_aotl', 'swinb_deaotl'])
def test_classify_matches_jax(model):
    """The port's classify is the JAX train_census's on every module path
    of the port's model and on every range name the census opens."""
    net = build_vos_model(get_config('pre_vost_2', model=model).model,
                          device='meta')
    ranges = ([profiling.MODULE + p for p, _ in
               profiling.ranged_modules(net)]
              + [profiling.STAGE + s for s in tracing.ENGINE_STAGES + (
                  profiling.EPISODE, profiling.LOSS, profiling.OPTIMIZER,
                  profiling.RECOMPUTE, profiling.EVALUATOR)])
    names = [p for p, _ in net.named_modules()] + ranges + [
        n.split(': ', 1)[1] for n in ranges]
    assert len(names) > 200
    for name in names:
        assert profiling.classify(name) == jax_train_census.classify(name), \
            name
    ranged = dict(profiling.ranged_modules(net))
    assert ranged.keys() >= {'encoder', 'LSTT', 'decoder',
                             'patch_wise_id_bank',
                             'LSTT.layers.0.long_term_attn',
                             'LSTT.layers.2.short_term_attn',
                             'LSTT.layers.1.self_attn'}
    if model.startswith('swinb'):
        assert {'encoder.layers.0.blocks.0.attn',
                'encoder.layers.0.blocks.0.attn.qkv',
                'encoder.layers.2.blocks.1.attn.proj',
                'encoder.layers.2.blocks.17.mlp'} <= ranged.keys()


def _record(engine):
    """Every update's mask and the bank's ordered frame ids after it (the
    copies' ops inside the stage's range, as the update's own)."""
    seen = []
    inner = engine.update_memory

    def update_memory(state, mask):
        state = inner(state, mask)
        with record_function(profiling.STAGE + 'update_memory'):
            seen.append((mask.clone(), state.bank.ordered_frame_ids.clone()))
        return state
    engine.update_memory = update_memory
    return seen


def test_frames_census_on_the_cpu():
    """9 frames at write gap 1 (eviction runs): every op falls in a
    component, the components sum to the total, the stages' dispatches sum
    to the frame's, masks and eviction ids equal an unannotated run's, and
    no hook or wrapper is left, also after an exception in the window."""
    n = 9
    runs = []
    for annotated in (False, True):
        engine, state, frames, size = census.build_frames(
            MODEL, size=SIZE, device='cpu', gap=1)
        seen = _record(engine)
        if annotated:
            c, state = census.profile_frames(engine, state, frames, size, n)
        else:
            for i in range(n):
                state = census.frame_step(engine, state, frames[i % 8], size)
        del engine.update_memory
        runs.append(seen)
    assert len(runs[0]) == len(runs[1]) == n
    assert int(runs[1][-1][1].max()) == n           # evicted past 1 + 8
    for (m0, ids0), (m1, ids1) in zip(*runs):
        assert torch.equal(m0, m1) and torch.equal(ids0, ids1)

    assert c['device'] == 'cpu' and c['n'] == n
    assert profiling.UNMATCHED not in c['components']
    assert c['matched_share'] == 1.0
    assert abs(_total(c) - c['busy_ms']) <= 1e-6 * c['busy_ms']
    assert {'encoder', 'long_term_attn', 'short_term_attn', 'self_attn',
            'decode', 'id_embed'} <= set(c['components'])
    stages = c['stages']
    assert set(stages) == {'propagate', 'predict_mask', 'update_memory'}
    assert sum(v['launches'] for v in stages.values()) == c['launches']
    assert sum(c['by_op'].values()) == c['launches']
    assert c['parts']['LSTT.layers.N.long_term_attn'] > 0
    lines = profiling.format_census(c, 'cpu', stage_by_stage=True)
    assert lines[0].startswith('profile cpu: ') and len(lines) > 6
    # the line tools/ab_main_path.py reads from a census of the card
    line = profiling.format_census(dict(c, device='cuda'),
                                   f'{MODEL} streams=1')[0]
    assert ab_main_path.BUSY.search(line).groups() == (
        MODEL, '1', f'{c["busy_ms"]:.3f}')

    _no_annotation_left(engine.model, engine)
    bad = torch.zeros(1, *SIZE, 2)                 # 2 channels: conv raises
    with pytest.raises(RuntimeError):
        with profiling.annotate(engine.model):
            engine.propagate(state, bad)
    _no_annotation_left(engine.model, engine)


def test_stage_times_and_eval_census_on_the_cpu(tmp_path):
    engine, state, frames, size = census.build_frames(MODEL, size=SIZE,
                                                      device='cpu')
    state = census.fill_bank(engine, state, frames, size)
    assert int(state.bank.length[0]) == 9 and state.mem_gap == 5
    times = census.stage_times(engine, state, frames, size, reps=2,
                               warmup=1)
    assert list(times) == list(census.STAGE_LABELS)
    assert all(t['median_ms'] > 0 for t in times.values())

    from rmem_ocu_tpu_torch.data.eval_datasets import SyntheticSequence
    from rmem_ocu_tpu_torch.eval.evaluator import Evaluator
    ev = Evaluator(engine.model, engine.exp, str(tmp_path), write=False)
    seq = SyntheticSequence('s', num_frames=5, size=SIZE, obj_num=3,
                            multi_scale=(1.0, 1.3), flip=True)
    c = census.profile_eval(ev, 's', seq, first=1, n=3)
    assert profiling.UNMATCHED not in c['components']
    assert {'evaluator', 'propagate', 'update_memory'} <= set(c['stages'])
    assert c['launches'] > 0
    _no_annotation_left(ev.model, ev.engine)
    assert 'frame' not in vars(seq)


def _trainer(remat):
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    exp = replace(get_config('pre_vost_2', model=MODEL,
                             data_seq_len=3, train_amp=True),
                  train_remat_policy=remat)
    trainer = Trainer(build_vos_model(exp.model, device='cpu', seed=0,
                                      exp=exp), exp)
    return trainer, trainer.init_state()


def test_train_census_on_the_cpu():
    """bf16 AMP, remat 'full': the backward's op time lands on named components, the
    model's parts, the loss and the optimizer all count, the recompute is
    apart, and the loss is bitwise the unannotated step's; remat 'none'
    has no recompute."""
    batch = census.train_batch(1, 3, SIZE[0], 'cpu')
    trainer, state = _trainer('full')
    _, plain = trainer.train_step(state, batch,
                                  torch.Generator().manual_seed(7))
    trainer, state = _trainer('full')
    c, _, metrics = census.profile_train_step(
        trainer, state, batch, torch.Generator().manual_seed(7))
    assert torch.equal(metrics['loss'], plain['loss'])
    _no_annotation_left(trainer.model, trainer, trainer.engine)
    assert trainer.engine.remat_context is \
        torch.utils.checkpoint.noop_context_fn

    comps = c['components']
    assert c['backward_matched_share'] >= 0.9
    assert abs(_total(c) - c['busy_ms']) <= 1e-6 * c['busy_ms']
    for name in ('encoder', 'long_term_attn', 'short_term_attn',
                 'self_attn', 'decode', 'loss', 'optimizer'):
        assert sum(comps[name].values()) > 0, name
    for name in ('encoder', 'long_term_attn', 'decode'):
        assert comps[name]['backward'] > 0 and comps[name]['recompute'] > 0
    assert sum(v['recompute'] for v in comps.values()) > 0
    assert 'recompute' in c['stages'] and 'adam + ema' in c['stages']

    trainer, state = _trainer('none')
    c, _, _ = census.profile_train_step(trainer, state, batch,
                                        torch.Generator().manual_seed(7))
    assert sum(v['recompute'] for v in c['components'].values()) == 0
    assert c['backward_matched_share'] >= 0.9


def _write(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'wt') as f:
        json.dump({'traceEvents': events}, f)


def test_trace_census(tmp_path, capsys):
    """Kernel totals equal the sum of their durations, --steps divides,
    memcpy and memset stay apart, and the file is the one the JAX
    trace_census picks; a trace of a CPU profile sums its ops' self
    times."""
    rng = np.random.RandomState(0)
    kernels = [{'ph': 'X', 'cat': 'kernel', 'name': name, 'pid': 0,
                'tid': 7, 'ts': float(i), 'dur': float(d)}
               for i, (name, d) in enumerate(zip(
                   ['memory_read_wide', 'local_attn_tc', 'nvjet_gemm',
                    'elementwise'] * 5, rng.randint(1, 100, 20)))]
    copies = [{'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD',
               'pid': 0, 'tid': 7, 'ts': 50.0, 'dur': 3.0}]
    cpu = [{'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'pid': 1,
            'tid': 1, 'ts': 0.0, 'dur': 500.0}]
    root = tmp_path / 'prof'
    _write(str(root / 'plugins/profile/2024_01_01/a.trace.json.gz'), [])
    _write(str(root / 'plugins/profile/2024_01_02/b.trace.json'),
           kernels + copies + cpu)
    _write(str(root / 'old.trace.json'), [])
    path, data = census.load_trace_events(str(root))
    assert path == jax_trace_census.load_trace_events(str(root))[0]
    assert path.endswith('b.trace.json')
    want = sum(k['dur'] for k in kernels)
    for steps in (1, 4):
        c = census.trace_census(data, steps=steps)
        assert c['device'] == 'cuda'
        assert c['kernel_ms'] == pytest.approx(want / 1e3 / steps, rel=1e-12)
        assert c['copy_ms'] == pytest.approx(3e-3 / steps, rel=1e-12)
        assert c['launches'] == 20 / steps
        assert c['groups']['B1 memory_read'] == pytest.approx(sum(
            k['dur'] for k in kernels[::4]) / 1e3 / steps, rel=1e-12)
    with pytest.raises(RuntimeError):
        census.trace_census({'traceEvents': copies[:0] + [dict(
            cpu[0], cat='cuda_runtime')]})

    # a CPU profile's export, through the CLI
    prof_dir = tmp_path / 'cpu'
    window = profiling.Window('cpu')
    x = torch.randn(64, 64)
    with window:
        for _ in range(3):
            (x @ x).relu().sum()
    census._export(window, str(prof_dir), 'cpu')
    exported = json.load(open(census.load_trace_events(str(prof_dir))[0]))
    ops = [e for e in exported['traceEvents'] if e.get('cat') == 'cpu_op']
    roots = [e for e in ops if not any(
        o is not e and o['tid'] == e['tid'] and o['ts'] <= e['ts']
        and e['ts'] + e['dur'] <= o['ts'] + o['dur']
        and (o['ts'], -o['dur']) < (e['ts'], -e['dur']) for o in ops)]
    assert len(roots) >= 9
    assert census.main(['trace', str(prof_dir), '--steps', '3',
                        '--device', 'cpu']) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['device'] == 'cpu' and out['card'] == 'cpu, no card'
    assert out['total_ms'] == pytest.approx(
        sum(e['dur'] for e in roots) / 1e3 / 3, rel=1e-9)


def test_census_raises_on_a_card_profile_without_kernels():
    """A profile asked to trace the card that saw no kernel (CPU work only;
    without a card CUDA profiling is off) raises rather than report an
    idle device."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # no card: CUDA profiling off
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.randn(8).sum()
    with pytest.raises(RuntimeError, match='no kernel'):
        profiling.census_from_profile(prof, 1.0, 1)


@pytest.mark.parametrize('argv', [
    ['frames', '--size', '65', '65'], ['stages'], ['train'], ['eval'],
    ['trace', '.']])
def test_census_needs_the_card_unless_asked(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        census.main(argv)
