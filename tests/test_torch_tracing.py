"""The program's own spans and counters (rmem_ocu_tpu_torch/utils/tracing.py)
on the CPU, on DeAOT-T at 65x65 with a bank of 1 + 1 frames written every
frame, so that the second write evicts: nothing recorded without a
profiler, the engine's spans nested with their steps and counts under
one, the census's placement of every op unmoved by the sub-stage spans,
and the benchmark's readers of them on a synthetic run."""
from types import SimpleNamespace

import pytest
import torch

import tests.torch_threads  # noqa: F401  (one torch thread)
from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
from rmem_ocu_tpu_torch.utils import profiling, tracing
from rmembench import census as bench_census
from rmembench import harness
from rmembench.testutil import ROOT

SIZE, GRID, B = 65, (5, 5), 2
SPANS = ('propagate', 'propagate/encode', 'propagate/gpm',
         'propagate/decode', 'predict_mask', 'update_memory',
         'update_memory/fuse', 'update_memory/short_push',
         'update_memory/bank_append', 'update_memory/bank_score',
         'update_memory/bank_evict')


def _step(eng, state, img):
    logits, state = eng.propagate(state, img)
    return eng.update_memory(state, eng.predict_mask(logits, (SIZE, SIZE)))


@pytest.fixture(scope='module')
def run():
    """The engine after its reference frame, then two profiled steps under
    the benchmark's census ranges: a write under budget, then a write that
    evicts in every stream."""
    exp = get_config('pre_vost_2', model='deaott', latter_mem_len=1)
    eng = InferEngine(build_vos_model(exp.model, device='cpu'), exp,
                      long_term_mem_gap=1)
    gen = torch.Generator().manual_seed(0)
    img = torch.randn(B, SIZE, SIZE, 3, generator=gen)
    state = eng.init_state(B, GRID)
    state = eng.add_reference_frame(
        state, img, torch.randint(0, 3, (B, SIZE, SIZE), generator=gen),
        torch.full((B,), 2))
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with bench_census.annotate(eng.model, eng):
            for _ in range(2):
                state = _step(eng, state, img)
    events = sorted(prof.events(), key=lambda e: (e.time_range.start,
                                                  -e.time_range.end))
    return SimpleNamespace(
        eng=eng, state=state, img=img, prof=prof, spans=tracing.spans(),
        events=[e for e in events if bench_census.is_cpu(e)])


def test_without_a_profiler_nothing_is_recorded_and_ints_are_counted(run):
    tracing.clear()
    run.state = _step(run.eng, run.state, run.img)
    assert tracing.spans() == []
    assert tracing.counters() == {'bank.writes': B}


def test_counts_land_on_the_innermost_recording_span():
    """An int is counted always, and on the innermost recording span; a
    tensor only on that span, summed when read."""
    tracing.clear()
    tracing.count('streams', torch.tensor([True, False]))
    tracing.count('streams', 3)
    assert tracing.counters() == {'streams': 3}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span('outer') as outer:
            tracing.count('streams', torch.tensor([True, True]))
            with tracing.span('inner') as inner:
                tracing.count('streams', 2)
                tracing.count('streams', torch.tensor([True, False]))
    assert tracing.counters() == {'streams': 5}
    assert outer.counted('streams') == 2 and inner.counted('streams') == 3
    assert inner.parent is outer and outer.counted('other') == 0


def test_a_profiled_step_records_the_stages_nested_with_step_and_counts(run):
    labels = [s.label for s in run.spans]
    assert labels == list(SPANS) * 2
    for i, step in enumerate(run.spans[::len(SPANS)]):
        spans = run.spans[i * len(SPANS):(i + 1) * len(SPANS)]
        by = {s.label: s for s in spans}
        for s in spans:
            top = s.label.split('/')[0]
            assert s.parent is (None if s.label == top else by[top])
            assert s.start_ns <= s.end_ns
            assert s.step == (None if top == 'predict_mask'
                              else step.step)
        assert by['update_memory/bank_append'].counted('bank.writes') == B
        # the first write fills the bank to its budget, the second evicts
        assert by['update_memory/bank_evict'].counted('bank.evictions') == (
            B * i)
    # frame 0 is the reference frame
    assert [s.step for s in run.spans[::len(SPANS)]] == [1, 2]


def _drop_sub_stages(events):
    """Stand-ins of the profile's CPU events with every sub-stage range
    (a span label holding '/') taken out of the tree."""
    dropped = lambda e: (e.name.startswith(tracing.STAGE)
                         and '/' in e.name)
    keep = [e for e in events if not dropped(e)]
    stand = {id(e): SimpleNamespace(name=e.name, cpu_parent=None)
             for e in keep}
    for e in keep:
        p = e.cpu_parent
        while p is not None and dropped(p):
            p = p.cpu_parent
        stand[id(e)].cpu_parent = None if p is None else stand[id(p)]
    return [stand[id(e)] for e in keep], keep


def _bench_place(events):
    ctx = bench_census._contexts(events)
    return [bench_census.classify(bench_census._label(ctx[id(e)][0]))
            if ctx[id(e)] else bench_census.UNMATCHED for e in events]


def _port_place(events):
    ctx = profiling._contexts(events)
    return [profiling._place(ctx[id(e)], {})[0] for e in events]


def test_sub_stage_spans_move_no_op_to_another_component(run):
    """The naming rule: under the benchmark's frozen census and the port's,
    each CPU op lands in the same component with the sub-stage ranges as
    without them, and every sub-stage label classifies as its stage."""
    for label in SPANS:
        for classify in (bench_census.classify, profiling.classify):
            assert classify(label) == classify(label.split('/')[0]), label
    names = {e.name for e in run.events}
    assert {tracing.STAGE + s for s in SPANS} <= names
    stand, kept = _drop_sub_stages(run.events)
    ops = [i for i, e in enumerate(kept)
           if not e.name.startswith((tracing.STAGE, profiling.MODULE))]
    assert len(ops) > 1000
    for place in (_bench_place, _port_place):
        at = dict(zip(map(id, run.events), place(run.events)))
        without = place(stand)
        assert [at[id(kept[i])] for i in ops] == [without[i] for i in ops]

    # the port's census of the profile: op self time by those components
    c = profiling.census_from_profile(run.prof, 1.0, 2)
    without, want = _port_place(stand), {}
    for i in ops:
        want[without[i]] = (want.get(without[i], 0.0)
                            + kept[i].self_cpu_time_total)
    assert {k: v['forward'] for k, v in c['components'].items()} == \
        pytest.approx({k: v / 2e3 for k, v in want.items()})
    assert set(c['stages']) == {'propagate', 'predict_mask',
                                'update_memory'}


def _synthetic():
    """An earlier run's step (long spans, three evictions), then two traced
    steps: each encodes 3 ms, runs the GPM 5 ms and decodes 1 ms; the
    second writes, scores and evicts 0.5 ms each and evicts 2 of 3
    streams."""
    spans = []

    def add(label, t0, t1, parent=None, **counts):
        s = tracing.Span(label, int(t0 * 1e6), int(t1 * 1e6), parent,
                         counts={k.replace('_', '.'): [v]
                                 for k, v in counts.items()})
        spans.append(s)
        return s
    for t, writes, ms, evicted in ((0, True, 50, 3), (100, False, 0, 0),
                                   (200, True, 0.5,
                                    torch.tensor([True, False, True]))):
        top = add('propagate', t, t + 10)
        add('propagate/encode', t, t + 3, top)
        add('propagate/gpm', t + 3, t + 8, top)
        add('propagate/decode', t + 8, t + 9, top)
        add('predict_mask', t + 10, t + 11)
        up = add('update_memory', t + 11, t + 12 + 3 * ms)
        if writes:
            add('update_memory/bank_append', t + 11, t + 11 + ms, up,
                bank_writes=3)
            add('update_memory/bank_score', t + 11 + ms, t + 11 + 2 * ms, up)
            add('update_memory/bank_evict', t + 11 + 2 * ms, t + 11 + 3 * ms,
                up, bank_evictions=evicted)
    return spans


@pytest.mark.parametrize('name,want', [
    ('encoder.host_ms', 3.0), ('gpm.host_ms', 5.0), ('bank.host_ms', 0.75),
    ('bank.writes', 1.5), ('bank.evictions', 1.0)])
def test_span_readers_on_a_synthetic_run(name, want, monkeypatch):
    read = harness.load_reader(ROOT, name)
    run = SimpleNamespace(traffic={'traced_steps': 2})
    monkeypatch.setattr(tracing, 'spans', _synthetic)
    assert read(run) == pytest.approx(want)
    monkeypatch.setattr(tracing, 'spans', list)
    assert read(run) is None
