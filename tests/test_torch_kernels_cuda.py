"""CUDA kernels B1, B2 and B3 of the PyTorch port against their plain PyTorch
versions on the card, at small shapes and at the edges of the kernels'
tilings (chip_smoke.py does the same at the main-path shapes). Every test
needs a CUDA device and skips without one.
This file imports no JAX, so the card's machine runs it on its own:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from rmem_ocu_tpu_torch.ops.kernels.local_attn import (
    local_window_attention, local_window_attention_plain)
from rmem_ocu_tpu_torch.ops.kernels.memory_read import (
    memory_read_fused, memory_read_fused_plain)
from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import (
    memory_read_attention, memory_read_attention_plain, memory_read_multihead,
    memory_read_multihead_plain)


def _b1_inputs(heads, n_banks, with_pe, seed=0):
    """Ragged HWk = 36, a dead slot in the middle of each batch row and a
    free last slot (as in test_torch_kernels.py)."""
    rng = np.random.RandomState(seed)
    b, hwq, hwk, t_cap, d, dv = 2, 40, 36, 6, 16, 24
    q = rng.randn(b, hwq, heads * d).astype(np.float32)
    k = rng.randn(b, t_cap, hwk, heads * d).astype(np.float32) * 0.5
    vs = tuple(rng.randn(b, t_cap, hwk, heads * dv).astype(np.float32)
               for _ in range(n_banks))
    valid = np.ones((b, t_cap), bool)
    valid[0, 2] = valid[1, 3] = False
    valid[:, -1] = False
    pe = (rng.randn(1, t_cap, heads * d).astype(np.float32) * 0.3
          if with_pe else None)
    return q, k, vs, valid, pe, d ** -0.5


def _b3_inputs(heads, seed=0):
    """Storage-layout B3 inputs: ragged HWk = 36, a dead slot in the middle
    of each batch row and a free last slot; V and ID_V halves of 48
    channels each, so that heads in (2, 4) lie in one half and 3 heads
    straddle them."""
    rng = np.random.RandomState(seed)
    b, hwq, hwk, t_cap, d, e = 2, 40, 36, 6, 16, 48
    q = rng.randn(b, hwq, heads * d).astype(np.float32)
    k = rng.randn(b, t_cap, hwk, heads * d).astype(np.float32) * 0.5
    v = rng.randn(b, t_cap, hwk, e).astype(np.float32)
    id_v = rng.randn(b, t_cap, hwk, e).astype(np.float32)
    valid = np.ones((b, t_cap), bool)
    valid[0, 2] = valid[1, 3] = False
    valid[:, -1] = False
    return q, k, v, id_v, valid, d ** -0.5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return torch.device('cuda')


def _assert_close(got, want, tol):
    """tol None: bf16 rounding somewhere in the computation, so two bf16
    ulps relative (2^-7) plus 2% of the output's RMS absolute, far below
    the shift of a dropped slot or key; else an absolute and relative tol
    for f32 sums in another order."""
    got, want = got.float(), want.float()
    if tol is None:
        rms = float(want.square().mean().sqrt())
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=0.02 * rms)
    else:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,precise,tol', [
    (torch.float32, True, 1e-4), (torch.float32, False, None),
    (torch.bfloat16, False, None)], ids=['f32', 'f32_bf16ops', 'bf16'])
def test_memory_read_kernel_matches_plain(dtype, precise, tol):
    dev = _cuda()
    for heads, n_banks, with_pe in [(1, 2, True), (2, 1, False)]:
        q, k, vs, valid, pe, scale = _b1_inputs(heads, n_banks, with_pe)
        t = lambda x: torch.from_numpy(x).to(dev, dtype)
        args = (t(q), t(k), tuple(t(v) for v in vs),
                torch.from_numpy(valid).to(dev), heads, scale)
        kw = dict(mem_pe=None if pe is None else t(pe), precise=precise)
        before = memory_read_fused.launches
        got, got_mass = memory_read_fused(*args, **kw)
        want, want_mass = memory_read_fused_plain(*args, **kw)
        # the bf16 read is two launches: the split read and its combine
        assert memory_read_fused.launches == before + (1 if precise else 2)
        for g, w in zip(got, want):
            _assert_close(g, w, tol)
        torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32_bf16ops', 'bf16'])
def test_memory_read_kernel_multihead_one_bank(dtype):
    """B1 as the AOT long-term read calls it: 8 heads by channel slicing of
    one bank, with the temporal PE."""
    dev = _cuda()
    q, k, vs, valid, pe, scale = _b1_inputs(8, 1, True, seed=3)
    t = lambda x: torch.from_numpy(x).to(dev, dtype)
    args = (t(q), t(k), (t(vs[0]),), torch.from_numpy(valid).to(dev), 8,
            scale)
    before = memory_read_fused.launches
    (got,), got_mass = memory_read_fused(*args, mem_pe=t(pe))
    (want,), want_mass = memory_read_fused_plain(*args, mem_pe=t(pe))
    assert memory_read_fused.launches == before + 2
    _assert_close(got, want, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32_bf16ops', 'bf16'])
@pytest.mark.parametrize('heads,two_banks', [(2, True), (4, True),
                                             (3, False), (2, False)])
def test_memory_read_attention_kernel_matches_plain(heads, two_banks, dtype):
    """B3 on the storage layout (heads read by stride; V||ID_V as two banks
    or concatenated) and on the head-folded layout."""
    dev = _cuda()
    q, k, v, id_v, valid, scale = _b3_inputs(heads)
    t = lambda x: torch.from_numpy(x).to(dev, dtype)
    v_bank = ((t(v), t(id_v)) if two_banks
              else torch.cat([t(v), t(id_v)], dim=-1))
    args = (t(q), t(k), v_bank, torch.from_numpy(valid).to(dev), heads, scale)
    before = memory_read_attention.launches
    got, got_mass = memory_read_multihead(*args)
    assert memory_read_attention.launches == before + 2
    want, want_mass = memory_read_multihead_plain(*args)
    assert got.dtype == torch.float32
    _assert_close(got, want, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)

    # the folded layout: one head per leading row
    b, hwq, _ = q.shape
    d, dv = q.shape[-1] // heads, 2 * v.shape[-1] // heads
    cat = torch.cat([t(v), t(id_v)], dim=-1)
    fold = lambda x, n: x.reshape(*x.shape[:-1], heads, n).movedim(
        -2, 1).reshape(b * heads, *x.shape[1:-1], n).contiguous()
    folded = (fold(t(q) * scale, d), fold(t(k), d), fold(cat, dv),
              torch.from_numpy(valid).to(dev).repeat_interleave(heads, dim=0))
    got, got_mass = memory_read_attention(*folded)
    assert memory_read_attention.launches == before + 4
    want, want_mass = memory_read_attention_plain(*folded)
    _assert_close(got, want, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match='precise'):
        memory_read_attention(*folded, precise=True)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, None)],
                         ids=['f32', 'bf16'])
def test_local_attention_kernel_matches_plain(dtype, tol):
    dev = _cuda()
    rng = np.random.RandomState(5)
    for h, w in [(6, 6), (11, 14), (23, 40)]:
        b, d, e, md = 2, 32, 48, 7
        t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
        args = (t(rng.randn(b, h * w, d) * d ** -0.5),
                t(rng.randn(b, h * w, d)), t(rng.randn(b, h * w, e)),
                torch.from_numpy(rng.randn(b, h * w, (2 * md + 1) ** 2)
                                 .astype(np.float32)).to(dev),
                (h, w), md, dtype == torch.float32)
        before = local_window_attention.launches
        got = local_window_attention(*args)
        assert local_window_attention.launches == before + 1
        _assert_close(got, local_window_attention_plain(*args), tol)


def _dead_slots(t_cap, pattern):
    """valid [t_cap] with the dead slots of `pattern`."""
    valid = np.ones(t_cap, bool)
    if pattern == 'first':
        valid[0] = False
    elif pattern == 'middle':
        valid[t_cap // 2] = False
    elif pattern == 'last':
        valid[-1] = False
    elif pattern == 'single':      # one live slot, in the middle
        valid[:] = False
        valid[t_cap // 2] = True
    elif pattern == 'alternate':
        valid[1::2] = False
    return valid


# heads, D, Dv, value banks, T_cap, HWk, dead slots. HWq = 70 (two query
# tiles, the second ragged); HWk off the 64-key tile except at 64.
B1_EDGES = [
    (1, 128, 64, 2, 4, 100, 'first'),
    (1, 64, 40, 2, 3, 64, 'last'),
    (1, 32, 512, 1, 2, 70, 'none'),      # two 512-column blocks
    (2, 16, 24, 1, 5, 70, 'middle'),
    (2, 64, 16, 1, 32, 20, 'single'),    # T_cap 32, one live slot
    (8, 32, 32, 1, 6, 130, 'middle'),    # several heads per block
    (8, 16, 16, 1, 1, 36, 'none'),       # T_cap 1
    (4, 32, 8, 1, 32, 65, 'alternate'),
    (8, 64, 32, 1, 3, 40, 'first'),      # D 64: one head per block
]


@pytest.mark.cuda
@pytest.mark.parametrize('heads,d,dv,n_banks,t_cap,hwk,dead', B1_EDGES)
def test_memory_read_kernel_tiling_edges(heads, d, dv, n_banks, t_cap, hwk,
                                         dead):
    dev = _cuda()
    rng = np.random.RandomState(heads * 1000 + d + t_cap)
    b, hwq = 2, 70
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    q = t(rng.randn(b, hwq, heads * d))
    k = t(rng.randn(b, t_cap, hwk, heads * d) * 0.5)
    vs = tuple(t(rng.randn(b, t_cap, hwk, heads * dv))
               for _ in range(n_banks))
    valid = np.stack([_dead_slots(t_cap, dead), _dead_slots(t_cap, 'none')])
    valid = torch.from_numpy(valid).to(dev)
    pe = t(rng.randn(1, t_cap, heads * d) * 0.3)
    args = (q, k, vs, valid, heads, d ** -0.5)
    got, got_mass = memory_read_fused(*args, mem_pe=pe)
    want, want_mass = memory_read_fused_plain(*args, mem_pe=pe)
    for g, w in zip(got, want):
        _assert_close(g, w, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


# heads, D, per-bank width of V and ID_V, two banks (else concatenated)
B3_EDGES = [
    (2, 128, 256, True),     # each head one bank, 256 columns
    (2, 64, 48, True),       # each head one bank, 48 columns
    (8, 16, 64, True),       # several heads per block, over two banks
    (2, 32, 40, False),
    (8, 32, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize('heads,d,e,two_banks', B3_EDGES)
def test_memory_read_attention_kernel_tiling_edges(heads, d, e, two_banks):
    dev = _cuda()
    rng = np.random.RandomState(heads * 100 + d + e)
    b, hwq, hwk, t_cap = 2, 70, 100, 5
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    q = t(rng.randn(b, hwq, heads * d))
    k = t(rng.randn(b, t_cap, hwk, heads * d) * 0.5)
    v, id_v = (t(rng.randn(b, t_cap, hwk, e)) for _ in range(2))
    valid = torch.from_numpy(np.stack([_dead_slots(t_cap, 'first'),
                                       _dead_slots(t_cap, 'alternate')]))
    v_bank = (v, id_v) if two_banks else torch.cat([v, id_v], dim=-1)
    args = (q, k, v_bank, valid.to(dev), heads, d ** -0.5)
    got, got_mass = memory_read_multihead(*args)
    want, want_mass = memory_read_multihead_plain(*args)
    _assert_close(got, want, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


# grid (h, w), max_dis, D, E: widths off the 16-column patch, heights
# below its 4 rows, windows smaller than 15x15, value widths off 128
B2_EDGES = [
    ((3, 20), 7, 32, 48),
    ((2, 3), 2, 16, 24),
    ((5, 17), 3, 64, 200),
    ((9, 33), 5, 128, 136),
    ((23, 40), 7, 128, 1024),
]


@pytest.mark.cuda
@pytest.mark.parametrize('size_2d,md,d,e', B2_EDGES)
def test_local_attention_kernel_tiling_edges(size_2d, md, d, e):
    dev = _cuda()
    rng = np.random.RandomState(size_2d[0] * 100 + size_2d[1] + md)
    h, w = size_2d
    b = 2
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    args = (t(rng.randn(b, h * w, d) * d ** -0.5), t(rng.randn(b, h * w, d)),
            t(rng.randn(b, h * w, e)),
            torch.from_numpy(rng.randn(b, h * w, (2 * md + 1) ** 2)
                             .astype(np.float32)).to(dev), (h, w), md, False)
    got = local_window_attention(*args)
    _assert_close(got, local_window_attention_plain(*args), None)


# The encoder grids of the eval protocol at the default test_max_size of
# 1040: a 720p or 1080p frame becomes 577x1041 (37x66 tokens) and, at
# scale 1.3, 753x1345 (48x85); more than 10 objects make batch 2.
EVAL_GRIDS = [((37, 66), 1), ((37, 66), 2), ((48, 85), 1), ((48, 85), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize('size_2d,b', EVAL_GRIDS)
def test_memory_read_kernel_at_eval_grids(size_2d, b):
    """B1 as the DeAOT read calls it at eval: one head of 128, V and ID_V
    of 512 each, T_cap 10 with a dead slot, the temporal PE."""
    dev = _cuda()
    rng = np.random.RandomState(size_2d[0] + b)
    hw, t_cap, d = size_2d[0] * size_2d[1], 10, 128
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    q = t(rng.randn(b, hw, d))
    k = t(rng.randn(b, t_cap, hw, d))
    vs = tuple(t(rng.randn(b, t_cap, hw, 512)) for _ in range(2))
    valid = torch.from_numpy(np.stack([_dead_slots(t_cap, 'middle')] * b))
    pe = t(rng.randn(1, t_cap, d) * 0.05)
    args = (q, k, vs, valid.to(dev), 1, d ** -0.5)
    got, got_mass = memory_read_fused(*args, mem_pe=pe)
    want, want_mass = memory_read_fused_plain(*args, mem_pe=pe)
    for g, w in zip(got, want):
        _assert_close(g, w, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('size_2d,b', EVAL_GRIDS)
def test_local_attention_kernel_at_eval_grids(size_2d, b):
    """B2 as the DeAOT short-term read calls it: D=128, E=1024 (V||ID_V),
    15x15 windows; both eval grids are ragged against the 4x16 patch."""
    dev = _cuda()
    rng = np.random.RandomState(size_2d[1] + b)
    h, w = size_2d
    d, e, md = 128, 1024, 7
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    args = (t(rng.randn(b, h * w, d) * d ** -0.5), t(rng.randn(b, h * w, d)),
            t(rng.randn(b, h * w, e)),
            torch.from_numpy(rng.randn(b, h * w, (2 * md + 1) ** 2)
                             .astype(np.float32)).to(dev), (h, w), md, False)
    got = local_window_attention(*args)
    _assert_close(got, local_window_attention_plain(*args), None)


# The Swin models' grid: 352x624 inputs with align_corners=False make 22x39
# tokens (858), a ragged last key tile and query tile; 1 and 8 streams.
SWIN_GRID = (22, 39)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 8])
@pytest.mark.parametrize('heads,d,dvs', [(1, 128, (512, 512)),
                                         (8, 32, (256,))],
                         ids=['deaot_1head', 'aot_8heads'])
def test_memory_read_kernel_at_swin_grid(heads, d, dvs, b):
    """B1 as swinb_deaotl (one head of 128, V and ID_V of 512 each) and
    swinb_aotl (8 heads of 32, one bank) call it: T_cap 10 with a dead
    slot, the temporal PE."""
    dev = _cuda()
    rng = np.random.RandomState(heads + b)
    hw, t_cap = SWIN_GRID[0] * SWIN_GRID[1], 10
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    q = t(rng.randn(b, hw, heads * d))
    k = t(rng.randn(b, t_cap, hw, heads * d))
    vs = tuple(t(rng.randn(b, t_cap, hw, dv)) for dv in dvs)
    valid = torch.from_numpy(np.stack([_dead_slots(t_cap, 'middle')] * b))
    pe = t(rng.randn(1, t_cap, heads * d) * 0.05)
    args = (q, k, vs, valid.to(dev), heads, d ** -0.5)
    got, got_mass = memory_read_fused(*args, mem_pe=pe)
    want, want_mass = memory_read_fused_plain(*args, mem_pe=pe)
    for g, w in zip(got, want):
        _assert_close(g, w, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 8])
def test_local_attention_kernel_at_swin_grid(b):
    """B2 as swinb_deaotl calls it: D=128, E=1024 (V||ID_V), 15x15 windows
    on 22x39, ragged against the 4x16 patch in both directions."""
    dev = _cuda()
    rng = np.random.RandomState(39 + b)
    (h, w), d, e, md = SWIN_GRID, 128, 1024, 7
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    args = (t(rng.randn(b, h * w, d) * d ** -0.5), t(rng.randn(b, h * w, d)),
            t(rng.randn(b, h * w, e)),
            torch.from_numpy(rng.randn(b, h * w, (2 * md + 1) ** 2)
                             .astype(np.float32)).to(dev), (h, w), md, False)
    got = local_window_attention(*args)
    _assert_close(got, local_window_attention_plain(*args), None)


@pytest.mark.cuda
@pytest.mark.parametrize('heads', [1, 2])
def test_training_mode_reads_densely_on_the_card(heads):
    """Fault C1: a GPM block in train() mode on the card launches no
    kernel and gives outputs with a grad_fn, whose gradients reach its
    parameters and inputs; in eval mode under no_grad the same block
    launches B1 and B2 (one head) or B3 (two)."""
    from rmem_ocu_tpu_torch.models.gpm import GPMBlock
    from rmem_ocu_tpu_torch.models.vos_model import zero_dropout
    dev = _cuda()
    rng = np.random.RandomState(heads)
    b, (h, w), d, t_cap = 2, (5, 6), 64, 4
    d_att = d // 2 if heads == 1 else d // heads
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
    valid = torch.ones(b, t_cap, dtype=torch.bool, device=dev)
    valid[0, 1] = False
    long_mem = (r(b, t_cap, h * w, heads * d_att), r(b, t_cap, h * w, 2 * d),
                r(b, t_cap, h * w, 2 * d), valid)
    short = (r(b, h * w, heads * d_att), r(b, h * w, 2 * d),
             r(b, h * w, 2 * d))
    block = zero_dropout(GPMBlock(d, att_heads=heads, layer_idx=1)).to(dev)
    tgt = r(b, h * w, d).requires_grad_()
    counts = lambda: (memory_read_fused.launches,
                      local_window_attention.launches,
                      memory_read_attention.launches)
    before = counts()
    out, out_id, _, _ = block.train()(tgt, r(b, h * w, d), long_mem, short,
                                      None, (h, w), None)
    assert counts() == before
    assert out.grad_fn is not None and out_id.grad_fn is not None
    (out.square().sum() + out_id.square().sum()).backward()
    assert float(tgt.grad.abs().sum()) > 0
    assert float(block.linear_QV.weight.grad.abs().sum()) > 0
    with torch.no_grad():
        block.eval()(tgt, r(b, h * w, d), long_mem, short, None, (h, w),
                     None)
    after = counts()
    if heads == 1:
        assert after[0] > before[0] and after[1] > before[1]
    else:
        assert after[2] > before[2]


@pytest.mark.cuda
def test_kernel_wrappers_refuse_autograd_on_the_card():
    """No kernel has a backward: each wrapper raises on a CUDA input that
    requires grad under grad mode, and launches under no_grad."""
    dev = _cuda()
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        dev, torch.bfloat16)
    q, k, v = t(1, 40, 32), t(1, 3, 40, 32), t(1, 3, 40, 16)
    valid = torch.ones(1, 3, dtype=torch.bool, device=dev)
    rel = torch.from_numpy(rng.randn(1, 40, 225).astype(np.float32)).to(dev)
    calls = {
        'memory_read_fused': lambda q: memory_read_fused(
            q, k, (v,), valid, 1, 0.2),
        'memory_read_multihead': lambda q: memory_read_multihead(
            q, k, v, valid, 2, 0.2),
        'memory_read_attention': lambda q: memory_read_attention(
            q, k, v, valid),
        'local_window_attention': lambda q: local_window_attention(
            q, q.detach(), t(1, 40, 16), rel, (5, 8), 7, False),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='no backward'):
            call(q.clone().requires_grad_())
        with torch.no_grad():
            call(q.clone().requires_grad_())


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A train state on the card (model, AdamW moments after one update,
    EMA, counters) saved as a step_<N> checkpoint and restored onto the
    card with weights_only=True is equal to it, tensor for tensor."""
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.train import optim
    from rmem_ocu_tpu_torch.train.trainer import Trainer
    from rmem_ocu_tpu_torch.utils import checkpoint as ckpt
    dev = _cuda()
    exp = get_config('pre_vost_2', model='aott')
    trainer = Trainer(build_vos_model(exp.model, device=dev, seed=0), exp)
    state = trainer.init_state()
    params = {k: p.detach() for k, p in trainer.model.named_parameters()}
    grads = {k: torch.randn_like(p) for k, p in params.items()}
    _, opt_state = optim.adam_update(grads, state.opt_state)
    state = type(state)(opt_state=opt_state, ema=state.ema, step=3,
                        ema_updates=2)
    saved = trainer.state_dict(state)
    ckpt.save_checkpoint(str(tmp_path / 'ckpt'), 3, saved)
    other = Trainer(build_vos_model(exp.model, device=dev, seed=1), exp)
    restored, step = ckpt.restore_checkpoint(
        str(tmp_path / 'ckpt'), other.state_dict(other.init_state()))
    back = other.state_dict(other.load_state_dict(restored))
    assert step == 3 and back['step'] == 3 and back['ema_updates'] == 2
    assert back['opt_state']['count'] == 1
    for part in ('state_dict', 'ema'):
        for k, v in saved[part].items():
            assert back[part][k].device.type == 'cuda'
            assert torch.equal(back[part][k], v), (part, k)
    for moment in ('mu', 'nu'):
        for k, v in saved['opt_state'][moment].items():
            assert back['opt_state'][moment][k].device.type == 'cuda'
            assert torch.equal(back['opt_state'][moment][k], v), k
