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
    memory_read_fused, memory_read_fused_plain, read_plan)
from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import (
    memory_read_attention, memory_read_attention_plain, memory_read_multihead,
    memory_read_multihead_plain)
from rmem_ocu_tpu_torch.utils import tracing


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


def _launches(kernel):
    """Launches of kernel 'b1', 'b2' or 'b3' counted so far."""
    return tracing.counters().get(f'kernels.{kernel}.launches', 0)


def _counts():
    """Launches of (B1, B2, B3) counted so far."""
    return tuple(map(_launches, ('b1', 'b2', 'b3')))


def _plan_launches(b, heads, hwq, d, cph, hwk):
    """Launches of one bf16 bank read at these shapes: 1 where one unit
    covers the bank (the wide-head kernel finishes the read), else 2 (the
    split read and its combine)."""
    return read_plan(b, heads, hwq, d, cph, 1, hwk,
                     torch.device('cuda'))[3]


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
        before = _launches('b1')
        got, got_mass = memory_read_fused(*args, **kw)
        want, want_mass = memory_read_fused_plain(*args, **kw)
        b, hwq, hd = q.shape
        assert _launches('b1') == before + (1 if precise else _plan_launches(
            b, heads, hwq, hd // heads, sum(v.shape[-1] for v in vs) // heads,
            k.shape[2]))
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
    before = _launches('b1')
    (got,), got_mass = memory_read_fused(*args, mem_pe=t(pe))
    (want,), want_mass = memory_read_fused_plain(*args, mem_pe=t(pe))
    assert _launches('b1') == before + 2
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
    b, hwq, _ = q.shape
    d, dv = q.shape[-1] // heads, 2 * v.shape[-1] // heads
    hwk = k.shape[2]
    launches = _plan_launches(b, heads, hwq, d, dv, hwk)
    before = _launches('b3')
    got, got_mass = memory_read_multihead(*args)
    assert _launches('b3') == before + launches
    want, want_mass = memory_read_multihead_plain(*args)
    assert got.dtype == torch.float32
    _assert_close(got, want, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)

    # the folded layout: one head per leading row
    cat = torch.cat([t(v), t(id_v)], dim=-1)
    fold = lambda x, n: x.reshape(*x.shape[:-1], heads, n).movedim(
        -2, 1).reshape(b * heads, *x.shape[1:-1], n).contiguous()
    folded = (fold(t(q) * scale, d), fold(t(k), d), fold(cat, dv),
              torch.from_numpy(valid).to(dev).repeat_interleave(heads, dim=0))
    got, got_mass = memory_read_attention(*folded)
    assert _launches('b3') == before + launches + _plan_launches(
        b * heads, 1, hwq, d, dv, hwk)
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
        before = _launches('b2')
        got = local_window_attention(*args)
        assert _launches('b2') == before + 1
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


# The benchmark cells' grids: VOST 577x1041 (37x66 = 2,442 tokens) through
# ResNet-50 and 592x1040 (37x65 = 2,405) through Swin-B, 8 streams; and
# one stream at 23x40, where the read is split over slots.
CELL_GRIDS = [((37, 66), 8, 1), ((37, 65), 8, 1), ((23, 40), 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize('size_2d,b,launches', CELL_GRIDS,
                         ids=['r50_vost_b8', 'swinb_vost_b8', 'b1_23x40'])
def test_memory_read_kernel_at_cell_shapes(size_2d, b, launches):
    """B1 as the DeAOT read of the benchmark cells calls it: one head of
    128, V and ID_V of 512 each, T_cap 10 with a dead slot, the temporal
    PE. At 8 streams the blocks fill the card unsplit and the kernel
    finishes the read in one launch; one stream at 23x40 splits it over
    slots and combines (two launches)."""
    dev = _cuda()
    rng = np.random.RandomState(size_2d[1] + b)
    hw, t_cap, d = size_2d[0] * size_2d[1], 10, 128
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    q = t(rng.randn(b, hw, d))
    k = t(rng.randn(b, t_cap, hw, d))
    vs = tuple(t(rng.randn(b, t_cap, hw, 512)) for _ in range(2))
    valid = torch.from_numpy(np.stack([_dead_slots(t_cap, 'middle')] * b))
    pe = t(rng.randn(1, t_cap, d) * 0.05)
    args = (q, k, vs, valid.to(dev), 1, d ** -0.5)
    before = _launches('b1')
    got, got_mass = memory_read_fused(*args, mem_pe=pe)
    assert _launches('b1') == before + launches
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
    before = _counts()
    out, out_id, _, _ = block.train()(tgt, r(b, h * w, d), long_mem, short,
                                      None, (h, w), None)
    assert _counts() == before
    assert out.grad_fn is not None and out_id.grad_fn is not None
    (out.square().sum() + out_id.square().sum()).backward()
    assert float(tgt.grad.abs().sum()) > 0
    assert float(block.linear_QV.weight.grad.abs().sum()) > 0
    with torch.no_grad():
        block.eval()(tgt, r(b, h * w, d), long_mem, short, None, (h, w),
                     None)
    after = _counts()
    if heads == 1:
        assert after[0] > before[0] and after[1] > before[1]
    else:
        assert after[2] > before[2]


@pytest.mark.cuda
def test_census_frames_sees_the_kernels_on_the_card():
    """The census of `r50_deaotl` frames on the card (129x129, gap 5)
    counts B1 and B2 launches as the wrappers' counters do, 6 and 3 a
    frame, no B3, and places every kernel in a component."""
    from rmem_ocu_tpu_torch.tools import census
    _cuda()
    engine, state, frames, size = census.build_frames(size=(129, 129))
    state = census.frame_step(engine, state, frames[0], size)
    before = _counts()
    c, _ = census.profile_frames(engine, state, frames, size, n=3)
    after = _counts()
    launches = c['group_launches']
    assert (launches['B1 memory_read'], launches['B2 local_attn'],
            launches['B3 memory_read_attention']) == (6, 3, 0)
    assert tuple(a - b for a, b in zip(after, before)) == (18, 9, 0)
    assert c['device'] == 'cuda' and c['busy_ms'] > 0
    assert c['matched_share'] == 1.0


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


@pytest.mark.cuda
def test_two_ranks_on_the_card_step_as_one(tmp_path):
    """Two processes on card 0, a gloo group over CUDA tensors (NCCL takes
    one rank a card), one sample and half the ZeRO-1 moments each: one
    AdamW step equals one process's on both samples (loss within 1e-5,
    parameters and EMA within 1e-4, both ranks alike); no kernel runs."""
    import json
    import torch_dp_worker as worker
    from rmem_ocu_tpu_torch.parallel.dist import World
    dev = _cuda()
    case = dict(name='card', model='deaott', steps=1, batch=2, zero1=True)
    spec = str(tmp_path / 'spec.json')
    with open(spec, 'w') as f:
        json.dump(dict(device='cuda:0', backend='gloo', timeout=300,
                       out=str(tmp_path), cases=[case]), f)
    procs = worker.spawn(2, [worker.__file__, spec], local_ranks=[0, 0])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    before = _counts()[:2]
    try:
        one = worker.run_case(case, World(device=dev))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        worker.wait(procs, 600)
    assert _counts()[:2] == before
    two = torch.load(worker.digest_path(str(tmp_path), 'card', 2))
    assert two['same_on_ranks']
    assert abs(two['steps'][0]['loss'] - one['steps'][0]['loss']) <= 1e-5
    torch.testing.assert_close(two['weights'], one['weights'], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(two['ema'], one['ema'], rtol=0, atol=1e-4)
    whole, held = two['largest_moment']
    assert held * 2 == whole


# tensor parallelism over a model group of M (parallel/tp.py): each rank
# reads its shard of the bank on the main path's 23x40 grid
TP_GRID = (23, 40)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 8])
@pytest.mark.parametrize('heads,d,dvs', [
    (1, 128, (256, 256)), (1, 128, (128, 128)), (4, 32, (128,)),
    (2, 32, (64,))], ids=['deaot_m2', 'deaot_m4', 'aot_m2', 'aot_m4'])
def test_memory_read_kernel_at_tp_shards(heads, d, dvs, b):
    """B1 on a rank's shard: one head with V and ID_V of 512/M each, and
    8/M AOT heads of 32 (2 heads a rank takes memory_read_ws)."""
    dev = _cuda()
    rng = np.random.RandomState(heads + b + dvs[0])
    hw, t_cap = TP_GRID[0] * TP_GRID[1], 10
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
@pytest.mark.parametrize('e', [256, 128], ids=['m2', 'm4'])
def test_memory_read_attention_kernel_at_tp_shards(e, b):
    """B3 on a rank's shard of the two-head read: two heads of 128, head 0
    the rank's e channels of V, head 1 its e of ID_V."""
    dev = _cuda()
    rng = np.random.RandomState(e + b)
    hw, t_cap, heads, d = TP_GRID[0] * TP_GRID[1], 10, 2, 128
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    q = t(rng.randn(b, hw, heads * d))
    k = t(rng.randn(b, t_cap, hw, heads * d))
    banks = (t(rng.randn(b, t_cap, hw, e)), t(rng.randn(b, t_cap, hw, e)))
    valid = torch.from_numpy(np.stack([_dead_slots(t_cap, 'middle')] * b))
    args = (q, k, banks, valid.to(dev), heads, d ** -0.5)
    got, got_mass = memory_read_multihead(*args)
    want, want_mass = memory_read_multihead_plain(*args)
    _assert_close(got, want, None)
    torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 8])
@pytest.mark.parametrize('e', [512, 256], ids=['m2', 'm4'])
def test_local_attention_kernel_at_tp_shards(e, b):
    """B2 on a rank's value shard, 1024/M wide."""
    dev = _cuda()
    rng = np.random.RandomState(e + b + 1)
    (h, w), d, md = TP_GRID, 128, 7
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    args = (t(rng.randn(b, h * w, d) * d ** -0.5), t(rng.randn(b, h * w, d)),
            t(rng.randn(b, h * w, e)),
            torch.from_numpy(rng.randn(b, h * w, (2 * md + 1) ** 2)
                             .astype(np.float32)).to(dev), (h, w), md, False)
    got = local_window_attention(*args)
    _assert_close(got, local_window_attention_plain(*args), None)


@pytest.mark.cuda
def test_tp_serving_on_the_card_matches_one_process(tmp_path):
    """A model group of two processes on card 0 (gloo over CUDA tensors)
    serves a clip at write gap 1 as one process on the card does: eviction
    ids identical at every update, both ranks alike, f32 logits within
    1e-4 of one process's (the CPU serving test's bar; both sides run f32
    convolutions, not TF32), and a mask pixel may differ only where one
    process's two best upsampled logits are within twice that largest
    logit difference (49x49 has 2401 pixels, so a share bar would count
    ties); the kernels run on each rank's shard."""
    import json
    import torch_dp_worker as worker
    from rmem_ocu_tpu_torch import build_vos_model
    from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
    from rmem_ocu_tpu_torch.parallel.dist import World
    dev = _cuda()
    cases = []
    for name, over in (('deaot', {}), ('aot', {})):
        model = 'deaott' if name == 'deaot' else 'aott'
        case = dict(kind='serve', name=name, model=model,
                    overrides=dict(over, latter_mem_len=2), seed=5,
                    weights=str(tmp_path / f'{name}.pt'))
        exp = worker.serving_exp(case)
        torch.save(build_vos_model(exp.model, device='cpu').state_dict(),
                   case['weights'])
        cases.append(case)
    spec = str(tmp_path / 'spec.json')
    with open(spec, 'w') as f:
        json.dump(dict(device='cuda:0', backend='gloo', timeout=300,
                       out=str(tmp_path), cases=cases, tp=2), f)
    procs = worker.spawn(2, [worker.__file__, spec], local_ranks=[0, 0])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        one = {c['name']: worker.run_serving(c, World(device=dev))
               for c in cases}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        worker.wait(procs, 600)
    for c in cases:
        two = torch.load(worker.digest_path(str(tmp_path), c['name'], 2))
        a = one[c['name']]
        assert two['same_on_ranks']
        for x, y in zip(a['ids'], two['ids']):
            assert torch.equal(x, y)
        size = (worker.SERVE_SIZE,) * 2
        for la, lb, x, y in zip(a['logits'], two['logits'], a['preds'],
                                two['preds']):
            diff = float((la - lb).abs().max())
            assert diff <= 1e-4, diff
            top2 = interpolate_bilinear(la.permute(0, 3, 1, 2), size,
                                        True).topk(2, dim=1).values
            gaps = (top2[:, 0] - top2[:, 1])[x != y]
            assert not gaps.numel() or float(gaps.max()) <= 2 * diff + 1e-6


def _spatial_world_matches_one_process(tmp_path, cases, n, tp, device,
                                       backend, local_ranks=None):
    """Train `cases` with `train_spatial_sharding` on an n-rank world of
    model groups of tp, and in this process on card 0: losses within
    1e-5, each averaged gradient leaf within 2e-3 of its largest (or of
    1e-6), weights and EMA within 1e-4 after the steps, the ranks alike
    (tests/test_torch_spatial.py's bars); no kernel runs."""
    import json
    import torch_dp_worker as worker
    from rmem_ocu_tpu_torch.parallel.dist import World
    dev = _cuda()
    spec = str(tmp_path / f'spec{n}x{tp}.json')
    with open(spec, 'w') as f:
        json.dump(dict(device=device, backend=backend, timeout=300,
                       out=str(tmp_path), cases=cases, tp=tp), f)
    procs = worker.spawn(n, [worker.__file__, spec], local_ranks=local_ranks)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    before = _counts()[:2]
    try:
        one = {c['name']: worker.run_case(c, World(device=dev))
               for c in cases}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        worker.wait(procs, 600)
    assert _counts()[:2] == before
    for c in cases:
        a = one[c['name']]
        b = torch.load(worker.digest_path(str(tmp_path), c['name'], n))
        assert b['same_on_ranks'] and b['whole_grads_alike']
        for sa, sb in zip(a['steps'], b['steps']):
            for k in ('loss', 'aux_loss', 'pred_loss', 'frame_losses'):
                np.testing.assert_allclose(sb[k], sa[k], rtol=0, atol=1e-5,
                                           err_msg=k)
        for k, g in a['grads'].items():
            torch.testing.assert_close(
                b['grads'][k], g, rtol=0,
                atol=2e-3 * max(float(g.abs().max()), 1e-6), msg=k)
        torch.testing.assert_close(b['weights'], a['weights'], rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(b['ema'], a['ema'], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_spatial_ranks_on_the_card_train_as_one(tmp_path):
    """A model group of two processes on card 0 (gloo over CUDA tensors,
    the halo rows staged through host memory) splitting the rows of 49x49
    clips trains `deaott` as one process on the card does."""
    _spatial_world_matches_one_process(
        tmp_path, [dict(name='sp_card', model='deaott', steps=2, batch=2,
                        capture=True, remat='full',
                        overrides=dict(train_spatial_sharding=True))],
        2, 2, 'cuda:0', 'gloo', local_ranks=[0, 0])


@pytest.mark.cuda
def test_spatial_encoders_on_the_card_train_as_one(tmp_path):
    """Two processes on card 0 over gloo split the rows of ResNeSt's,
    the oracle TopDown's (banded transposed convs and half-pixel mask
    resize) and MobileNetV3's models (at 129 px: its dilated 16x convs
    need 4 rows of halo) and train them as one process on the card. In
    float64, as chip_smoke.py phase 13c: in float32 the rounding of the
    split-attention pool's sums flips ReLU kinks behind it."""
    sp = dict(train_spatial_sharding=True)
    train = dict(steps=2, batch=2, capture=True, remat='full',
                 dtype='float64')
    _spatial_world_matches_one_process(
        tmp_path, [
            dict(train, name='sp_card_rs50', model='rs101_aotl',
                 overrides=dict(sp, encoder='resnest50')),
            dict(train, name='sp_card_oracle', model='r50_topdown_aotl',
                 overrides=dict(sp, oracle=True)),
            dict(train, name='sp_card_mbv3', model='aotl', size=129,
                 overrides=dict(sp, encoder='mobilenetv3',
                                encoder_dim=(24, 40, 112, 960)))],
        2, 2, 'cuda:0', 'gloo', local_ranks=[0, 0])


@pytest.mark.cuda
def test_spatial_over_nccl_trains_as_one(tmp_path):
    """Four processes, one a card, over NCCL (the halo exchange as
    `batch_isend_irecv` between cards): a 2 x 2 world trains `deaott`
    with ZeRO-1, and a 1 x 4 world trains `r50_deaotl` on 113x113 clips
    (bands of 32, 32, 32 and 17 px), as one process does."""
    if torch.cuda.device_count() < 4:
        pytest.skip('needs four CUDA devices: one rank a card over NCCL')
    sp = dict(train_spatial_sharding=True)
    _spatial_world_matches_one_process(
        tmp_path, [dict(name='nccl22', model='deaott', steps=2, batch=2,
                        capture=True, zero1=True, remat='full',
                        overrides=sp)], 4, 2, None, 'nccl')
    _spatial_world_matches_one_process(
        tmp_path, [dict(name='nccl14', model='r50_deaotl', steps=2, batch=2,
                        capture=True, remat='full', overrides=sp,
                        size=113)], 4, 4, None, 'nccl')


def _switch_sites(name):
    """(module or None, activations (bf16), key bias or window mask
    (f32), call(module, activations, extras), whether its last output is
    the f32 eviction mass) of one of the four plain attention sites that
    RMEM_BF16_PROBS=0 keeps in f32 storage, at small shapes, weights from
    a seed."""
    from rmem_ocu_tpu_torch.models.encoders.swin import (
        WindowAttention, shifted_window_mask)
    from rmem_ocu_tpu_torch.ops.attention import (GatedPropagation,
                                                  LocalGatedPropagation,
                                                  scaled_dot_attention)
    torch.manual_seed(0)
    rng = np.random.RandomState(11)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    bias = np.where(rng.rand(2, 1, 1, 90) < 0.2, -1e9, 0.0).astype(
        np.float32)
    if name == 'scaled_dot_attention':
        return (None, (r(2, 30, 32), r(2, 90, 32), r(2, 90, 48)), (bias,),
                lambda m, x, e: scaled_dot_attention(
                    *x, 2, key_bias=e[0], mass_capacity=3), True)
    if name == 'multi_value_call':
        mod = GatedPropagation(d_qk=48, d_vu=24, num_heads=1, d_att=16,
                               use_linear=False).eval()
        return (mod, (r(2, 30, 16), r(2, 90, 16), r(2, 90, 24),
                      r(2, 90, 24), r(2, 30, 48)), (bias,),
                lambda m, x, e: m.multi_value_call(
                    x[0], x[1], [x[2], x[3]], x[4], (5, 6), key_bias=e[0],
                    mass_capacity=3), True)
    if name.startswith('local'):
        heads = 2 if name == 'local_2heads_eval' else 1
        mod = LocalGatedPropagation(d_qk=32 * heads, d_vu=16,
                                    num_heads=heads, max_dis=7, d_att=16)
        mod.dw_conv.dropout = 0.0
        mod.train(name == 'local_1head_train')
        return (mod, (r(2, 154, 16 * heads), r(2, 154, 16 * heads),
                      r(2, 154, 32), r(2, 154, 32)), (),
                lambda m, x, e: (m(*x, (11, 14)),), False)
    mod = WindowAttention(64, 7, 4).eval()
    with torch.no_grad():
        mod.relative_position_bias_table.normal_()
    mask = (shifted_window_mask(14, 14, 7, 3),) if name == 'window_shifted' \
        else ()
    return mod, (r(8, 49, 64),), mask, lambda m, x, e: (m(*x, *e),), False


@pytest.mark.cuda
@pytest.mark.parametrize('name', [
    'scaled_dot_attention', 'multi_value_call', 'local_2heads_eval',
    'local_1head_train', 'window', 'window_shifted'])
def test_switch_sites_on_the_card_match_the_cpu(name, monkeypatch):
    """Each plain attention site in bf16 with RMEM_BF16_PROBS=0 on the card
    against the same module on the CPU with the switch: outputs within two
    bf16 ulps of their largest (at least 1) plus 2% of their RMS, the
    mass within 1e-5, and each closer on average than the CPU at the
    default (the card followed the switch). No kernel launches: these are
    the plain sites."""
    dev = _cuda()
    mod, acts, extras, call, with_mass = _switch_sites(name)

    def run(device, value):
        if value is None:
            monkeypatch.delenv('RMEM_BF16_PROBS', raising=False)
        else:
            monkeypatch.setenv('RMEM_BF16_PROBS', value)
        x = [torch.from_numpy(a).to(device, torch.bfloat16) for a in acts]
        e = [torch.from_numpy(a).to(device) for a in extras]
        m = None if mod is None else mod.to(device, torch.bfloat16)
        with torch.no_grad():
            return [o.float().cpu() for o in call(m, x, e)]
    before = _counts()
    got = run(dev, '0')
    assert _counts() == before
    want, default = run('cpu', '0'), run('cpu', None)
    for i, (g, w, w0) in enumerate(zip(got, want, default)):
        if with_mass and i == len(got) - 1:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        else:
            rms = float(w.square().mean().sqrt())
            bar = 2 * 2.0 ** -8 * max(1.0, float(w.abs().max())) + 0.02 * rms
            assert float((g - w).abs().max()) <= bar, (name, i)
        assert float((g - w).abs().mean()) < float((g - w0).abs().mean()), \
            (name, i)


@pytest.mark.cuda
def test_kernel_wrappers_ignore_the_switch_on_the_card(monkeypatch):
    """B1, B2 and B3 on the card give bit-identical results with
    RMEM_BF16_PROBS=0 and unset, launching the same kernels."""
    dev = _cuda()
    t = lambda x: torch.from_numpy(x).to(dev, torch.bfloat16)
    q, k, vs, valid, pe, scale = _b1_inputs(1, 2, True)
    b1 = (t(q), t(k), tuple(t(v) for v in vs),
          torch.from_numpy(valid).to(dev), 1, scale)
    q3, k3, v3, id_v3, valid3, scale3 = _b3_inputs(2)
    b3 = (t(q3), t(k3), (t(v3), t(id_v3)), torch.from_numpy(valid3).to(dev),
          2, scale3)
    rng = np.random.RandomState(5)
    b2 = (t(rng.randn(2, 154, 32).astype(np.float32) / 32 ** 0.5),
          t(rng.randn(2, 154, 32).astype(np.float32)),
          t(rng.randn(2, 154, 48).astype(np.float32)),
          torch.from_numpy(rng.randn(2, 154, 225).astype(np.float32)).to(dev),
          (11, 14), 7, False)

    def run():
        before = _counts()
        (o1, o2), m1 = memory_read_fused(*b1, mem_pe=t(pe))
        o3, m3 = memory_read_multihead(*b3)
        o4 = local_window_attention(*b2)
        return [o1, o2, m1, o3, m3, o4], tuple(
            a - b for a, b in zip(_counts(), before))
    monkeypatch.delenv('RMEM_BF16_PROBS', raising=False)
    default, n_default = run()
    monkeypatch.setenv('RMEM_BF16_PROBS', '0')
    switched, n_switched = run()
    # one key tile a slot: each bank read is one launch
    want = (_plan_launches(2, 1, 40, 16, 48, 36), 1,
            _plan_launches(2, 2, 40, 16, 48, 36))
    assert n_default == n_switched == want
    for a, b in zip(default, switched):
        assert torch.equal(a, b)
