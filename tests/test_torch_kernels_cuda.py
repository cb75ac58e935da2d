"""CUDA kernels B1 and B2 of the PyTorch port against their plain PyTorch
versions on the card, at small shapes (chip_smoke.py does the same at the
main-path shapes). Every test needs a CUDA device and skips without one.
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
        assert memory_read_fused.launches == before + 1
        for g, w in zip(got, want):
            _assert_close(g, w, tol)
        torch.testing.assert_close(got_mass, want_mass, rtol=1e-4, atol=1e-4)


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
