"""Kernels B1 (fused bank read) and B2 (local-window attention) of the
PyTorch port.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held to the JAX package's Pallas kernels run in interpret mode, on the same
numpy inputs. The CUDA kernels themselves are held to the plain versions in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rmem_ocu_tpu.models.lstt import bank_key_bias as jax_bank_key_bias
from rmem_ocu_tpu.models.lstt import \
    frame_mass_from_probs as jax_frame_mass_from_probs
from rmem_ocu_tpu.ops.attention import LocalGatedPropagation as JaxLocal
from rmem_ocu_tpu.ops.pallas.memory_read import \
    memory_read_fused as jax_memory_read_fused

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch.config import get_model_config
from rmem_ocu_tpu_torch.models.lstt import (bank_key_bias,
                                            frame_mass_from_probs)
from rmem_ocu_tpu_torch.ops.attention import LocalGatedPropagation
from rmem_ocu_tpu_torch.ops.kernels.memory_read import memory_read_fused
from rmem_ocu_tpu_torch.utils.convert import params_from_flax
from test_torch_kernels_cuda import _b1_inputs

CFG = get_model_config('r50_deaotl')


@pytest.mark.parametrize('precise', [True, False], ids=['precise', 'bf16'])
@pytest.mark.parametrize('heads,n_banks,with_pe',
                         [(1, 2, True), (1, 1, False), (2, 1, True)],
                         ids=['1head_2banks_pe', '1head_1bank', '2heads_pe'])
def test_plain_memory_read_matches_pallas(heads, n_banks, with_pe, precise):
    q, k, vs, valid, pe, scale = _b1_inputs(heads, n_banks, with_pe)
    (*want,), want_mass = jax_memory_read_fused(
        jnp.asarray(q), jnp.asarray(k), tuple(jnp.asarray(v) for v in vs),
        jnp.asarray(valid), heads, scale,
        mem_pe=None if pe is None else jnp.asarray(pe), interpret=True,
        precise=precise)
    t = torch.from_numpy
    got, got_mass = memory_read_fused(
        t(q), t(k), tuple(t(v) for v in vs), t(valid), heads, scale,
        mem_pe=None if pe is None else t(pe), precise=precise)
    # precise: f32 throughout, only summation order differs. bf16 operands:
    # the bars of tests/test_pallas_regression.py
    tol = 1e-5 if precise else 1e-3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(got_mass.numpy(), np.asarray(want_mass),
                               rtol=min(tol, 1e-4), atol=min(tol, 1e-4))
    # dead and free slots receive no mass; live mass sums to one
    m = got_mass.numpy()
    assert np.abs(m[~np.broadcast_to(valid[:, None], m.shape)]).max() == 0
    np.testing.assert_allclose(m.sum(-1), 1.0, atol=1e-5)


def test_plain_memory_read_matches_dense_masked_attention():
    """The precise plain B1 equals one dense softmax over the flattened bank
    with free slots masked by bank_key_bias, its mass taken with
    frame_mass_from_probs; both helpers equal the JAX package's."""
    q, k, vs, valid, pe, scale = _b1_inputs(1, 1, True)
    b, t_cap, hwk, d = k.shape
    bias = bank_key_bias(torch.from_numpy(valid), hwk)
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(jax_bank_key_bias(jnp.asarray(valid), hwk)))
    keys = torch.from_numpy(k + pe[:, :, None, :]).reshape(b, t_cap * hwk, d)
    logits = torch.from_numpy(q) * scale @ keys.transpose(1, 2) + bias[:, 0]
    probs = torch.softmax(logits, dim=-1)
    want = probs @ torch.from_numpy(vs[0]).reshape(b, t_cap * hwk, -1)
    want_mass = frame_mass_from_probs(probs[:, None], t_cap)
    np.testing.assert_allclose(
        want_mass.numpy(),
        np.asarray(jax_frame_mass_from_probs(jnp.asarray(probs[:, None]),
                                             t_cap)), rtol=1e-6, atol=1e-6)
    t = torch.from_numpy
    (got,), got_mass = memory_read_fused(t(q), t(k), (t(vs[0]),), t(valid),
                                         1, scale, mem_pe=t(pe), precise=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_mass.numpy(), want_mass.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('h,w', [(6, 6), (11, 14), (23, 40)])
def test_plain_local_attention_matches_pallas(h, w, monkeypatch):
    """LocalGatedPropagation as the GPM uses it (one head, no input
    projections): the JAX module in 'pallas' mode (the B2 kernel in
    interpret mode) against the port's module on the plain version."""
    monkeypatch.setenv('RMEM_LOCAL_ATTN', 'pallas')
    rng = np.random.RandomState(h * 100 + w)
    b, d_qk, d_vu, d_att = 2, 32, 16, 16
    e = 2 * d_vu
    q = rng.randn(b, h * w, d_att).astype(np.float32)
    k = rng.randn(b, h * w, d_att).astype(np.float32)
    v = rng.randn(b, h * w, e).astype(np.float32)
    u = rng.randn(b, h * w, e).astype(np.float32)
    jmod = JaxLocal(d_qk=d_qk, d_vu=d_vu, num_heads=1, max_dis=7,
                    d_att=d_att, use_linear=False)
    args = [jnp.asarray(x) for x in (q, k, v, u)]
    params = jmod.init(jax.random.PRNGKey(0), *args, (h, w))
    # non-zero relative-bias bias so every term of the logits is exercised
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.2 * rng.randn(*x.shape).astype(
            np.float32), jax.device_get(params))
    want, _ = jmod.apply(params, *args, (h, w))

    mod = LocalGatedPropagation(d_qk=d_qk, d_vu=d_vu, num_heads=1,
                                max_dis=7, d_att=d_att).eval()
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(x) for x in (q, k, v, u)), (h, w))
    # f32 softmax over the same in-window keys (test_banded_local_attn bar)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _split_combine_read(q, k_bank, v_banks, valid, heads, pe, n_split,
                        block=16):
    """The arithmetic of the CUDA bank read (csrc/memory_read_tc.cuh) in
    torch: the key tiles (of `block` keys) of the live slots, in order, are
    shared out to n_split units in contiguous, balanced ranges; each unit
    runs the online softmax over its range (p rounded to bf16 at the
    unit's running max) and records (m, l) where its share of a slot
    ends; the combine takes M = max m, L = sum e^(m - M) l, out = sum_u
    e^(m_u - M) acc_u / max(L, 1e-30) and mass_t = sum over t's shares of
    e^(m - M) l, over L. q is pre-scaled. Returns (outs per bank, mass
    [B, HWq, T] head mean)."""
    bf = lambda x: x.to(torch.bfloat16).float()
    b, hwq, hd = q.shape
    _, t_cap, hwk, _ = k_bank.shape
    h, d = heads, hd // heads
    qh = bf(q).view(b, hwq, h, d).transpose(1, 2)
    kh = bf(k_bank).view(b, t_cap, hwk, h, d).permute(0, 3, 1, 2, 4)
    vh = bf(torch.cat(v_banks, -1)).view(b, t_cap, hwk, h, -1).permute(
        0, 3, 1, 2, 4)
    peh = None if pe is None else pe.float().view(b, t_cap, h, d).transpose(
        1, 2)
    n_kt = -(-hwk // block)
    out = torch.zeros(b, h, hwq, vh.shape[-1])
    mass = torch.zeros(b, h, hwq, t_cap)
    for i in range(b):
        live = [t for t in range(t_cap) if valid[i, t]]
        n_work = len(live) * n_kt
        recs, parts = [], []
        for u in range(n_split):
            w0, w1 = u * n_work // n_split, (u + 1) * n_work // n_split
            if w0 == w1:
                continue
            m = torch.full((h, hwq, 1), -1e30)
            acc = torch.zeros(h, hwq, vh.shape[-1])
            for w in range(w0, w1):
                t, k0 = live[w // n_kt], (w % n_kt) * block
                if w == w0 or w % n_kt == 0:
                    lt = torch.zeros(h, hwq, 1)
                    pc = (0.0 if peh is None else
                          (qh[i] * peh[i, :, t, None, :]).sum(-1,
                                                              keepdim=True))
                s = qh[i] @ kh[i, :, t, k0:k0 + block].transpose(-1, -2)
                s = s + pc
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
                acc = acc * alpha + bf(p) @ vh[i, :, t, k0:k0 + block]
                lt = lt * alpha + p.sum(-1, keepdim=True)
                m = m_new
                if w == w1 - 1 or w % n_kt == n_kt - 1:
                    recs.append((t, m, lt))
            parts.append((m, acc))
        big_m = torch.full((h, hwq, 1), -1e30)
        for _, m_t, _ in recs:
            big_m = torch.maximum(big_m, m_t)
        denom = sum((torch.exp(m_t - big_m) * l_t for _, m_t, l_t in recs),
                    torch.zeros(h, hwq, 1)).clamp_min(1e-30)
        for m_u, acc_u in parts:
            out[i] += torch.exp(m_u - big_m) * acc_u / denom
        for t, m_t, l_t in recs:
            mass[i, :, :, t] += (torch.exp(m_t - big_m) * l_t / denom)[..., 0]
    flat = out.transpose(1, 2).reshape(b, hwq, -1)
    widths = [v.shape[-1] // h for v in v_banks]
    outs = torch.split(flat.view(b, hwq, h, -1), widths, dim=-1)
    return ([o.reshape(b, hwq, -1) for o in outs], mass.mean(1))


@pytest.mark.parametrize('n_split', [1, 2, 5])
@pytest.mark.parametrize('heads,n_banks', [(1, 2), (4, 1)],
                         ids=['1head_2banks', '4heads'])
def test_split_combine_read_matches_one_pass_and_pallas(heads, n_banks,
                                                        n_split):
    """The kernel's split-over-slots arithmetic gives the one-pass plain
    read under the bf16 bar of tests/test_torch_kernels_cuda.py (p is
    rounded at another running max) and the Pallas kernel's per-slot
    mass within 1e-4."""
    q, k, vs, valid, pe, scale = _b1_inputs(heads, n_banks, True, seed=7)
    t = torch.from_numpy
    got, got_mass = _split_combine_read(t(q) * scale, t(k),
                                        [t(v) for v in vs], valid, heads,
                                        t(pe).expand(2, -1, -1), n_split)
    want, _ = memory_read_fused(t(q), t(k), tuple(t(v) for v in vs),
                                t(valid), heads, scale, mem_pe=t(pe))
    for g, w in zip(got, want):
        rms = float(w.square().mean().sqrt())
        torch.testing.assert_close(g, w, rtol=2 ** -7, atol=0.02 * rms)
    _, pallas_mass = jax_memory_read_fused(
        jnp.asarray(q), jnp.asarray(k), tuple(jnp.asarray(v) for v in vs),
        jnp.asarray(valid), heads, scale, mem_pe=jnp.asarray(pe),
        interpret=True)
    np.testing.assert_allclose(got_mass.numpy(), np.asarray(pallas_mass),
                               rtol=1e-4, atol=1e-4)


H100_SMS = 132


@pytest.mark.parametrize('b,h,hw,d,cph,want', [
    (8, 1, 37 * 66, 128, 1024, 1),     # r50_deaotl.vost_b8
    (8, 1, 37 * 65, 128, 1024, 1),     # swinb_deaotl.vost_b8
    (1, 1, 23 * 40, 128, 1024, 2),     # one stream at 23x40
    (1, 1, 23 * 40, 128, 512, 4),      # B1 on a TP shard, M = 2
    (1, 1, 23 * 40, 128, 256, 8),      # B1 on a TP shard, M = 4
    (1, 2, 23 * 40, 128, 256, 4),      # B3 on a TP shard, M = 2
    (1, 2, 23 * 40, 128, 128, 8),      # B3 on a TP shard, M = 4
], ids=['r50_vost_b8', 'swinb_vost_b8', 'b1_23x40', 'tp_m2', 'tp_m4',
        'b3_tp_m2', 'b3_tp_m4'])
def test_split_count_of_the_main_shapes(b, h, hw, d, cph, want):
    """The cells' reads are one launch (n_split 1); one stream at 23x40
    and the TP shards split over slots."""
    from rmem_ocu_tpu_torch.ops.kernels.memory_read import split_count
    assert split_count(b, h, hw, d, cph, hw, H100_SMS) == want


def test_split_count_leaves_no_unit_empty():
    """Over batches, grids, heads, widths and SM counts, no unit of the
    split is empty for any number of live slots, and more blocks than
    SMs never split."""
    from rmem_ocu_tpu_torch.ops.kernels.memory_read import (
        BLOCK_KEYS, HEADS_ROWS, WIDE_ROWS, column_blocks, heads_per_block,
        split_count)
    for b in (1, 2, 8):
        for hw in (36, 81, 858, 920, 2405, 2442, 4080):
            for h, d, cph in ((1, 128, 1024), (1, 128, 512), (2, 128, 256),
                              (2, 32, 32), (8, 32, 32), (1, 64, 80)):
                for sms in (1, 78, 132):
                    n = split_count(b, h, hw, d, cph, hw, sms)
                    n_kt = -(-hw // BLOCK_KEYS)
                    hpb = heads_per_block(h, d, cph)
                    if hpb:
                        blocks = -(-hw // HEADS_ROWS) * b * -(-h // hpb)
                    else:
                        blocks = (-(-hw // WIDE_ROWS) * b * h
                                  * column_blocks(cph))
                    assert 1 <= n <= n_kt
                    assert n == 1 or blocks * n <= sms
                    for n_live in range(1, 11):
                        work = n_live * n_kt
                        bounds = [u * work // n for u in range(n + 1)]
                        assert all(x < y for x, y in zip(bounds, bounds[1:]))
