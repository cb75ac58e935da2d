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
                                max_dis=7, d_att=d_att)
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(x) for x in (q, k, v, u)), (h, w))
    # f32 softmax over the same in-window keys (test_banded_local_attn bar)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
