"""Streaming parity of the PyTorch port's engine against the JAX engine.

r50_deaotl at 65x65 (a 5x5 grid), two streams on the batch axis with
their own inputs and object counts, latter_mem_len=3 and write gap 1, so
the bank fills within three frames and attention/UCB eviction fires on the
last two. (With random weights the attention is near-uniform and UCB
evicts the oldest latter frame; test_bank_eviction_matches_jax holds the
score-driven choices with non-uniform masses.) The JAX engine runs with RMEM_PALLAS=1, i.e. both Pallas
kernels in interpret mode on the CPU, as the oracle; the port runs on the
CPU, where its kernel wrappers take their plain versions. Same weights
(converted with params_from_flax), same numpy inputs.

Bars (tests/test_pallas_regression.py): eviction ids identical at every
step, >99.9% of mask pixels equal, logits within 1e-3 and eviction mass
within 1e-4 (f32 both sides; the drift is summation order through the
network, not a different algorithm).
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.engine import InferEngine as JaxEngine
from rmem_ocu_tpu.memory import bank as jax_bank
from rmem_ocu_tpu.models import build_vos_model as jax_build

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
from rmem_ocu_tpu_torch.memory import bank
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

SIZE, FRAMES = 65, 5
OBJ = [2, 3]                    # objects per stream


def _inputs():
    rng = np.random.RandomState(11)
    img0 = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    mask0 = (rng.rand(2, SIZE, SIZE) * np.array([3, 4])[:, None, None]
             ).astype(np.int32)
    frames = [(rng.randn(2, SIZE, SIZE, 3) * 0.5 + img0).astype(np.float32)
              for _ in range(FRAMES)]
    return img0, mask0, frames


def _run_jax(exp, params, img0, mask0, frames):
    eng = JaxEngine(jax_build(exp.model), exp, long_term_mem_gap=1)
    st = eng.init_state(2, (5, 5))
    st = eng.add_reference_frame(params, st, jnp.asarray(img0),
                                 jnp.asarray(mask0), jnp.array(OBJ, jnp.int32))
    out = []
    for f in frames:
        logits, st = eng.propagate(params, st, jnp.asarray(f))
        pred = eng.predict_mask(logits, (SIZE, SIZE))
        mass = np.asarray(st.pending_mass)
        st = eng.update_memory(params, st, pred)
        out.append((np.asarray(logits), np.asarray(pred), mass,
                    np.asarray(st.bank.frame_ids),
                    np.asarray(st.bank.ordered_frame_ids)))
    return out


def _run_port(exp, state_dict, img0, mask0, frames):
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(state_dict, strict=True)
    eng = InferEngine(model, exp, long_term_mem_gap=1)
    st = eng.init_state(2, (5, 5))
    st = eng.add_reference_frame(st, torch.from_numpy(img0),
                                 torch.from_numpy(mask0), torch.tensor(OBJ))
    out = []
    for f in frames:
        logits, st = eng.propagate(st, torch.from_numpy(f))
        pred = eng.predict_mask(logits, (SIZE, SIZE))
        mass = st.pending_mass.numpy().copy()
        st = eng.update_memory(st, pred)
        out.append((logits.numpy(), pred.numpy(), mass,
                    st.bank.frame_ids.numpy(),
                    st.bank.ordered_frame_ids.numpy()))
    return out


def test_port_engine_matches_jax_engine(monkeypatch):
    monkeypatch.setenv('RMEM_PALLAS', '1')
    img0, mask0, frames = _inputs()
    jexp = jax_get_config('pre_vost_2', model='r50_deaotl', latter_mem_len=3)
    params = jax.jit(jax_build(jexp.model).init)(
        jax.random.PRNGKey(0), jnp.asarray(img0[:1]),
        jnp.zeros((1, SIZE, SIZE, jexp.model.id_dim)))
    params = jax.device_get(params)
    want = _run_jax(jexp, params, img0, mask0, frames)

    exp = get_config('pre_vost_2', model='r50_deaotl', latter_mem_len=3)
    got = _run_port(exp, params_from_flax(params, exp.model), img0, mask0,
                    frames)

    evicted = False
    for t, (w, g) in enumerate(zip(want, got)):
        w_logits, w_pred, w_mass, w_ids, w_ord = w
        g_logits, g_pred, g_mass, g_ids, g_ord = g
        np.testing.assert_array_equal(g_ids, w_ids, err_msg=f'frame {t}')
        np.testing.assert_array_equal(g_ord, w_ord, err_msg=f'frame {t}')
        np.testing.assert_allclose(g_logits, w_logits, rtol=1e-3, atol=1e-3,
                                   err_msg=f'logits frame {t}')
        assert (g_pred == w_pred).mean() > 0.999, f'masks frame {t}'
        np.testing.assert_allclose(g_mass, w_mass, rtol=1e-4, atol=1e-4,
                                   err_msg=f'eviction mass frame {t}')
        evicted |= bool((w_ord[:, 1] != 1).all())
    assert evicted, 'the clip must exercise eviction in both streams'
    # the reference frame stays in slot 0; the bank caps at 1 + 3
    final = got[-1][4]
    assert (final[:, 0] == 0).all() and ((final >= 0).sum(1) == 4).all()


def test_short_term_window_matches_jax():
    """A short-term window of 2 frames (test_short_term_mem_skip=2): it
    grows, then drops the oldest entry; read() returns the oldest."""
    rng = np.random.RandomState(4)
    jshort = jax_bank.init_short_term(2, 3, 2, 5, 4, 6, True)
    short = bank.init_short_term(2, 3, 2, 5, 4, 6, torch.float32, 'cpu')
    for _ in range(3):
        new = [[rng.randn(3, 5, c).astype(np.float32) for _ in range(2)]
               for c in (4, 6, 6)]
        jshort = jax_bank.push_short_term(
            jshort, *[tuple(jnp.asarray(x) for x in n) for n in new])
        bank.push_short_term(
            short, *[[torch.from_numpy(x) for x in n] for n in new])
        for got, want in zip(short.read(), jshort.read()):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(short.count.numpy(),
                                      np.asarray(jshort.count))


def test_bank_eviction_matches_jax():
    """Append, score and evict on a 1+8(+1) bank, step by step against the
    JAX bank: non-uniform eviction masses and foreground weights (so the
    EMA+UCB argmin is a real choice), per-stream append predication (so
    the physical layouts of the streams diverge)."""
    rng = np.random.RandomState(6)
    b, cap, hw = 3, 10, 4
    jbk = jax_bank.init_bank(1, b, cap, hw, 2, 3, True)
    pbk = bank.init_bank(1, b, cap, hw, 2, 3, torch.float32, 'cpu')
    t = torch.from_numpy
    non_fifo = 0
    for step in range(30):
        new = [rng.randn(b, hw, c).astype(np.float32) for c in (2, 3, 3)]
        on = rng.rand(b) < 0.8
        jbk = jax_bank.append_frame(jbk, *[(jnp.asarray(x),) for x in new],
                                    step, enabled=jnp.asarray(on))
        bank.append_frame(pbk, *[[t(x)] for x in new], step,
                          enabled=t(on))
        mass = (rng.rand(b, hw, cap) ** 4).astype(np.float32)
        fg = rng.rand(b, hw).astype(np.float32)
        jdrop, jbk = jax_bank.eviction_scores_and_update(
            jbk, jnp.asarray(mass), fg_proba=jnp.asarray(fg),
            enabled=jnp.asarray(on))
        drop = bank.eviction_scores_and_update(pbk, t(mass), fg_proba=t(fg),
                                               enabled=t(on))
        np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
        over = on & (np.asarray(jbk.length) > 9)
        non_fifo += int((np.asarray(jdrop)[over] != 1).sum())
        jbk = jax_bank.evict_frame(jbk, jdrop, enabled=jnp.asarray(over))
        bank.evict_frame(pbk, drop, enabled=t(over))
        for name in ('length', 'pos', 'frame_ids', 'ema_present'):
            np.testing.assert_array_equal(getattr(pbk, name).numpy(),
                                          np.asarray(getattr(jbk, name)),
                                          err_msg=f'{name} step {step}')
        for name in ('attn_ema', 'visits'):
            np.testing.assert_allclose(getattr(pbk, name).numpy(),
                                       np.asarray(getattr(jbk, name)),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(pbk.ordered_frame_ids.numpy(),
                                      np.asarray(jbk.ordered_frame_ids))
        for arrs, jarrs in ((pbk.k, jbk.k), (pbk.v, jbk.v),
                            (pbk.id_v, jbk.id_v)):
            np.testing.assert_array_equal(arrs[0].numpy(),
                                          np.asarray(jarrs[0]))
    assert non_fifo > 0, 'some eviction must pick other than the oldest'
