"""The multi-head DeAOT path of the PyTorch port (att_heads > 1, the
`no_memory_gap` configs): kernel B3's plain version, the modules that reach
it and the engine as a whole, against the JAX package on the same numpy
inputs and weights (carried across by params_from_flax), on the CPU.

The JAX side runs its Pallas kernels in interpret mode (RMEM_PALLAS=1 where
a module chooses); the port's wrappers run their plain versions on CPU
tensors. The CUDA kernel itself is held to the plain version in
tests/test_torch_kernels_cuda.py.

The VOS model's temporal PE is d/2 wide while a two-head DeAOT query is d
wide, and the JAX package adds one to the other (models/gpm.py:121), so it
cannot build r50_deaotl with both no_memory_gap and use_temporal_pe; the
model-level cases here switch the PE off. The PE-on-keys branch of the
multi-head bank read is held at module level, with a PE of the right width.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.engine import InferEngine as JaxEngine
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.models.gpm import GPMBlock as JaxGPMBlock
from rmem_ocu_tpu.ops.attention import GatedPropagation as JaxGated
from rmem_ocu_tpu.ops.attention import LocalGatedPropagation as JaxLocal
from rmem_ocu_tpu.ops.pallas.memory_read import \
    memory_read_attention as jax_memory_read_attention
from rmem_ocu_tpu.ops.pallas.memory_read import \
    memory_read_multihead as jax_memory_read_multihead

from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
from rmem_ocu_tpu_torch.models.gpm import GPMBlock
from rmem_ocu_tpu_torch.models.lstt import bank_key_bias
from rmem_ocu_tpu_torch.ops.attention import (GatedPropagation,
                                              LocalGatedPropagation,
                                              scaled_dot_attention)
from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import (
    memory_read_attention, memory_read_multihead)
from rmem_ocu_tpu_torch.utils.convert import params_from_flax
from test_torch_kernels_cuda import _b3_inputs
from test_torch_modules import _close, _perturb

CFG = get_config('pre_vost_2', model='r50_deaotl').model
T = torch.from_numpy


def _fold(x, heads):
    """[B, ..., H*n] -> [B*H, ..., n], the JAX wrapper's head fold."""
    b, n = x.shape[0], x.shape[-1] // heads
    x = np.moveaxis(x.reshape(*x.shape[:-1], heads, n), -2, 1)
    return np.ascontiguousarray(x.reshape(b * heads, *x.shape[2:]))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('heads', [2, 4])
def test_plain_multihead_read_matches_pallas(heads, dtype):
    """memory_read_multihead (storage layout) against the JAX wrapper over
    the Pallas kernel B3 in interpret mode: a dead slot in the middle, a
    free last slot, HWk = 36. Operands are bf16 on both sides whatever the
    storage; p is rounded per slot on both (a 36-key slot is one Pallas key
    block), so f32 storage agrees to summation order, 1e-4. bf16 storage
    adds the rounding of q * scale and of the inputs, the same on both
    sides: the bf16-operand bar of tests/test_torch_kernels.py, 1e-3."""
    q, k, v, id_v, valid, scale = _b3_inputs(heads)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cat = np.concatenate([v, id_v], -1)
    want, want_mass = jax_memory_read_multihead(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(cat, jdt),
        jnp.asarray(valid), heads, scale, interpret=True)
    tol = 1e-4 if dtype == 'float32' else 1e-3
    for v_bank in ((T(v).to(tdt), T(id_v).to(tdt)), T(cat).to(tdt)):
        got, got_mass = memory_read_multihead(
            T(q).to(tdt), T(k).to(tdt), v_bank, T(valid), heads, scale)
        assert got.dtype == got_mass.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(got_mass.numpy(), np.asarray(want_mass),
                                   rtol=1e-4, atol=1e-4)
    m = got_mass.numpy()
    assert np.abs(m[~np.broadcast_to(valid[:, None], m.shape)]).max() == 0
    np.testing.assert_allclose(m.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize('precise', [True, False], ids=['precise', 'bf16'])
def test_plain_folded_read_matches_pallas_and_dense_softmax(precise):
    """memory_read_attention (head-folded layout) against the Pallas kernel
    in interpret mode, and, in precise mode, against one dense softmax over
    the flattened bank with the dead slots masked by bank_key_bias."""
    heads = 2
    q, k, v, id_v, valid, scale = _b3_inputs(heads, seed=1)
    qf, kf = _fold(q * np.float32(scale), heads), _fold(k, heads)
    vf = _fold(np.concatenate([v, id_v], -1), heads)
    lf = np.repeat(valid, heads, axis=0)
    want, want_mass = jax_memory_read_attention(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf),
        jnp.asarray(lf.astype(np.int32)), block_k=36, interpret=True,
        precise=precise)
    got, got_mass = memory_read_attention(T(qf), T(kf), T(vf), T(lf),
                                          precise=precise)
    tol = 1e-5 if precise else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got_mass.numpy(), np.asarray(want_mass),
                               rtol=tol, atol=tol)
    if precise:
        bh, t_cap, hwk, d = kf.shape
        dense, dense_mass = scaled_dot_attention(
            T(qf), T(kf).reshape(bh, t_cap * hwk, d),
            T(vf).reshape(bh, t_cap * hwk, -1), 1, scale=1.0,
            key_bias=bank_key_bias(T(lf), hwk), mass_capacity=t_cap)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got_mass.numpy(), dense_mass.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_fused_read_refuses_two_banks_with_several_heads():
    """Kernel B1 shares one probability matrix between two value banks, so
    it takes them at one head only: the port raises the JAX wrapper's
    ValueError, before any device code, where two heads meet two banks."""
    from rmem_ocu_tpu.ops.pallas.memory_read import \
        memory_read_fused as jax_memory_read_fused
    from rmem_ocu_tpu_torch.ops.kernels.memory_read import (
        memory_read_fused, memory_read_fused_plain)
    q, k, v, id_v, valid, scale = _b3_inputs(2)
    with pytest.raises(ValueError):
        jax_memory_read_fused(jnp.asarray(q), jnp.asarray(k),
                              (jnp.asarray(v), jnp.asarray(id_v)),
                              jnp.asarray(valid), 2, scale, interpret=True)
    for read in (memory_read_fused, memory_read_fused_plain):
        with pytest.raises(ValueError, match='num_heads=1'):
            read(T(q), T(k), (T(v), T(id_v)), T(valid), 2, scale)


@pytest.mark.parametrize('heads', [2, 3])
def test_gated_propagation_bank_read_multihead(heads):
    """GatedPropagation.bank_read with several heads: the temporal PE goes
    onto the keys and V||ID_V is read through kernel B3 (two heads: as two
    banks; three: concatenated). 1e-4: bf16 operands on both sides."""
    rng = np.random.RandomState(heads)
    b, (h, w), t_cap, d_att = 2, (5, 6), 4, 16
    hw, e = h * w, 2 * 24 * heads // 2       # even halves of whole heads
    r = lambda *s: rng.randn(*s).astype(np.float32)
    q, u = r(b, hw, heads * d_att), r(b, hw, 2 * e)
    k, v, id_v = (r(b, t_cap, hw, heads * d_att), r(b, t_cap, hw, e),
                  r(b, t_cap, hw, e))
    pe = r(b, t_cap, heads * d_att) * 0.3
    valid = np.ones((b, t_cap), bool)
    valid[0, 1] = False
    kw = dict(d_qk=2 * e, d_vu=e, num_heads=heads, d_att=d_att,
              use_linear=False)
    jmod = JaxGated(**kw)
    j = jnp.asarray
    params = jmod.init(jax.random.PRNGKey(0), j(q), j(k[:, 0]),
                       j(np.concatenate([v, id_v], -1)[:, 0]), j(u), (h, w))
    params = _perturb(params, 3)
    want, want_mass = jmod.apply(
        params, j(q), j(k), j(v), j(id_v), j(u), j(valid), (h, w),
        mem_pe=j(pe), method=JaxGated.bank_read)
    mod = GatedPropagation(**kw).eval()
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    with torch.no_grad():
        got, got_mass = mod.bank_read(T(q), T(k), T(v), T(id_v), T(u),
                                      T(valid), (h, w), mem_pe=T(pe))
    _close(got.numpy(), want)
    _close(got_mass.numpy(), want_mass)


@pytest.mark.parametrize('h,w', [(6, 6), (11, 14)])
def test_local_gated_propagation_multihead(h, w):
    """Two-head LocalGatedPropagation (the dense padded-grid core, grouped
    relative bias) against the JAX module, which takes its dense core for
    more than one head."""
    rng = np.random.RandomState(h + w)
    b, heads, d_att, d_vu = 2, 2, 16, 16
    e = 2 * d_vu
    r = lambda *s: rng.randn(*s).astype(np.float32)
    q, k = r(b, h * w, heads * d_att), r(b, h * w, heads * d_att)
    v, u = r(b, h * w, e), r(b, h * w, e)
    kw = dict(d_qk=2 * d_att * heads, d_vu=d_vu, num_heads=heads, max_dis=7,
              d_att=d_att)
    jmod = JaxLocal(use_linear=False, **kw)
    args = [jnp.asarray(x) for x in (q, k, v, u)]
    params = jmod.init(jax.random.PRNGKey(0), *args, (h, w))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.2 * rng.randn(*x.shape).astype(
            np.float32), jax.device_get(params))
    want, _ = jmod.apply(params, *args, (h, w))
    mod = LocalGatedPropagation(**kw).eval()
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    with torch.no_grad():
        got = mod(T(q), T(k), T(v), T(u), (h, w))
    _close(got.numpy(), want)


@pytest.mark.parametrize('layer_idx,path', [(0, 'reference'),
                                            (1, 'reference'),
                                            (1, 'memory')])
def test_gpm_block_two_heads(layer_idx, path, monkeypatch):
    """One GPMBlock at d_model=64, att_heads=2 on a 5x6 grid, with a
    temporal PE as wide as the two-head query. 'reference': the bank is the
    frame itself (plain gated attention over V||ID_V); 'memory': a 4-slot
    bank with a dead slot (kernel B3, plain on the CPU) and the dense
    two-head short-term attention."""
    monkeypatch.setenv('RMEM_PALLAS', '1')
    rng = np.random.RandomState(30 + layer_idx)
    b, (h, w), d, t_cap, heads = 2, (5, 6), 64, 4, 2
    hw, ck, e = h * w, d, 2 * d
    r = lambda *s: rng.randn(*s).astype(np.float32)
    valid = np.ones((b, t_cap), bool)
    valid[0, 1] = False
    x = dict(tgt=r(b, hw, d), tgt_id=r(b, hw, d), id_emb=r(b, hw, d),
             cur_pe=r(ck) * 0.1, ref_pe=r(b, 1, ck) * 0.1,
             mem_pe=r(b, t_cap, ck) * 0.1,
             long=(r(b, t_cap, hw, ck), r(b, t_cap, hw, e),
                   r(b, t_cap, hw, e), valid),
             short=(r(b, hw, ck), r(b, hw, e), r(b, hw, e)))
    j = lambda a: jax.tree_util.tree_map(jnp.asarray, a)
    t = lambda a: (None if a is None else
                   tuple(map(t, a)) if isinstance(a, tuple) else T(a))
    jtgt_id = None if layer_idx == 0 else j(x['tgt_id'])
    jmod = JaxGPMBlock(d_model=d, att_heads=heads, layer_idx=layer_idx)
    params = jmod.init(jax.random.PRNGKey(layer_idx), j(x['tgt']), jtgt_id,
                       None, None, j(x['id_emb']), (h, w),
                       (j(x['cur_pe']), j(x['ref_pe'])))
    params = _perturb(params, 40 + layer_idx)
    if path == 'reference':
        names = (None, None, 'id_emb', 'ref_pe')
    else:
        names = ('long', 'short', None, 'mem_pe')
    pick = lambda f: tuple(None if n is None else f(x[n]) for n in names)
    jl, js, jid, jpe = pick(j)
    tl, ts, tid, tpe = pick(t)
    need_mass = path == 'memory'
    w_tgt, w_id, w_mems, w_mass = jmod.apply(
        params, j(x['tgt']), jtgt_id, jl, js, jid, (h, w),
        (j(x['cur_pe']), jpe), need_mass=need_mass)
    mod = GPMBlock(d, att_heads=heads, layer_idx=layer_idx).eval()
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    with torch.no_grad():
        g_tgt, g_id, g_mems, g_mass = mod(
            t(x['tgt']), None if layer_idx == 0 else t(x['tgt_id']), tl, ts,
            tid, (h, w), (t(x['cur_pe']), tpe), need_mass=need_mass)
    _close(g_tgt.numpy(), w_tgt)
    _close(g_id.numpy(), w_id)
    for key in ('curr_k', 'curr_v', 'global_id_v_fused'):
        if key in w_mems:
            _close(g_mems[key].numpy(), w_mems[key])
    if need_mass:
        _close(g_mass.numpy(), w_mass)
    else:
        assert g_mass is None


SIZE, FRAMES, OBJ = 65, 6, [2, 3]
OVERRIDES = dict(model='r50_deaotl', no_memory_gap=True,
                 use_temporal_pe=False, latter_mem_len=2)


def _clip():
    rng = np.random.RandomState(12)
    img0 = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    mask0 = (rng.rand(2, SIZE, SIZE) * np.array([3, 4])[:, None, None]
             ).astype(np.int32)
    frames = [(rng.randn(2, SIZE, SIZE, 3) * 0.5 + img0).astype(np.float32)
              for _ in range(FRAMES)]
    return img0, mask0, frames


def run_jax_engine(exp, params, img0, mask0, frames, grid=(5, 5)):
    """The JAX engine at write gap 1: (logits, mask, eviction mass, frame
    ids, ordered ids) per frame, and the final state."""
    eng = JaxEngine(jax_build(exp.model), exp, long_term_mem_gap=1)
    st = eng.init_state(img0.shape[0], grid)
    st = eng.add_reference_frame(params, st, jnp.asarray(img0),
                                 jnp.asarray(mask0), jnp.array(OBJ, jnp.int32))
    out = []
    for f in frames:
        logits, st = eng.propagate(params, st, jnp.asarray(f))
        pred = eng.predict_mask(logits, img0.shape[1:3])
        mass = np.asarray(st.pending_mass)
        st = eng.update_memory(params, st, pred)
        out.append((np.asarray(logits), np.asarray(pred), mass,
                    np.asarray(st.bank.frame_ids),
                    np.asarray(st.bank.ordered_frame_ids)))
    return out, st


def run_port_engine(exp, state_dict, img0, mask0, frames, grid=(5, 5)):
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(state_dict, strict=True)
    eng = InferEngine(model, exp, long_term_mem_gap=1)
    st = eng.init_state(img0.shape[0], grid)
    st = eng.add_reference_frame(st, T(img0), T(mask0), torch.tensor(OBJ))
    out = []
    for f in frames:
        logits, st = eng.propagate(st, T(f))
        pred = eng.predict_mask(logits, img0.shape[1:3])
        mass = st.pending_mass.numpy().copy()
        st = eng.update_memory(st, pred)
        out.append((logits.numpy(), pred.numpy(), mass,
                    st.bank.frame_ids.numpy(),
                    st.bank.ordered_frame_ids.numpy()))
    return out, st


def assert_engines_agree(want, got, budget):
    """The bars of tests/test_pallas_regression.py: eviction ids identical
    at every step, > 99.9% of mask pixels equal, logits within 1e-3, mass
    within 1e-4; and the clip must evict."""
    evicted, prev = np.zeros(len(want[0][4]), bool), None
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
        if prev is not None:        # a frame id left the bank
            evicted |= [bool(set(p[p >= 0]) - set(o[o >= 0]))
                        for p, o in zip(prev, w_ord)]
        prev = w_ord
    assert evicted.all(), 'the clip must exercise eviction in every stream'
    final = got[-1][4]
    assert (final[:, 0] == 0).all() and ((final >= 0).sum(1) == budget).all()


def test_two_head_deaot_engine_matches_jax_engine(monkeypatch):
    """r50_deaotl with no_memory_gap (att_heads = 2) at 65x65, two streams,
    latter_mem_len=2 and write gap 1, so that eviction fires from the third
    frame on. The JAX engine reads its bank through the Pallas kernel B3 in
    interpret mode."""
    monkeypatch.setenv('RMEM_PALLAS', '1')
    img0, mask0, frames = _clip()
    jexp = jax_get_config('pre_vost_2', **OVERRIDES)
    assert jexp.model.att_heads == 2
    params = jax.device_get(jax.jit(jax_build(jexp.model).init)(
        jax.random.PRNGKey(0), jnp.asarray(img0[:1]),
        jnp.zeros((1, SIZE, SIZE, jexp.model.id_dim))))
    want, _ = run_jax_engine(jexp, params, img0, mask0, frames)
    exp = get_config('pre_vost_2', **OVERRIDES)
    got, _ = run_port_engine(exp, params_from_flax(params, exp.model), img0,
                             mask0, frames)
    assert_engines_agree(want, got, budget=3)
