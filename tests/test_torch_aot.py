"""The AOT family of the PyTorch port (r50_aotl: LSTT blocks, multi-head
attention, the FPN head over every LSTT layer, banks without ID_V, ConvGRU
memory compression) against the JAX package on the same numpy inputs and
weights (carried across by params_from_flax), fp32 on the CPU.

The JAX side runs its Pallas kernel B1 in interpret mode (RMEM_PALLAS=1
where a module chooses); the port's wrapper runs its plain version on CPU
tensors. Bar for modules: 1e-4 (summation order; the bank read has bf16
operands on both sides). The engine bars are those of
tests/test_pallas_regression.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.memory import bank as jax_bank
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.models.decoders.fpn import FPNSegmentationHead as JaxFPN
from rmem_ocu_tpu.models.gru import ConvGRUCellOutput as JaxGRU
from rmem_ocu_tpu.models.lstt import LSTTBlock as JaxLSTTBlock
from rmem_ocu_tpu.models.lstt import bank_key_bias as jax_bank_key_bias
from rmem_ocu_tpu.ops.attention import MultiheadAttention as JaxMHA
from rmem_ocu_tpu.ops.layers import GNActDWConv2d as JaxGNAct
from rmem_ocu_tpu.utils.torch_convert import convert_torch_params

from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.memory import bank
from rmem_ocu_tpu_torch.models.decoders.fpn import FPNSegmentationHead
from rmem_ocu_tpu_torch.models.gru import ConvGRUCellOutput
from rmem_ocu_tpu_torch.models.lstt import LSTTBlock, bank_key_bias
from rmem_ocu_tpu_torch.ops.attention import MultiheadAttention
from rmem_ocu_tpu_torch.ops.layers import GNActDWConv2d
from rmem_ocu_tpu_torch.utils.convert import params_from_flax
from test_torch_convert import _reference_keys
from test_torch_modules import _close, _perturb
from test_torch_multihead import (FRAMES, SIZE, _clip, assert_engines_agree,
                                  run_jax_engine, run_port_engine)

CFG = get_config('pre_vost_2', model='r50_aotl').model
T = torch.from_numpy
J = jnp.asarray


def _bank_inputs(rng, b, hw, d, t_cap):
    r = lambda *s: rng.randn(*s).astype(np.float32)
    valid = np.ones((b, t_cap), bool)
    valid[0, 1] = False
    return r(b, t_cap, hw, d) * 0.5, r(b, t_cap, hw, d), valid


@pytest.mark.parametrize('use_linear', [True, False])
def test_multihead_attention(use_linear):
    """MultiheadAttention at 8 heads of 8: the dense call with a key bias
    and the in-place mass reduction, and bank_read (kernel B1, multi-head,
    one bank, PE as the logit term) against the JAX module's."""
    rng = np.random.RandomState(1)
    b, hw, d, t_cap, heads = 2, 30, 64, 4, 8
    r = lambda *s: rng.randn(*s).astype(np.float32)
    q = r(b, hw, d)
    k_bank, v_bank, valid = _bank_inputs(rng, b, hw, d, t_cap)
    pe = r(b, t_cap, d) * 0.3
    jmod = JaxMHA(d, heads, use_linear=use_linear)
    flat_k, flat_v = (k_bank.reshape(b, t_cap * hw, d),
                      v_bank.reshape(b, t_cap * hw, d))
    params = _perturb(jmod.init(jax.random.PRNGKey(0), J(q), J(flat_k),
                                J(flat_v)), 2)
    mod = MultiheadAttention(d, heads, use_linear=use_linear)
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)

    jbias = jax_bank_key_bias(J(valid), hw)
    bias = bank_key_bias(T(valid), hw)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    want, want_mass = jmod.apply(params, J(q), J(flat_k), J(flat_v),
                                 key_bias=jbias, mass_capacity=t_cap)
    with torch.no_grad():
        got, got_mass = mod(T(q), T(flat_k), T(flat_v), key_bias=bias,
                            mass_capacity=t_cap)
    _close(got.numpy(), want)
    _close(got_mass.numpy(), want_mass)

    if not use_linear:         # the long-term attention has no projections
        want, want_mass = jmod.apply(
            params, J(q), J(k_bank), J(v_bank), J(valid), mem_pe=J(pe),
            method=JaxMHA.bank_read)
        with torch.no_grad():
            got, got_mass = mod.bank_read(T(q), T(k_bank), T(v_bank),
                                          T(valid), mem_pe=T(pe))
        _close(got.numpy(), want)
        _close(got_mass.numpy(), want_mass)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gn_act_dwconv(dtype):
    """GroupNorm(32) -> GELU -> depthwise 5x5: erf-GELU on f32 (1e-4),
    tanh-GELU on bf16 on both sides. In bf16 the two frameworks round the
    normalised map and the conv sums at different places: every element
    within two bf16 ulps relative plus 2% of the output's RMS."""
    rng = np.random.RandomState(3)
    b, (h, w), dim = 2, (5, 6), 64
    x = rng.randn(b, h * w, dim).astype(np.float32)
    jmod = JaxGNAct(dim)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), J(x), (h, w)), 4)
    mod = GNActDWConv2d(dim)
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    if dtype == 'float32':
        want = jmod.apply(params, J(x), (h, w))
        with torch.no_grad():
            got = mod(T(x), (h, w))
        _close(got.numpy(), want)
        return
    jparams = jax.tree_util.tree_map(lambda a: J(a, jnp.bfloat16), params)
    want = np.asarray(jmod.apply(jparams, J(x, jnp.bfloat16), (h, w))
                      .astype(jnp.float32))
    with torch.no_grad():
        got = mod.to(torch.bfloat16)(T(x).to(torch.bfloat16), (h, w))
    assert got.dtype == torch.bfloat16
    rms = float(np.sqrt((want ** 2).mean()))
    assert (np.abs(got.float().numpy() - want)
            <= 0.02 * rms + 2 ** -7 * np.abs(want)).all()


@pytest.mark.parametrize('path,linear_q', [('reference', False),
                                           ('memory', False),
                                           ('memory', True)])
def test_lstt_block(path, linear_q, monkeypatch):
    """One LSTTBlock at d_model=64, 8 heads, on a 5x6 grid. 'reference':
    the id embedding is given and the memory is the frame itself (plain
    read with the PE on the keys, mass of the one slot); 'memory': a 4-slot
    bank with a dead slot (kernel B1, plain on the CPU) and the short-term
    pair, through norm4 or, with linear_q, concatenated."""
    monkeypatch.setenv('RMEM_PALLAS', '1')
    rng = np.random.RandomState(5)
    b, (h, w), d, t_cap = 2, (5, 6), 64, 4
    hw = h * w
    r = lambda *s: rng.randn(*s).astype(np.float32)
    tgt, id_emb, self_pos = r(b, hw, d), r(b, hw, d), r(1, hw, d)
    cur_pe, ref_pe, mem_pe = r(d) * 0.1, r(b, 1, d) * 0.1, r(b, t_cap, d) * 0.1
    long = _bank_inputs(rng, b, hw, d, t_cap)
    short = (r(b, hw, d), r(b, hw, d))
    jmod = JaxLSTTBlock(d, 8, 8, 128, 0.0, linear_q, False)
    params = _perturb(jmod.init(
        jax.random.PRNGKey(0), J(tgt), None, None, J(id_emb), J(self_pos),
        (h, w), (J(cur_pe), J(ref_pe))), 6)
    mod = LSTTBlock(d, 8, 8, dim_feedforward=128, linear_q=linear_q).eval()
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    if path == 'reference':
        jargs = (None, None, J(id_emb), J(self_pos), (h, w),
                 (J(cur_pe), J(ref_pe)))
        args = (None, None, T(id_emb), T(self_pos), (h, w),
                (T(cur_pe), T(ref_pe)))
    else:
        jargs = (tuple(map(J, long)), tuple(map(J, short)), None,
                 J(self_pos), (h, w), (J(cur_pe), J(mem_pe)))
        args = (tuple(map(T, long)), tuple(map(T, short)), None,
                T(self_pos), (h, w), (T(cur_pe), T(mem_pe)))
    w_tgt, w_mems, w_mass = jmod.apply(params, J(tgt), *jargs,
                                       need_mass=True)
    with torch.no_grad():
        g_tgt, g_mems, g_mass = mod(T(tgt), *args, need_mass=True)
    _close(g_tgt.numpy(), w_tgt)
    assert set(g_mems) == set(w_mems)
    for key, want in w_mems.items():
        _close(g_mems[key].numpy(), want)
    _close(g_mass.numpy(), w_mass)
    v, idv = r(b, hw, d), r(b, hw, d)
    for name in ('fuse_curr_value', 'fuse_local_value'):
        want = jmod.apply(params, J(v), J(idv), method=getattr(JaxLSTTBlock,
                                                               name))
        with torch.no_grad():
            _close(getattr(mod, name)(T(v), T(idv)).numpy(), want)


def test_fpn_with_intermediate_inputs():
    """The FPN head over the 16x encoder map and every LSTT layer's output,
    concatenated (decode_intermediate_input, the AOT family)."""
    rng = np.random.RandomState(7)
    b, hid, dims = 2, 32, (8, 16, 24, 24)
    sizes = ((17, 21), (9, 11), (5, 6), (5, 6))
    r = lambda *s: rng.randn(*s).astype(np.float32)
    shortcuts = [r(b, *hw, c) for hw, c in zip(sizes, dims)]
    shortcuts[-1] = r(b, 5, 6, hid)               # projected to the width
    inputs = [shortcuts[-1]] + [r(b, 5, 6, hid) for _ in range(3)]
    jmod = JaxFPN(out_dim=11, hidden_dim=hid, decode_intermediate_input=True)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), list(map(J, inputs)),
                                list(map(J, shortcuts))), 8)
    want = jmod.apply(params, list(map(J, inputs)), list(map(J, shortcuts)))
    mod = FPNSegmentationHead(in_dim=4 * hid, out_dim=11, shortcut_dims=dims,
                              hidden_dim=hid, decode_intermediate_input=True)
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    nchw = lambda xs: [T(x).permute(0, 3, 1, 2) for x in xs]
    with torch.no_grad():
        got = mod(nchw(inputs), nchw(shortcuts))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('kernel', [(2, 2), (1, 1)], ids=['2x2', '1x1'])
def test_conv_gru_cell_output(kernel):
    """The ConvGRU compressors (K: 2x2 gates, V: 1x1). The even kernel's
    'SAME' padding is none before and one cell after; a conv padded the
    other way round fails this by O(1)."""
    rng = np.random.RandomState(9)
    b, (h, w), d = 2, (5, 6), 16
    x = rng.randn(b, h * w, d).astype(np.float32)
    hid = rng.randn(b, h * w, d).astype(np.float32)
    jmod = JaxGRU(d, kernel_size=kernel)
    params = _perturb(jmod.init(jax.random.PRNGKey(0), J(x), J(hid), (h, w)),
                      10)
    mod = ConvGRUCellOutput(d, kernel_size=kernel)
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    want_h, want_o = jmod.apply(params, J(x), J(hid), (h, w))
    with torch.no_grad():
        got_h, got_o = mod(T(x), T(hid), (h, w))
    _close(got_h.numpy(), want_h)
    _close(got_o.numpy(), want_o)


def test_bank_without_id_and_gru_scoring_match_jax():
    """A 1+3(+1) bank without ID_V, scored with the gru_memory terms
    (logical slot 1 protected and pinned) and written with the compressed
    (K, V) on eviction, step by step against the JAX bank."""
    rng = np.random.RandomState(11)
    b, cap, hw = 3, 5, 4
    jbk = jax_bank.init_bank(1, b, cap, hw, 2, 3, False)
    pbk = bank.init_bank(1, b, cap, hw, 2, 3, torch.float32, 'cpu',
                         with_id=False)
    assert pbk.id_v is None
    evictions = 0
    for step in range(16):
        new = [rng.randn(b, hw, c).astype(np.float32) for c in (2, 3)]
        on = rng.rand(b) < 0.8
        jbk = jax_bank.append_frame(jbk, (J(new[0]),), (J(new[1]),), None,
                                    step, enabled=J(on))
        bank.append_frame(pbk, [T(new[0])], [T(new[1])], None, step,
                          enabled=T(on))
        over = on & (np.asarray(jbk.length) > 4)
        mass = (rng.rand(b, hw, cap) ** 4).astype(np.float32)
        jdrop, jbk = jax_bank.eviction_scores_and_update(
            jbk, J(mass), gru_memory=True, enabled=J(over))
        drop = bank.eviction_scores_and_update(pbk, T(mass), gru_memory=True,
                                               enabled=T(over))
        np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
        assert (drop.numpy()[over] >= 2).all()
        evictions += int(over.sum())
        comp = [rng.randn(b, hw, c).astype(np.float32) for c in (2, 3)]
        jbk = jax_bank.evict_frame(
            jbk, jdrop, enabled=J(over),
            compressed_kv=((J(comp[0]),), (J(comp[1]),), None))
        bank.evict_frame(pbk, drop, enabled=T(over),
                         compressed_kv=([T(comp[0])], [T(comp[1])]))
        for name in ('length', 'pos', 'frame_ids', 'ema_present'):
            np.testing.assert_array_equal(getattr(pbk, name).numpy(),
                                          np.asarray(getattr(jbk, name)),
                                          err_msg=f'{name} step {step}')
        for name in ('attn_ema', 'visits'):
            np.testing.assert_allclose(getattr(pbk, name).numpy(),
                                       np.asarray(getattr(jbk, name)),
                                       rtol=1e-6, atol=1e-6)
        for arrs, jarrs in ((pbk.k, jbk.k), (pbk.v, jbk.v)):
            np.testing.assert_array_equal(arrs[0].numpy(),
                                          np.asarray(jarrs[0]))
    assert evictions > 5


@pytest.mark.parametrize('gru_memory', [False, True], ids=['aot', 'aot_gru'])
def test_aot_engine_matches_jax_engine(gru_memory, monkeypatch):
    """r50_aotl (LSTT x3, 8 heads, temporal PE, norm4 short-term read, FPN
    over every layer) at 65x65, two streams, latter_mem_len=2 (3 with the
    ConvGRU, whose slot 1 is protected) and write gap 1, so that eviction
    fires within the clip. The JAX engine reads its bank through the Pallas
    kernel B1 in interpret mode. With gru_memory the bank's K/V (slot 1 is
    the ConvGRU's output) and the hidden states are held too."""
    monkeypatch.setenv('RMEM_PALLAS', '1')
    img0, mask0, frames = _clip()
    kw = dict(model='r50_aotl', latter_mem_len=3 if gru_memory else 2,
              gru_memory=gru_memory)
    jexp = jax_get_config('pre_vost_2', **kw)
    params = jax.device_get(jax.jit(jax_build(jexp.model).init)(
        jax.random.PRNGKey(0), J(img0[:1]),
        jnp.zeros((1, SIZE, SIZE, jexp.model.id_dim))))
    want, jst = run_jax_engine(jexp, params, img0, mask0, frames)
    exp = get_config('pre_vost_2', **kw)
    assert exp.model.vos == 'aot' and not exp.model.linear_q
    got, st = run_port_engine(exp, params_from_flax(params, exp.model), img0,
                              mask0, frames)
    assert_engines_agree(want, got, budget=1 + kw['latter_mem_len'])
    assert st.bank.id_v is None and st.pending_id_v is None
    if gru_memory:
        assert len(frames) == FRAMES and (want[-1][4][:, 2] != 2).all()
        for got_arrs, want_arrs in ((st.bank.k, jst.bank.k),
                                    (st.bank.v, jst.bank.v),
                                    (st.gru_hidden_k, jst.gru_hidden_k),
                                    (st.gru_hidden_v, jst.gru_hidden_v)):
            for g, w in zip(got_arrs, want_arrs):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-3, atol=1e-3)
        assert float(st.gru_hidden_k[0].abs().max()) > 0


@pytest.mark.parametrize('overrides', [
    dict(model='r50_aotl'), dict(model='r50_aotl', gru_memory=True),
    dict(model='r50_deaotl', no_memory_gap=True, use_temporal_pe=False)],
    ids=['r50_aotl', 'r50_aotl_gru', 'r50_deaotl_two_heads'])
def test_flax_weights_load_strictly(overrides):
    """params_from_flax gives exactly the reference torch keys, a strict
    load accepts them, and the JAX package's own converter brings every
    leaf back unchanged."""
    jexp = jax_get_config('pre_vost_2', **overrides)
    shapes = jax.eval_shape(
        jax_build(jexp.model).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 33, 33, 3)), jnp.zeros((1, 33, 33, jexp.model.id_dim)))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), shapes)
    exp = get_config('pre_vost_2', **overrides)
    model = build_vos_model(exp.model, device='cpu')
    sd = params_from_flax(params, exp.model)
    assert set(sd) == set(model.state_dict()) == _reference_keys(
        params, jexp.model)
    model.load_state_dict(sd, strict=True)
    back, missing = convert_torch_params(model.state_dict(), params,
                                         jexp.model)
    assert not missing
    for (kp, w), g in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                          jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(g), w,
                                      err_msg=jax.tree_util.keystr(kp))
