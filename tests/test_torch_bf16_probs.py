"""RMEM_BF16_PROBS=0 in the PyTorch port against the JAX package, on the CPU.

By default bf16 attention stores its QK logits and its probabilities in
bf16 around an f32 softmax; `RMEM_BF16_PROBS` set to '0', 'false' or
'False' keeps both in f32 storage at the plain attention sites
(`scaled_dot_attention`, `GatedPropagation.multi_value_call`,
`LocalGatedPropagation._dense_core`, Swin's `WindowAttention`), in both
packages. The JAX package reads the variable while tracing, so every
setting here clears its caches (a function traced under another setting
would keep it). Inputs come from a numpy seed, weights from the flax init
carried across with params_from_flax.

Each site runs in bf16 with the switch set on both sides, and is held to
the JAX package within the tolerance stated in its case; its mean
difference to the JAX package with the switch must also be smaller than
its mean difference to the JAX package at the default, which shows that
the port follows the switch. The kernels' plain versions (B1, B2, B3)
ignore the switch, as the JAX package's Pallas kernels do.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.models.encoders.swin import WindowAttention as JaxWindow
from rmem_ocu_tpu.ops import attention as jattention
from rmem_ocu_tpu.ops import layers as jlayers
from rmem_ocu_tpu.utils.precision import cast_floating

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
from rmem_ocu_tpu_torch.config import get_model_config
from rmem_ocu_tpu_torch.models.encoders.swin import (WindowAttention,
                                                     shifted_window_mask)
from rmem_ocu_tpu_torch.ops.attention import (GatedPropagation,
                                              LocalGatedPropagation,
                                              _compact, bf16_probs,
                                              qk_logits,
                                              scaled_dot_attention)
from rmem_ocu_tpu_torch.ops.kernels.local_attn import local_window_attention
from rmem_ocu_tpu_torch.ops.kernels.memory_read import memory_read_fused
from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import \
    memory_read_multihead
from rmem_ocu_tpu_torch.ops.resize import interpolate_bilinear
from rmem_ocu_tpu_torch.utils.convert import params_from_flax
from test_torch_kernels_cuda import _b1_inputs, _b3_inputs
from test_torch_modules import _perturb
from test_torch_multihead import (OBJ, OVERRIDES, SIZE, _clip,
                                  run_jax_engine)

CFG = get_model_config('r50_deaotl')
OFF = ('0', 'false', 'False')
BF16_ULP = 2.0 ** -8          # bf16's spacing at [1, 2)


@pytest.fixture
def switch(monkeypatch):
    """switch(value) sets RMEM_BF16_PROBS (None: unset) for both packages;
    the JAX package's caches are cleared at each setting and after the
    test, so that no trace outlives its setting."""
    def set_to(value):
        if value is None:
            monkeypatch.delenv('RMEM_BF16_PROBS', raising=False)
        else:
            monkeypatch.setenv('RMEM_BF16_PROBS', value)
        jax.clear_caches()
    yield set_to
    jax.clear_caches()


@pytest.mark.parametrize('value', ['0', 'false', 'False', None, '1',
                                   'FALSE'])
def test_switch_is_read_at_call_time(value, switch):
    """The three 'off' values of the JAX package turn f32 storage on; unset
    or any other value keeps bf16. The port decides as the JAX package's
    `_qk_out_dtype` does, and a change of the variable takes effect at the
    next call. f32 inputs stay f32 either way."""
    rng = torch.Generator().manual_seed(0)
    q, k = (torch.randn(2, 5, 8, generator=rng).to(torch.bfloat16)
            for _ in range(2))
    switch(None)
    assert bf16_probs() and qk_logits(q, k, 0.5).dtype == torch.bfloat16
    switch(value)
    f32 = value in OFF
    assert bf16_probs() is not f32
    assert (jattention._qk_out_dtype(jnp.bfloat16) == jnp.float32) is f32
    want = torch.float32 if f32 else torch.bfloat16
    logits = qk_logits(q, k, 0.5)
    assert logits.dtype == want
    assert _compact(logits.float(), torch.bfloat16).dtype == want
    # the f32 logits are the bf16 product's sums before its one rounding
    torch.testing.assert_close(logits.to(torch.bfloat16),
                               (q * 0.5) @ k.transpose(-1, -2),
                               rtol=0, atol=0)
    assert qk_logits(q.float(), k.float(), 0.5).dtype == torch.float32
    assert _compact(logits.float(), torch.float32).dtype == torch.float32


# ------------------------------------------------------------ the sites
J = lambda x: jnp.asarray(x, jnp.bfloat16)
T = lambda x: torch.from_numpy(x).to(torch.bfloat16)


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_tree(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  params)


def _sdpa(rng):
    """scaled_dot_attention over 3 slots of 30 keys, 2 heads, a key bias
    that masks a fifth of the keys, with the per-slot mass."""
    b, lq, t, hwk, heads = 2, 30, 3, 30, 2
    q = rng.randn(b, lq, heads * 16).astype(np.float32)
    k = rng.randn(b, t * hwk, heads * 16).astype(np.float32)
    v = rng.randn(b, t * hwk, heads * 24).astype(np.float32)
    bias = np.where(rng.rand(b, 1, 1, t * hwk) < 0.2, -1e9,
                    0.0).astype(np.float32)

    def jax_side():
        return jattention.scaled_dot_attention(
            J(q), J(k), J(v), heads, key_bias=jnp.asarray(bias),
            mass_capacity=t)

    def port_side():
        return scaled_dot_attention(T(q), T(k), T(v), heads,
                                    key_bias=torch.from_numpy(bias),
                                    mass_capacity=t)
    return jax_side, port_side


def _multi_value(rng):
    """GatedPropagation.multi_value_call (one head, V and ID_V sharing the
    probabilities) over 3 slots of a 5x6 grid, with a key bias and mass."""
    b, (h, w), t, e, d_att = 2, (5, 6), 3, 24, 16
    hw = h * w
    q = rng.randn(b, hw, d_att).astype(np.float32)
    k = rng.randn(b, t * hw, d_att).astype(np.float32)
    vs = [rng.randn(b, t * hw, e).astype(np.float32) for _ in range(2)]
    u = rng.randn(b, hw, 2 * e).astype(np.float32)
    bias = np.where(rng.rand(b, 1, 1, t * hw) < 0.2, -1e9,
                    0.0).astype(np.float32)
    kw = dict(d_qk=2 * e, d_vu=e, num_heads=1, d_att=d_att,
              use_linear=False)
    jmod = jattention.GatedPropagation(**kw)
    params = _perturb(jmod.init(
        jax.random.PRNGKey(0), *(jnp.asarray(x) for x in (q, k)),
        [jnp.asarray(x) for x in vs], jnp.asarray(u), (h, w),
        method=jattention.GatedPropagation.multi_value_call), 3)
    mod = GatedPropagation(**kw).eval()
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    mod = mod.to(torch.bfloat16)

    def jax_side():
        return jmod.apply(_bf16_tree(params), J(q), J(k), [J(x) for x in vs],
                          J(u), (h, w), key_bias=jnp.asarray(bias),
                          mass_capacity=t,
                          method=jattention.GatedPropagation.multi_value_call)

    def port_side():
        return mod.multi_value_call(T(q), T(k), [T(x) for x in vs], T(u),
                                    (h, w), key_bias=torch.from_numpy(bias),
                                    mass_capacity=t)
    return jax_side, port_side


def _local(rng, heads, training):
    """LocalGatedPropagation on an 11x14 grid through the dense padded-grid
    core: 2 heads in eval mode, or 1 head in training mode at dropout 0
    (the JAX DWConv2d's channel dropout is not a config field: its call
    runs deterministic)."""
    (h, w), b, d_att = (11, 14), 2, 16
    q, k = (rng.randn(b, h * w, heads * d_att).astype(np.float32)
            for _ in range(2))
    v, u = (rng.randn(b, h * w, 32).astype(np.float32) for _ in range(2))
    kw = dict(d_qk=2 * d_att * heads, d_vu=16, num_heads=heads, max_dis=7,
              d_att=d_att)
    jmod = jattention.LocalGatedPropagation(use_linear=False, **kw)
    params = jmod.init(jax.random.PRNGKey(0),
                       *(jnp.asarray(x) for x in (q, k, v, u)), (h, w))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.2 * rng.randn(*x.shape).astype(
            np.float32), jax.device_get(params))
    mod = LocalGatedPropagation(**kw)
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    mod.dw_conv.dropout = 0.0
    mod = mod.to(torch.bfloat16).train(training)

    def jax_side():
        mp = pytest.MonkeyPatch()
        orig = jlayers.DWConv2d.__call__
        mp.setattr(jlayers.DWConv2d, '__call__',
                   lambda self, x, size_2d, deterministic=True:
                   orig(self, x, size_2d, True))
        try:
            out, _ = jmod.apply(_bf16_tree(params),
                             *(J(x) for x in (q, k, v, u)), (h, w),
                             deterministic=not training,
                             rngs={'dropout': jax.random.PRNGKey(1)})
        finally:
            mp.undo()
        return (out,)

    def port_side():
        return (mod(*(T(x) for x in (q, k, v, u)), (h, w)),)
    return jax_side, port_side


def _window(rng, shifted):
    """Swin's WindowAttention: 4 heads over two images of four 7x7
    windows, unshifted or with the shifted-window mask of a 14x14 map;
    the relative bias table drawn at unit scale, so that the bias matters
    next to the logits."""
    dim, ws, heads = 64, 7, 4
    x = rng.randn(8, ws * ws, dim).astype(np.float32)
    mask = shifted_window_mask(14, 14, ws, 3) if shifted else None
    jmod = JaxWindow(dim=dim, window_size=ws, num_heads=heads)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x),
        None if mask is None else jnp.asarray(mask))))
    table = params['params']['relative_position_bias_table']
    params['params']['relative_position_bias_table'] = rng.randn(
        *table.shape).astype(np.float32)
    mod = WindowAttention(dim, ws, heads)
    mod.load_state_dict(params_from_flax(params, CFG), strict=True)
    mod = mod.to(torch.bfloat16).eval()

    def jax_side():
        return (jmod.apply(_bf16_tree(params), J(x),
                           None if mask is None else jnp.asarray(mask)),)

    def port_side():
        return (mod(T(x), None if mask is None else torch.from_numpy(mask)),)
    return jax_side, port_side


# site -> (the function making its two sides, tolerances of its outputs:
# bf16 outputs in bf16 ulps of their largest magnitude (at least 1), f32
# masses absolute)
SITES = {
    'scaled_dot_attention': (_sdpa, (('ulps', 1), ('abs', 1e-6))),
    'multi_value_call': (_multi_value, (('ulps', 1), ('abs', 1e-6))),
    'local_2heads_eval': (lambda r: _local(r, 2, False), (('ulps', 2),)),
    'local_1head_train': (lambda r: _local(r, 1, True), (('ulps', 2),)),
    'window': (lambda r: _window(r, False), (('ulps', 1),)),
    'window_shifted': (lambda r: _window(r, True), (('ulps', 1),)),
}


@pytest.mark.parametrize('site', list(SITES))
def test_site_follows_the_switch_as_jax_does(site, switch):
    """bf16 with RMEM_BF16_PROBS=0 on both sides: each output within its
    tolerance of the JAX package's, and closer on average than to the
    JAX package at the default. The bf16 tolerances are the rounding of
    one or two bf16 outputs: with the switch both packages round the same
    f32 probabilities; the projections around the attention (depthwise
    conv, output linear) round their own sums."""
    make, tols = SITES[site]
    jax_side, port_side = make(np.random.RandomState(7))
    # a jit traced anew under each setting
    switch(None)
    jax_default = [_f32(x) for x in jax.jit(jax_side)()]
    switch('0')
    want = [_f32(x) for x in jax.jit(jax_side)()]
    with torch.no_grad():
        got = [_f32(x) for x in port_side()]
    assert len(got) == len(want) == len(tols)
    for g, w, w0, (kind, tol) in zip(got, want, jax_default, tols):
        err = float(np.abs(g - w).max())
        bar = (tol * BF16_ULP * max(1.0, float(np.abs(w).max()))
               if kind == 'ulps' else tol)
        assert err <= bar, (site, err, bar)
        on, off = float(np.abs(g - w).mean()), float(np.abs(g - w0).mean())
        assert on < off, (site, on, off)


# --------------------------------------------------------- the kernels
@pytest.mark.parametrize('kernel', ['B1', 'B2', 'B3'])
def test_kernel_plain_versions_ignore_the_switch(kernel, switch):
    """On CPU tensors the wrappers run the plain versions, which round as
    the kernels do whatever the switch says (the JAX package's Pallas
    kernels read no environment)."""
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    if kernel == 'B1':
        q, k, vs, valid, pe, scale = _b1_inputs(1, 2, True)
        args = (bf(q), bf(k), tuple(bf(v) for v in vs),
                torch.from_numpy(valid), 1, scale)
        run = lambda: memory_read_fused(*args, mem_pe=bf(pe))
    elif kernel == 'B3':
        q, k, v, id_v, valid, scale = _b3_inputs(2)
        args = (bf(q), bf(k), (bf(v), bf(id_v)), torch.from_numpy(valid), 2,
                scale)
        run = lambda: memory_read_multihead(*args)
    else:
        rng = np.random.RandomState(5)
        (h, w), md = (11, 14), 7
        args = (bf(rng.randn(2, h * w, 32).astype(np.float32) / 32 ** 0.5),
                bf(rng.randn(2, h * w, 32).astype(np.float32)),
                bf(rng.randn(2, h * w, 48).astype(np.float32)),
                torch.from_numpy(rng.randn(2, h * w, (2 * md + 1) ** 2)
                                 .astype(np.float32)), (h, w), md, False)
        run = lambda: (local_window_attention(*args),)
    flat = lambda out: [x for o in out
                        for x in (o if isinstance(o, tuple) else (o,))]
    switch(None)
    default = flat(run())
    switch('0')
    for a, b in zip(default, flat(run())):
        assert torch.equal(a, b)


# ---------------------------------------------------- engine, training
def test_two_head_deaot_engine_bf16_under_the_switch(switch, monkeypatch):
    """Two-head DeAOT (Path A: no_memory_gap, att_heads = 2, no temporal
    PE) in bf16 under RMEM_BF16_PROBS=0, port against the JAX engine (its
    bank read through the Pallas kernel B3 in interpret mode), on the
    clip of tests/test_torch_multihead.py: two streams at 65x65, write gap
    1, eviction from the third frame. That file's fp32 bars hold eviction
    ids identical at every step; in bf16 the encoder's and decoder's
    roundings differ between XLA and PyTorch whatever the switch says
    (this clip at the default: logits 1.6e-2 apart, masks 99.4-99.6% equal,
    mass 2.0e-3), so logits are held to two bf16 ulps of their largest,
    mass to 4e-3, and a mask pixel may differ only where the JAX engine's
    two best logits lie within twice the largest logit difference (the
    tie rule of chip_smoke.py's fp32 card checks), on at most 1% of
    pixels."""
    switch('0')
    monkeypatch.setenv('RMEM_PALLAS', '1')
    img0, mask0, frames = _clip()
    jexp = jax_get_config('pre_vost_2', compute_dtype='bfloat16',
                          **OVERRIDES)
    params = jax.device_get(jax.jit(jax_build(jexp.model).init)(
        jax.random.PRNGKey(0), jnp.asarray(img0[:1]),
        jnp.zeros((1, SIZE, SIZE, jexp.model.id_dim))))
    want, _ = run_jax_engine(jexp, cast_floating(params, jnp.bfloat16),
                             img0, mask0, frames)
    exp = get_config('pre_vost_2', compute_dtype='bfloat16', **OVERRIDES)
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(params_from_flax(params, exp.model), strict=True)
    eng = InferEngine(model.to(torch.bfloat16), exp, long_term_mem_gap=1)
    st = eng.init_state(2, (5, 5))
    st = eng.add_reference_frame(st, torch.from_numpy(img0),
                                 torch.from_numpy(mask0), torch.tensor(OBJ))
    evicted, prev = False, None
    for t, (f, (w_logits, w_pred, w_mass, w_ids, w_ord)) in enumerate(
            zip(frames, want)):
        logits, st = eng.propagate(st, torch.from_numpy(f))
        pred = eng.predict_mask(logits, img0.shape[1:3])
        mass = st.pending_mass.float().numpy()
        st = eng.update_memory(st, pred)
        np.testing.assert_array_equal(st.bank.frame_ids.numpy(), w_ids,
                                      err_msg=f'frame {t}')
        np.testing.assert_array_equal(st.bank.ordered_frame_ids.numpy(),
                                      w_ord, err_msg=f'frame {t}')
        if prev is not None:          # a frame id left the bank
            evicted |= any(set(p[p >= 0]) - set(o[o >= 0])
                           for p, o in zip(prev, w_ord))
        prev = w_ord
        w_logits = np.asarray(w_logits, np.float32)
        g_logits = logits.float().numpy()
        assert np.isfinite(g_logits).all()
        diff = float(np.abs(g_logits - w_logits)[..., :max(OBJ) + 1].max())
        assert diff <= 2 * BF16_ULP * max(1.0, float(np.abs(
            w_logits[..., :max(OBJ) + 1]).max())), (t, diff)
        np.testing.assert_allclose(mass, np.asarray(w_mass, np.float32),
                                   rtol=0, atol=4e-3, err_msg=f'frame {t}')
        differ = pred.numpy() != np.asarray(w_pred)
        assert differ.mean() <= 0.01, (t, differ.mean())
        up = interpolate_bilinear(
            torch.from_numpy(w_logits).permute(0, 3, 1, 2),
            img0.shape[1:3], exp.model.align_corners)
        top2 = up.topk(2, dim=1).values
        gaps = (top2[:, 0] - top2[:, 1]).numpy()[differ]
        assert gaps.size == 0 or float(gaps.max()) <= 2 * diff, (t,
                                                                 gaps.max())
    assert evicted, 'the clip must evict'


def test_amp_episode_under_the_switch_matches_jax(switch):
    """The deaott AMP episode of tests/test_torch_train_engine.py
    (bf16 parameters and activations, use_prev_pred off) with
    RMEM_BF16_PROBS=0 on both sides, at that file's AMP bars: loss within
    2e-2 relative, gradients f32, each trainable leaf's cosine to the JAX
    package's bf16 gradient at least 0.99 or at least that gradient's own
    cosine to the port's f32 one."""
    from test_torch_train_engine import _case, _cos, _trainable
    switch('0')
    case = _case('deaott', 1, 3, 30.0, use_prev_pred=False, amp=True)
    assert float(case['loss']) == pytest.approx(case['jloss'], rel=2e-2)
    for n in _trainable(case):
        got, want = case['grads'][n], case['jgrads'][n]
        assert got.dtype == torch.float32, n
        bar = min(0.99, _cos(want, case['grads32'][n]))
        assert _cos(got, want) >= bar, (n, _cos(got, want), bar)
