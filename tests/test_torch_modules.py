"""Module parity of the PyTorch port against the JAX package, fp32 on CPU.

Same weights (the flax tree, perturbed so that biases and norm statistics
are not at their init values, converted with params_from_flax) and the same
numpy inputs go through the JAX module and its port. Bar: 1e-4, absolute
for O(1) outputs and relative to the largest magnitude for the deep
random-weight ResNet maps (summation order differs between XLA and
PyTorch's CPU kernels; nothing else may).
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
from rmem_ocu_tpu.models.vos_model import VOSModel as JaxVOSModel
from rmem_ocu_tpu.ops.position import \
    interpolated_memory_pe as jax_interpolated_memory_pe

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
from rmem_ocu_tpu_torch.models.gpm import GPMBlock
from rmem_ocu_tpu_torch.ops.position import interpolated_memory_pe
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

SIZE = 65


def _perturb(params, seed):
    """Move biases, norm affines and frozen-BN statistics off their init
    values (numpy tree in, numpy tree out)."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x)
        name = path[-1].key
        noise = rng.randn(*x.shape).astype(x.dtype)
        if name == 'running_var':
            return 1.0 + 0.2 * np.abs(noise)
        if name in ('running_mean', 'bias'):
            return 0.1 * noise
        if name in ('scale', 'weight'):
            return 1.0 + 0.1 * noise
        return x
    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


def _close(got, want, rel=False, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if rel else 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f'max abs err {err} > {tol} * {scale}'


@pytest.fixture(scope='module')
def vos():
    jexp = jax_get_config('pre_vost_2', model='r50_deaotl')
    jmodel = jax_build(jexp.model)
    img = np.random.RandomState(0).randn(1, SIZE, SIZE, 3).astype(np.float32)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(img),
        jnp.zeros((1, SIZE, SIZE, jexp.model.id_dim)))
    params = _perturb(params, 1)
    exp = get_config('pre_vost_2', model='r50_deaotl')
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(params_from_flax(params, exp.model), strict=True)
    jxs = jmodel.apply(params, jnp.asarray(img),
                       method=JaxVOSModel.encode_image)
    with torch.no_grad():
        xs = model.encode_image(torch.from_numpy(img))
    return dict(jexp=jexp, jmodel=jmodel, params=params, exp=exp,
                model=model, jxs=jxs, xs=xs)


def test_resnet50_encoder(vos):
    img = np.random.RandomState(2).randn(1, SIZE, SIZE, 3).astype(np.float32)
    want = vos['jmodel'].apply(vos['params'], jnp.asarray(img),
                               method=lambda m, x: m.encoder(x))
    with torch.no_grad():
        got = vos['model'].encoder(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, rel=True)


def test_encode_image(vos):
    for g, w in zip(vos['xs'], vos['jxs']):
        _close(g.permute(0, 2, 3, 1).numpy(), w, rel=True)


def test_get_id_emb_from_label(vos):
    """The label -> one-hot fold (255 -> the ignore channel, ids above
    max_obj_num -> all zeros) and the id bank conv + id_norm."""
    rng = np.random.RandomState(3)
    label = (rng.rand(2, SIZE, SIZE) * 4).astype(np.int32)
    label[0, :10, :20] = 255
    label[1, 30:, 5:] = 11
    jeng = JaxEngine(vos['jmodel'], vos['jexp'])
    want = jeng._id_emb_from_label(vos['params'], jnp.asarray(label))
    eng = InferEngine(vos['model'], vos['exp'])
    with torch.no_grad():
        got = eng._id_emb_from_label(torch.from_numpy(label), torch.float32)
    _close(got.numpy(), want)


def test_fpn_decode_id_logits(vos):
    rng = np.random.RandomState(4)
    inters = [rng.randn(1, 25, 512).astype(np.float32) for _ in range(3)]
    want = vos['jmodel'].apply(vos['params'],
                               [jnp.asarray(x) for x in inters], vos['jxs'],
                               method=JaxVOSModel.decode_id_logits)
    with torch.no_grad():
        got = vos['model'].decode_id_logits(
            [torch.from_numpy(x) for x in inters], vos['xs'])
    _close(got.numpy(), want, rel=True)


def test_position_embeddings(vos):
    want = vos['jmodel'].apply(vos['params'], (5, 7),
                               method=JaxVOSModel.get_pos_emb)
    _close(vos['model'].get_pos_emb((5, 7)).numpy(), want, tol=1e-6)
    mem = np.random.RandomState(5).randn(4, 128).astype(np.float32)
    lengths = np.arange(11)
    got = interpolated_memory_pe(torch.from_numpy(mem),
                                 torch.from_numpy(lengths), 10)
    for n in lengths:
        _close(got[n].numpy(),
               jax_interpolated_memory_pe(jnp.asarray(mem), int(n), 10),
               tol=1e-6)


def _gpm_inputs(rng, b, hw, d, t_cap):
    d_att, e = d // 2, 2 * d
    r = lambda *s: rng.randn(*s).astype(np.float32)
    valid = np.ones((b, t_cap), bool)
    valid[0, 1] = False
    return dict(tgt=r(b, hw, d), tgt_id=r(b, hw, d), id_emb=r(b, hw, d),
                cur_pe=r(d_att) * 0.1, ref_pe=r(b, 1, d_att) * 0.1,
                mem_pe=r(b, t_cap, d_att) * 0.1,
                long=(r(b, t_cap, hw, d_att), r(b, t_cap, hw, e),
                      r(b, t_cap, hw, e), valid),
                short=(r(b, hw, d_att), r(b, hw, e), r(b, hw, e)))


@pytest.mark.parametrize('layer_idx,path', [(0, 'reference'),
                                            (1, 'reference'),
                                            (1, 'memory')])
def test_gpm_block(layer_idx, path, monkeypatch):
    """One GPMBlock at d_model=32 on a 5x6 grid. 'reference': the id
    embedding is given and the bank is the frame itself (plain read);
    'memory': a 4-slot bank with a dead slot (kernel B1, plain on the CPU)
    and the short-term window (kernel B2). The JAX side runs its Pallas
    kernels in interpret mode (RMEM_PALLAS=1), the read the port mirrors
    (bf16 bank-read operands)."""
    monkeypatch.setenv('RMEM_PALLAS', '1')
    rng = np.random.RandomState(10 + layer_idx)
    b, (h, w), d, t_cap = 2, (5, 6), 32, 4
    x = _gpm_inputs(rng, b, h * w, d, t_cap)
    j = lambda a: jax.tree_util.tree_map(jnp.asarray, a)
    jtgt_id = None if layer_idx == 0 else j(x['tgt_id'])
    jmod = JaxGPMBlock(d_model=d, layer_idx=layer_idx)
    params = jmod.init(jax.random.PRNGKey(layer_idx), j(x['tgt']), jtgt_id,
                       None, None, j(x['id_emb']), (h, w),
                       (j(x['cur_pe']), j(x['ref_pe'])))
    params = _perturb(params, 20 + layer_idx)
    if path == 'reference':
        jargs = (None, None, j(x['id_emb']), (h, w),
                 (j(x['cur_pe']), j(x['ref_pe'])))
    else:
        jargs = (j(x['long']), j(x['short']), None, (h, w),
                 (j(x['cur_pe']), j(x['mem_pe'])))
    # the engine asks for the eviction mass only when reading the bank
    need_mass = path == 'memory'
    w_tgt, w_id, w_mems, w_mass = jmod.apply(
        params, j(x['tgt']), jtgt_id, *jargs, need_mass=need_mass)

    mod = GPMBlock(d, layer_idx=layer_idx).eval()
    mod.load_state_dict(params_from_flax(params, get_config(
        'pre_vost_2').model), strict=True)
    t = lambda a: (None if a is None else
                   tuple(map(t, a)) if isinstance(a, tuple)
                   else torch.from_numpy(a))
    if path == 'reference':
        args = (None, None, t(x['id_emb']), (h, w),
                (t(x['cur_pe']), t(x['ref_pe'])))
    else:
        args = (t(x['long']), t(x['short']), None, (h, w),
                (t(x['cur_pe']), t(x['mem_pe'])))
    with torch.no_grad():
        g_tgt, g_id, g_mems, g_mass = mod(
            t(x['tgt']), None if layer_idx == 0 else t(x['tgt_id']), *args,
            need_mass=need_mass)
    _close(g_tgt.numpy(), w_tgt)
    _close(g_id.numpy(), w_id)
    for key in ('curr_k', 'curr_v', 'global_id_v_fused'):
        if key in w_mems:
            _close(g_mems[key].numpy(), w_mems[key])
    if path == 'memory':
        _close(g_mass.numpy(), w_mass)
    else:
        assert g_mass is None and w_mass is None
