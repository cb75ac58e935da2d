"""The port's encoders and the models built on them, against the JAX
package on the CPU.

Same weights (random from a numpy seed over the flax tree's shapes, with
biases, norm affines and frozen-BN statistics moved off their init values,
converted with params_from_flax) and the same numpy inputs go through the
JAX module and its port.

- Every encoder at 65x97, which makes every Swin stage pad (17x25 ->
  21x28, 9x13 -> 14x14, 5x7 -> 7x7) and both shifted and unshifted windows
  run; Swin narrow (embed 32, depths (2, 2, 2), heads (2, 4, 8)), the
  others at their full width. f32: max abs error <= 1e-4 x the output's
  RMS (measured: at most 1.0e-5, TopDown with a mask). bf16 (parameters
  and input bf16 on both sides; the JAX package's erf/tanh GELU switch,
  bf16 logits and probabilities in Swin): each element within 0.15 x
  (RMS + |want|) (measured: at most 0.053 of it, ResNet-101; max abs
  error 0.103 x RMS, TopDown; through 14 to 110 layers of random weights
  where the two frameworks round at different places).
- TopDown with the prompt and with a mask, and its reconstruction loss on
  request against the JAX `losses` collection (relative 1e-4).
- The engine of `swinb_deaotl` (64x96: grid 4x6, align_corners=False) and
  of `deaotl` (MobileNetV2, 65x97) against the JAX engine at
  RMEM_PALLAS=1 (both Pallas kernels in interpret mode), fp32, two streams,
  a bank of 1 + 3 written every frame, the JAX engine's masks written into
  both memories: eviction ids identical at every update, logits within
  1e-3, eviction mass within 1e-4, masks identical but at ties of the two
  best logits (deaotl: 1 pixel of 12610 at frames 0, 2 and 3, top-two
  gaps 8.5e-5, 4.4e-5 and 1.7e-5; swinb_deaotl: none).
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.engine import InferEngine as JaxEngine
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.models.encoders import build_encoder as jax_build_encoder
from rmem_ocu_tpu.models.encoders.swin import SwinEncoder as JaxSwin

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
from rmem_ocu_tpu_torch.config import ModelConfig
from rmem_ocu_tpu_torch.models.encoders import build_encoder
from rmem_ocu_tpu_torch.models.encoders.swin import SwinEncoder
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

H, W = 65, 97


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One CPU thread for the port, as in tests/test_torch_evaluator.py:
    beside the suite's other workers a thread pool waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(shapes, seed: int):
    """Numpy values for a flax tree of shapes: lecun-normal kernels, the
    init of each named parameter, and biases, norm affines and frozen-BN
    statistics off their init values."""
    rng = np.random.RandomState(seed)

    def make(path, x):
        name = path[-1].key
        noise = rng.randn(*x.shape).astype(np.float32)
        if name in ('kernel', 'relative_emb_k_w'):
            fan_in = np.prod(x.shape[:-1]) if name == 'kernel' else x.shape[1]
            return noise * np.float32(fan_in ** -0.5)
        if name == 'running_var':
            return 1.0 + 0.2 * np.abs(noise)
        if name in ('running_mean', 'bias'):
            return 0.1 * noise
        if name in ('scale', 'weight'):
            return 1.0 + 0.1 * noise
        if name in ('cur_pos_emb', 'mem_pos_emb'):
            return 0.05 * noise
        if name == 'relative_position_bias_table':
            return 0.5 * noise
        if name == 'top_down_transform':
            return np.eye(x.shape[0], dtype=np.float32) + 0.02 * noise
        if name == 'prompt':
            return noise
        return np.zeros(x.shape, np.float32)
    return jax.tree_util.tree_map_with_path(make, shapes)


# name -> (JAX module, port module, the port config's encoder name)
ENCODERS = {
    'mobilenetv2': lambda: (jax_build_encoder('mobilenetv2'),
                            build_encoder('mobilenetv2'), 'mobilenetv2'),
    'mobilenetv3': lambda: (jax_build_encoder('mobilenetv3'),
                            build_encoder('mobilenetv3'), 'mobilenetv3'),
    'resnet101': lambda: (jax_build_encoder('resnet101'),
                          build_encoder('resnet101'), 'resnet101'),
    'resnest50': lambda: (jax_build_encoder('resnest50'),
                          build_encoder('resnest50'), 'resnest50'),
    'resnest101': lambda: (jax_build_encoder('resnest101'),
                           build_encoder('resnest101'), 'resnest101'),
    'swin_narrow': lambda: (
        JaxSwin(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 8)),
        SwinEncoder(32, (2, 2, 2), (2, 4, 8)), 'swin_base'),
    'topdown_prompt': lambda: (
        jax_build_encoder('resnet50_topdown', use_mask=True),
        build_encoder('resnet50_topdown', use_mask=True), 'resnet50_topdown'),
}
ENCODERS['topdown_mask'] = ENCODERS['topdown_prompt']


def _inputs():
    rng = np.random.RandomState(0)
    img = rng.randn(2, H, W, 3).astype(np.float32)
    mask = rng.rand(2, H, W, 1).astype(np.float32)
    return img, mask


@pytest.fixture(scope='module')
def encoders():
    """name -> (JAX module, flax params, port module in f32), built once
    for both dtypes."""
    cache = {}

    def get(name):
        if name not in cache:
            jmod, mod, enc = ENCODERS[name]()
            img, _ = _inputs()
            shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                    jnp.asarray(img))
            params = random_params({'params': shapes['params']}, 1)
            mod.load_state_dict(params_from_flax(params, ModelConfig(
                encoder=enc, use_mask='topdown' in enc)), strict=True)
            cache[name] = (jmod, params, mod.eval())
        return cache[name]
    return get


def _per_output(got, want):
    """[(max abs err / rms, max of |err| / (rms + |want|))] per output."""
    out = []
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 3, 1, 2)
        g = g.float().numpy()
        assert g.shape == w.shape
        rms = float(np.sqrt((w ** 2).mean()))
        err = np.abs(g - w)
        out.append((float(err.max()) / rms,
                    float((err / (rms + np.abs(w))).max())))
    return out


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', list(ENCODERS))
def test_encoder_matches_jax(name, dtype, encoders):
    jmod, params, mod = encoders(name)
    img, mask = _inputs()
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'float32'
                else (jnp.bfloat16, torch.bfloat16))
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    jargs = (jnp.asarray(img, jdt),)
    args = (torch.from_numpy(img).permute(0, 3, 1, 2).to(tdt),)
    if name == 'topdown_mask':
        jargs += (jnp.asarray(mask, jdt),)
        args += (torch.from_numpy(mask).permute(0, 3, 1, 2).to(tdt),)
    want = jax.jit(jmod.apply)(jparams, *jargs)
    with torch.no_grad():
        got = copy.deepcopy(mod).to(tdt)(*args)
    assert len(got) == len(want) == 4
    assert all(g.dtype == tdt for g in got)
    errs = _per_output(got, want)
    if dtype == 'float32':
        assert max(e for e, _ in errs) <= 1e-4, errs
    else:
        assert max(r for _, r in errs) <= 0.15, errs


def test_topdown_var_loss_matches_jax(encoders):
    """The reconstruction loss, asked for, equals the JAX `losses`
    collection's value; without the request the encoder returns only the
    maps."""
    jmod, params, mod = encoders('topdown_mask')
    img, mask = _inputs()
    for m in (None, mask):
        jargs = (jnp.asarray(img),) + (() if m is None
                                       else (jnp.asarray(m),))
        want, coll = jax.jit(functools.partial(
            jmod.apply, mutable=['losses']))(params, *jargs)
        args = (torch.from_numpy(img).permute(0, 3, 1, 2),)
        if m is not None:
            args += (torch.from_numpy(m).permute(0, 3, 1, 2),)
        with torch.no_grad():
            maps, loss = mod(*args, var_loss=True)
            plain = mod(*args)
        want_loss = float(coll['losses']['var_loss'])
        assert abs(float(loss) - want_loss) <= 1e-4 * want_loss
        assert isinstance(plain, list) and len(plain) == 4
        for a, b in zip(maps, plain):
            assert torch.equal(a, b)


def test_unknown_encoder_and_mask_without_topdown_raise():
    with pytest.raises(NotImplementedError, match='unknown encoder'):
        build_encoder('resnet18')
    with pytest.raises(ValueError, match='topdown'):
        ModelConfig(encoder='swin_base', use_mask=True)
    with pytest.raises(ValueError, match='topdown'):
        get_config('pre_vost_2', model='r50_deaotl', oracle=True)
    assert get_config('pre_vost_2', model='r50_topdown_aotl',
                      oracle=True).model.use_mask


def test_encode_image_mask_forms():
    """The conditioning forms of the JAX package's encode_image: an int
    label is ignore-cleared (255 -> 0) and binarised, float probabilities
    become 1 - P(background), any other form raises; a model without
    use_mask ignores the mask."""
    cfg = get_config('pre_vost_2', model='r50_topdown_aotl',
                     oracle=True).model
    model = build_vos_model(cfg, device='cpu')
    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 4, (1, H, W, 1)))
    label[:, :5] = 255
    probs = torch.softmax(torch.randn(1, H, W, 4), -1)

    def direct(m):
        with torch.no_grad():
            xs = model.encoder(img.permute(0, 3, 1, 2), m.permute(0, 3, 1, 2))
            return model.encoder_projector(xs[-1])
    with torch.no_grad():
        by_label = model.encode_image(img, label)[-1]
        by_probs = model.encode_image(img, probs)[-1]
        plain = model.encode_image(img)[-1]
    binary = ((label > 0) & (label != 255)).float()
    assert torch.equal(by_label, direct(binary))
    assert torch.equal(by_probs, direct(1.0 - probs[..., :1]))
    assert not torch.equal(by_label, plain)
    for bad in (label.float(), probs.to(torch.int64), label.bool()):
        with pytest.raises(ValueError, match='use_mask conditioning'):
            model.encode_image(img, bad)
    other = build_vos_model(get_config('pre_vost_2', model='aott').model,
                            device='cpu')
    with torch.no_grad():
        assert torch.equal(other.encode_image(img, label)[-1],
                           other.encode_image(img)[-1])


# ---------------------------------------------------------------- engines
FRAMES = 5
OBJ = [2, 3]                    # objects per stream


def _engine_inputs(size):
    rng = np.random.RandomState(11)
    img0 = rng.randn(2, *size, 3).astype(np.float32)
    mask0 = (rng.rand(2, *size) * np.array([3, 4])[:, None, None]
             ).astype(np.int32)
    frames = [(rng.randn(2, *size, 3) * 0.5 + img0).astype(np.float32)
              for _ in range(FRAMES)]
    return img0, mask0, frames


def _run_jax(exp, params, size, grid, inputs):
    img0, mask0, frames = inputs
    eng = JaxEngine(jax_build(exp.model), exp, long_term_mem_gap=1)
    st = eng.init_state(2, grid)
    st = eng.add_reference_frame(params, st, jnp.asarray(img0),
                                 jnp.asarray(mask0), jnp.array(OBJ, jnp.int32))
    out = []
    for f in frames:
        logits, st = eng.propagate(params, st, jnp.asarray(f))
        pred = eng.predict_mask(logits, size)
        mass = np.asarray(st.pending_mass)
        st = eng.update_memory(params, st, pred)
        out.append((np.asarray(logits), np.asarray(pred), mass,
                    np.asarray(st.bank.ordered_frame_ids)))
    return out


def _run_port(exp, state_dict, size, grid, inputs, feed):
    """`feed`: the masks to write into memory, the JAX engine's, so that
    a tied pixel's argmax does not make the two memories differ."""
    img0, mask0, frames = inputs
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(state_dict, strict=True)
    eng = InferEngine(model, exp, long_term_mem_gap=1)
    st = eng.init_state(2, grid)
    st = eng.add_reference_frame(st, torch.from_numpy(img0),
                                 torch.from_numpy(mask0), torch.tensor(OBJ))
    out = []
    for f, fed in zip(frames, feed):
        logits, st = eng.propagate(st, torch.from_numpy(f))
        pred = eng.predict_mask(logits, size)
        mass = st.pending_mass.numpy().copy()
        st = eng.update_memory(st, torch.from_numpy(np.array(fed)))
        out.append((logits.numpy(), pred.numpy(), mass,
                    st.bank.ordered_frame_ids.numpy()))
    return out


def _masks_agree(got, want, logits, size, align_corners, t):
    """The masks are identical but where the two best upsampled logits
    tie: there (a pixel or two of a frame with random weights) a
    difference within the logits' 1e-3 bar may flip the argmax."""
    diff = got != want
    if not diff.any():
        return
    up = torch.nn.functional.interpolate(
        torch.from_numpy(logits).permute(0, 3, 1, 2), size=size,
        mode='bilinear', align_corners=align_corners)
    top2 = up.topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).numpy()[diff]
    print(f'frame {t}: {int(diff.sum())} of {diff.size} pixels differ, '
          f'top-two logit gaps there {gap.tolist()}')
    assert diff.mean() < 1e-3 and gap.max() < 2e-3, f'masks frame {t}'


@pytest.mark.parametrize('model,size,grid', [
    ('swinb_deaotl', (64, 96), (4, 6)),
    ('deaotl', (65, 97), (5, 7))])
def test_engine_matches_jax_engine(model, size, grid, monkeypatch):
    monkeypatch.setenv('RMEM_PALLAS', '1')
    inputs = _engine_inputs(size)
    jexp = jax_get_config('pre_vost_2', model=model, latter_mem_len=3)
    shapes = jax.eval_shape(
        jax_build(jexp.model).init, jax.random.PRNGKey(0),
        jnp.zeros((1, *size, 3)), jnp.zeros((1, *size, jexp.model.id_dim)))
    params = random_params({'params': shapes['params']}, 2)
    want = _run_jax(jexp, params, size, grid, inputs)

    exp = get_config('pre_vost_2', model=model, latter_mem_len=3)
    got = _run_port(exp, params_from_flax(params, exp.model), size, grid,
                    inputs, [w[1] for w in want])
    evicted = False
    for t, (w, g) in enumerate(zip(want, got)):
        w_logits, w_pred, w_mass, w_ord = w
        g_logits, g_pred, g_mass, g_ord = g
        assert g_logits.shape == w_logits.shape == (2, 4 * grid[0] - (
            3 if exp.model.align_corners else 0), 4 * grid[1] - (
                3 if exp.model.align_corners else 0), 11)
        np.testing.assert_array_equal(g_ord, w_ord, err_msg=f'frame {t}')
        _masks_agree(g_pred, w_pred, g_logits, size, exp.model.align_corners,
                     t)
        np.testing.assert_allclose(g_logits, w_logits, rtol=1e-3, atol=1e-3,
                                   err_msg=f'logits frame {t}')
        np.testing.assert_allclose(g_mass, w_mass, rtol=1e-4, atol=1e-4,
                                   err_msg=f'eviction mass frame {t}')
        # t + 2 frames were written; fewer live means one was evicted
        evicted |= bool(((w_ord >= 0).sum(1) < t + 2).all())
    assert evicted, 'the clip must exercise eviction in both streams'
