"""The PyTorch port's training episode against the JAX package's
`TrainEngine.episode_loss`, on the CPU.

Same weights (the flax init, converted with params_from_flax), same numpy
clips, every train-time rate at 0 on both sides (the JAX package's
DWConv2d channel dropout is not a config field: its call is run
deterministic here), id shuffle off. The JAX side runs without remat (its
gradients are the same, and it compiles faster); the port runs with
`train_remat_policy='full'` on the clip itself, so its checkpoints are
under test too. The port-only checks (remat, the routing of fault C1,
the XLA-only knobs, the trainable BN) are in
tests/test_torch_train_routing.py.

Bars, f32: loss and per-frame losses within 1e-5 relative; each trainable
gradient leaf with cosine >= 0.9999 and norm ratio in [0.999, 1.001], on
one of three clips that differ by 1e-5 of the frames' value, each run
through both packages: with random weights some ReLU inputs of the
decoder (GroupNorm outputs, dense around 0) lie within the two packages'
rounding difference (~1e-6) of 0, and where XLA and PyTorch put one on
different sides of 0 the gradient jumps (2.6% at an id embedding on one
clip; fed the JAX activations, the port's decoder gives the JAX gradient
to 7e-7, CHANGES.md). Each nudge moves which inputs lie that near 0. A leaf
whose gradient is zero in exact arithmetic (the key bias of a softmax
attention: softmax ignores a per-query constant) holds rounding noise on
both sides; it must be below 1e-6 of the global gradient norm on both.
AMP against the JAX package's AMP: loss within 2e-2 relative, gradients
f32, each trainable leaf with cosine >= 0.99 to the JAX package's bf16
gradient, or, on a leaf where that bf16 gradient itself lies farther than
0.99 from the exact (f32) gradient, with a cosine to it no lower than its
own cosine to the exact gradient: the port may differ from the reference
by no more than the reference's own bf16 rounding (CHANGES.md lists these
leaves: the MobileNetV2 encoder's and the first GPM layer's
self-attention projections, whose bf16 gradients lie 0.91-0.98 from the
exact ones in either package).
"""
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.engine.train_engine import TrainEngine as JaxTrainEngine
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.ops import layers as jlayers

from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
from rmem_ocu_tpu_torch.models.vos_model import zero_dropout
from rmem_ocu_tpu_torch.train.optim import make_masks
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

SIZE = 49


def _exp(get, model, t, **kw):
    """pre_vost with T frames, a long-term write every frame (the model
    field of that name is not the one the engine reads) and no
    drop-path."""
    return replace(get('pre_vost', model=model, data_seq_len=t,
                       train_total_steps=100, train_lstt_droppath=0.0,
                       **kw), train_long_term_mem_gap=1)


def _clip(b, t, seed):
    rs = np.random.RandomState(seed)
    frames = rs.randn(b, t, SIZE, SIZE, 3).astype(np.float32)
    masks = (rs.rand(b, t, SIZE, SIZE) * 3).astype(np.int32)
    masks[:, :, :3, :5] = 255
    return frames, masks


NUDGES = (1, 2)


def nudge(frames, seed):
    """The clip with its frames moved by 1e-5 of their value."""
    return (frames * (1 + 1e-5 * np.random.RandomState(seed).randn(
        *frames.shape))).astype(np.float32)


def _port_model(exp, flax_params):
    model = build_vos_model(exp.model, device='cpu', exp=exp)
    model.load_state_dict(params_from_flax(flax_params, exp.model),
                          strict=True)
    return zero_dropout(model).train()


def _port_episode(model, exp, frames, masks, obj_nums, step, **kw):
    for p in model.parameters():
        p.grad = None
    loss, aux = TrainEngine(model, exp).episode_loss(
        torch.from_numpy(frames), torch.from_numpy(masks),
        torch.tensor(obj_nums), step, torch.Generator().manual_seed(0),
        enable_id_shuffle=False, **kw)
    loss.backward()
    grads = {n: (p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    aux = {k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()}
    return loss.detach(), aux, grads


def _case(model_name, b, t, step, use_prev_pred, amp=False, **model_kw):
    """One JAX episode (compiled once) and the port's on the same weights
    and clip; with amp also the port's f32 gradients."""
    kw = dict(train_remat_policy='none', train_amp=amp, **model_kw)
    jexp = _exp(jax_get_config, model_name, t, **kw)
    exp = _exp(get_config, model_name, t,
               **dict(kw, train_remat_policy='full'))
    jmodel = jax_build(jexp.model, jexp)
    flax_params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, jexp.model.id_dim)))
    frames, masks = _clip(b, t, seed=b * 10 + t)
    obj_nums = [2, 3][:b]
    eng = JaxTrainEngine(jmodel, jexp)
    mp = pytest.MonkeyPatch()
    orig = jlayers.DWConv2d.__call__
    mp.setattr(jlayers.DWConv2d, '__call__',
               lambda self, x, size_2d, deterministic=True:
               orig(self, x, size_2d, True))
    try:
        def loss_fn(p, clip):
            return eng.episode_loss(
                p, clip, jnp.asarray(masks),
                jnp.asarray(obj_nums, jnp.int32),
                jnp.asarray(step, jnp.float32), jax.random.PRNGKey(0),
                use_prev_pred=use_prev_pred, enable_id_shuffle=False)
        run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (jloss, jaux), jgrads = run(flax_params, jnp.asarray(frames))
        nudged = [] if amp else [nudge(frames, s) for s in NUDGES]
        jnudged = [run(flax_params, jnp.asarray(c))[1] for c in nudged]
    finally:
        mp.undo()
    flax_params = jax.device_get(flax_params)
    model = _port_model(exp, flax_params)
    loss, aux, grads = _port_episode(model, exp, frames, masks, obj_nums,
                                     step, use_prev_pred=use_prev_pred)
    to_port = lambda g: params_from_flax(jax.device_get(g), exp.model)
    no_remat = replace(exp, train_remat_policy='none')
    out = dict(exp=exp, model=model, jloss=float(jloss),
               jframe=np.asarray(jaux['frame_losses']),
               jgrads=to_port(jgrads), loss=loss, aux=aux, grads=grads,
               pairs=[(grads, to_port(jgrads))] + [
                   (_port_episode(model, no_remat, c, masks, obj_nums, step,
                                  use_prev_pred=use_prev_pred)[2],
                    to_port(g)) for c, g in zip(nudged, jnudged)])
    if amp:
        exp32 = replace(exp, train_amp=False)
        out['grads32'] = _port_episode(
            _port_model(exp32, flax_params), exp32, frames, masks, obj_nums,
            step, use_prev_pred=use_prev_pred)[2]
    return out


def _cos(a, b):
    return float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))


def _trainable(case):
    frozen = make_masks(dict(case['model'].named_parameters()),
                        case['exp']).frozen
    return [n for n, fz in frozen.items() if not fz]


def _assert_f32_grads(case):
    names = _trainable(case)
    total = float(torch.sqrt(sum(case['jgrads'][n].square().sum()
                                 for n in names)))
    for n in names:
        got, want = case['grads'][n], case['jgrads'][n]
        ng, nw = float(got.norm()), float(want.norm())
        if max(ng, nw) < 1e-6 * total:
            continue                      # zero in exact arithmetic
        seen = []
        for port, ref in case['pairs']:
            c = _cos(port[n], ref[n])
            r = float(port[n].norm() / ref[n].norm())
            seen.append((c, r))
            if c >= 0.9999 and 0.999 <= r <= 1.001:
                break
        else:
            raise AssertionError((n, seen))


@pytest.fixture(scope='module')
def deaot_case():
    """deaott, T=3, gap 1, use_prev_pred, at a step inside the hard-mining
    ramp (k < all pixels) and the aux-loss ramp; a budget of 1 + 1 frames,
    so the second write evicts."""
    return _case('deaott', 1, 3, 30.0, use_prev_pred=True, latter_mem_len=1)


@pytest.fixture(scope='module')
def aot_case():
    """aott, T=4, gap 1, reverse_infer: the reverse pass fires after the
    writes at frames 1 and 2; a budget of 1 + 2 frames, so the third write
    evicts."""
    return _case('aott', 1, 4, 100.0, use_prev_pred=False,
                 reverse_infer=True, latter_mem_len=2)


@pytest.fixture(scope='module')
def amp_case():
    """deaott in AMP (bf16 parameters and activations), use_prev_pred off:
    the memory takes the ground-truth identities."""
    return _case('deaott', 1, 3, 30.0, use_prev_pred=False, amp=True)


@pytest.mark.parametrize('name', ['deaot_case', 'aot_case'])
def test_episode_matches_jax(name, request):
    case = request.getfixturevalue(name)
    assert float(case['loss']) == pytest.approx(case['jloss'], rel=1e-5)
    np.testing.assert_allclose(case['aux']['frame_losses'].detach().numpy(),
                               case['jframe'], rtol=1e-5)
    _assert_f32_grads(case)


def test_episode_without_prev_pred_trains_the_id_bank(deaot_case):
    """With use_prev_pred the id embedding is detached (the reference's
    frozen id bank at seq training); without it the id bank learns."""
    case = deaot_case
    assert float(case['grads']['patch_wise_id_bank.weight'].abs().max()) == 0
    frames, masks = _clip(1, 3, seed=13)
    _, _, grads = _port_episode(case['model'], case['exp'], frames, masks,
                                [2], 30.0, use_prev_pred=False)
    assert float(grads['patch_wise_id_bank.weight'].abs().max()) > 0


def test_reverse_infer_adds_entries(aot_case):
    """reverse_infer off: the same per-frame losses, and the prediction
    loss their plain mean; on, each reverse loss joined them as one more
    entry (the reference's denominator), so the totals differ by exactly
    that."""
    case = aot_case
    exp = replace(case['exp'], model=replace(case['exp'].model,
                                             reverse_infer=False))
    frames, masks = _clip(1, 4, seed=14)
    model = zero_dropout(build_vos_model(exp.model, device='cpu', exp=exp))
    model.load_state_dict(case['model'].state_dict())
    model.train()
    loss, aux, _ = _port_episode(model, exp, frames, masks, [2], 100.0)
    np.testing.assert_allclose(aux['frame_losses'].detach().numpy(),
                               case['aux']['frame_losses'].detach().numpy(),
                               rtol=1e-6)
    assert float(aux['pred_loss']) == pytest.approx(
        float(aux['frame_losses'].mean()), rel=1e-6)
    assert float(case['aux']['pred_loss']) != pytest.approx(
        float(aux['pred_loss']), rel=1e-4)
    aux_w = 1e-5 / (100.0 + 1e-5)                   # the ramp's end
    assert float(loss) == pytest.approx(
        float(aux['pred_loss']) + aux_w * float(aux['aux_loss']), rel=1e-6)


def test_amp_episode_matches_jax(amp_case):
    case = amp_case
    assert float(case['loss']) == pytest.approx(case['jloss'], rel=2e-2)
    for n in _trainable(case):
        got, want = case['grads'][n], case['jgrads'][n]
        assert got.dtype == torch.float32, n
        bar = min(0.99, _cos(want, case['grads32'][n]))
        assert _cos(got, want) >= bar, (n, _cos(got, want), bar)
