"""Port-only checks of the training step, with no JAX compile: the
checkpointed episode gives the gradients of the plain one with every
dropout on, the routing of fault C1 (training mode runs no kernel and
gradients reach the encoder and the propagation module; the kernel
wrappers refuse inputs that require grad), the XLA-only knobs raise, and
the trainable BN's statistics come out of an episode once.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.engine import train_engine
from rmem_ocu_tpu_torch.engine.train_engine import TrainEngine
from rmem_ocu_tpu_torch.ops import attention
from rmem_ocu_tpu_torch.ops.kernels.local_attn import local_window_attention
from rmem_ocu_tpu_torch.ops.kernels.memory_read import memory_read_fused
from rmem_ocu_tpu_torch.ops.kernels.memory_read_mh import (
    memory_read_attention, memory_read_multihead)
from rmem_ocu_tpu_torch.ops.layers import BatchNorm2d

SIZE = 49


def _clip(b, t, seed):
    rs = np.random.RandomState(seed)
    frames = rs.randn(b, t, SIZE, SIZE, 3).astype(np.float32)
    masks = (rs.rand(b, t, SIZE, SIZE) * 3).astype(np.int32)
    masks[:, :, :3, :5] = 255
    return frames, masks


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


def test_remat_full_and_none_give_the_same_gradients():
    """With every dropout on (drop-path, embedding, id, long- and
    short-term, the gated attentions' channel dropout) and one generator
    seed, checkpointing the encoder and each frame step changes nothing:
    the recompute draws the masks its first run drew."""
    exp = get_config('pre_vost', model='deaott', data_seq_len=3,
                     train_total_steps=100, train_lstt_droppath=0.2,
                     train_lstt_emb_dropout=0.1,
                     train_lstt_id_dropout=0.1, train_lstt_lt_dropout=0.1,
                     train_lstt_st_dropout=0.1)
    exp = replace(exp, train_long_term_mem_gap=1)
    frames, masks = _clip(1, 3, seed=5)
    out = {}
    for policy in ('full', 'none'):
        e = replace(exp, train_remat_policy=policy)
        model = build_vos_model(e.model, device='cpu', seed=3, exp=e).train()
        loss, _, grads = _port_episode(model, e, frames, masks, [2], 10.0,
                                       use_prev_pred=False)
        out[policy] = (loss, grads)
    assert torch.equal(out['full'][0], out['none'][0])
    for n, g in out['full'][1].items():
        torch.testing.assert_close(g, out['none'][1][n], rtol=1e-6,
                                   atol=1e-9)
    # the masks did act: another seed gives another loss
    model = build_vos_model(exp.model, device='cpu', seed=3, exp=exp).train()
    other = TrainEngine(model, exp).episode_loss(
        torch.from_numpy(frames), torch.from_numpy(masks), torch.tensor([2]),
        10.0, torch.Generator().manual_seed(1), enable_id_shuffle=False)[0]
    assert float(other.detach()) != float(out['full'][0])


@pytest.mark.parametrize('model,overrides', [
    ('deaott', {}),                                   # B1, B2
    ('deaott', dict(no_memory_gap=True)),             # B3
    ('aott', {}),                                     # B1, several heads
], ids=['one_head', 'two_heads', 'aot'])
def test_training_mode_runs_no_kernel(model, overrides, monkeypatch):
    """Fault C1: in train() mode no kernel wrapper is entered, and the
    gradients reach the encoder and the propagation module. In eval mode
    under no_grad the same modules call them."""
    entered = []

    def spy(fn):
        def wrapped(*a, **k):
            entered.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    for name in ('memory_read_fused', 'memory_read_multihead',
                 'local_window_attention'):
        monkeypatch.setattr(attention, name, spy(getattr(attention, name)))
    exp = replace(get_config('pre_vost', model=model, data_seq_len=3,
                             **overrides), train_long_term_mem_gap=1)
    net = build_vos_model(exp.model, device='cpu', exp=exp).train()
    frames, masks = _clip(1, 3, seed=8)
    _, _, grads = _port_episode(net, exp, frames, masks, [2], 0.0)
    assert entered == []
    assert float(grads['encoder.features.0.0.weight'].abs().max()) > 0
    assert float(grads['LSTT.layers.0.norm1.weight'].abs().max()) > 0

    from rmem_ocu_tpu_torch import InferEngine
    net.eval()
    eng = InferEngine(net, exp, long_term_mem_gap=1)
    st = eng.init_state(1, (4, 4))
    st = eng.add_reference_frame(st, torch.from_numpy(frames[:, 0]),
                                 torch.from_numpy(masks[:, 0]),
                                 torch.tensor([2]))
    for t in (1, 2):
        logits, st = eng.propagate(st, torch.from_numpy(frames[:, t]))
        st = eng.update_memory(st, eng.predict_mask(logits, (SIZE, SIZE)))
    assert entered


def test_kernel_wrappers_refuse_autograd():
    """Each wrapper raises on an input that requires grad under grad mode
    (it has no backward), on the CPU as on the card; under no_grad it
    runs."""
    rs = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    q, k, v = t(1, 6, 16), t(1, 3, 6, 16), t(1, 3, 6, 8)
    valid = torch.ones(1, 3, dtype=torch.bool)
    calls = {
        'memory_read_fused': lambda q: memory_read_fused(
            q, k, (v,), valid, 1, 0.25),
        'memory_read_multihead': lambda q: memory_read_multihead(
            q, k, v, valid, 2, 0.25),
        'memory_read_attention': lambda q: memory_read_attention(
            q, k, v, valid),
        'local_window_attention': lambda q: local_window_attention(
            q, q.detach(), t(1, 6, 8), t(1, 6, 225), (2, 3), 7,
            precise=True),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='no backward'):
            call(q.clone().requires_grad_())
        with torch.no_grad():
            call(q.clone().requires_grad_())
        call(q)                          # nothing requires grad


@pytest.mark.parametrize('knob,value', [
    ('train_remat_policy', 'dots'), ('train_remat_policy', 'dots_k1024'),
    ('train_scan_unroll', 2), ('train_encoder_chunk', 2),
    ('train_spatial_sharding', True), ('train_zero1', True)])
def test_xla_only_knobs_raise(knob, value):
    exp = replace(get_config('pre_vost', model='deaott'), **{knob: value})
    model = build_vos_model(exp.model, device='cpu', exp=exp)
    with pytest.raises(NotImplementedError, match=knob):
        TrainEngine(model, exp)
    assert train_engine.check_port_knobs(get_config('pre_vost')) is None


def test_trainable_bn_stats_come_out_once():
    """freeze_bn off: the encoder's BatchNorm layers normalise by the
    batch, and the episode returns their new running statistics for the
    caller to store, the same with and without the encoder's checkpoint
    (whose recompute runs the BN forward a second time)."""
    stats = {}
    for policy in ('full', 'none'):
        exp = get_config('pre_vost', model='deaott', data_seq_len=2,
                         train_remat_policy=policy, freeze_bn=False)
        model = build_vos_model(exp.model, device='cpu', seed=2,
                                exp=exp).train()
        bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
        assert bns
        before = bns[0].running_mean.clone()
        frames, masks = _clip(1, 2, seed=9)
        loss, aux, _ = _port_episode(model, exp, frames, masks, [2], 0.0)
        assert torch.equal(bns[0].running_mean, before)
        stats[policy] = aux['batch_stats']
    assert stats['full'].keys() == stats['none'].keys()
    for name, (mean, var) in stats['full'].items():
        torch.testing.assert_close(mean, stats['none'][name][0])
        torch.testing.assert_close(var, stats['none'][name][1])
    assert not torch.equal(stats['full']['encoder.features.0.1'][0], before)
