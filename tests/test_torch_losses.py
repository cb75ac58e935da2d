"""The PyTorch port's training pieces against the JAX package, fp32 on the
CPU: the losses (values and gradients), the trainable BatchNorm, the
one-hot and id shuffle, the train-time IoU, drop-path and the channel
dropout, and the functional memory ops the training engine uses.

Same numpy inputs on both sides. Bars: losses and their gradients within
1e-6 relative (the same f32 arithmetic; the k-th largest value is exact on
both sides), BN outputs and running statistics within 1e-5, exact
equality for one-hots, shuffles and memory bookkeeping.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rmem_ocu_tpu.memory import bank as jbank
from rmem_ocu_tpu.ops import layers as jlayers
from rmem_ocu_tpu.ops import losses as jlosses
from rmem_ocu_tpu.ops import masks as jmasks
from rmem_ocu_tpu.utils.metric import batched_iou as jax_batched_iou

from rmem_ocu_tpu_torch.memory import bank
from rmem_ocu_tpu_torch.ops import losses
from rmem_ocu_tpu_torch.ops.layers import (BatchNorm2d, DropPath, DWConv2d,
                                           drop_path, noise_from)
from rmem_ocu_tpu_torch.ops.masks import (generate_permute_matrix,
                                          one_hot_mask, shuffle_one_hot,
                                          unshuffle_logits)
from rmem_ocu_tpu_torch.utils.meters import AverageMeter
from rmem_ocu_tpu_torch.utils.metric import batched_iou


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _topk_rows():
    """Rows of pixel losses: exact ties at the k-th value, -0.0 entries
    (perfectly classified pixels), and zeros of ignored pixels."""
    rs = np.random.RandomState(0)
    ties = np.abs(rs.randn(40)).astype(np.float32)
    ties[[3, 9, 17, 21, 30]] = ties[5]           # six entries equal
    negz = np.abs(rs.randn(40)).astype(np.float32)
    negz[::3] = -0.0
    ignored = np.abs(rs.randn(40)).astype(np.float32)
    ignored[rs.rand(40) < 0.6] = 0.0
    return np.stack([ties, negz, ignored])


@pytest.mark.parametrize('k', [1, 7, 12, 20, 27, 40])
def test_topk_sum_matches_jax(k):
    """Values and gradients of _topk_sum at ties, -0.0 and ignored
    pixels; the gradient at the threshold is the fair split."""
    x = _topk_rows()
    w = np.random.RandomState(k).rand(x.shape[0]).astype(np.float32)
    fj = lambda v: jnp.sum(jlosses._topk_sum(v, jnp.asarray(k, jnp.int32))
                           * w)
    want, gwant = jax.value_and_grad(fj)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = (losses._topk_sum(xt, k) * torch.from_numpy(w)).sum()
    got.backward()
    _close(got.item(), float(want))
    _close(xt.grad.numpy(), np.asarray(gwant))


@pytest.mark.parametrize('step', [0, 17, 49, 50, 51, 300])
def test_topk_cross_entropy_ramp_matches_jax(step):
    """The k ramp (f32, truncated) and the top-k CE with ignored pixels,
    value and gradient, at steps before, at and past the ramp's end."""
    rs = np.random.RandomState(step)
    logits = rs.randn(2, 9, 11, 4).astype(np.float32) * 2
    labels = (rs.rand(2, 9, 11) * 4).astype(np.int32)
    labels[rs.rand(2, 9, 11) < 0.1] = 255
    fj = lambda v: jnp.sum(jlosses.topk_cross_entropy(
        v, jnp.asarray(labels), jnp.asarray(step, jnp.int32), 50.0, 0.15)
        * jnp.asarray([1.0, 0.5]))
    want, gwant = jax.value_and_grad(fj)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = (losses.topk_cross_entropy(lt, torch.from_numpy(labels), step,
                                     50.0, 0.15)
           * torch.tensor([1.0, 0.5])).sum()
    got.backward()
    _close(got.item(), float(want))
    _close(lt.grad.numpy(), np.asarray(gwant))
    ratio = np.minimum(np.float32(1.0), np.float32(step) / np.float32(50.0))
    want_k = int(np.float32((ratio * np.float32(0.15) + (np.float32(1.0)
                                                         - ratio)) * 99))
    assert losses.hard_mining_k(99, step, 50.0, 0.15) == want_k


def test_soft_jaccard_absent_classes_matches_jax():
    """Classes absent from the labels, classes above obj_num and ignored
    pixels take no part; value and gradient."""
    rs = np.random.RandomState(3)
    logits = rs.randn(3, 8, 10, 5).astype(np.float32)
    labels = (rs.rand(3, 8, 10) * 3).astype(np.int32)    # ids 3, 4 absent
    labels[1] = 0                                         # only background
    labels[2, :2] = 255
    obj_nums = np.array([2, 4, 1], np.int32)
    fj = lambda v: jnp.sum(jlosses.soft_jaccard_loss(
        v, jnp.asarray(labels), jnp.asarray(obj_nums)) * jnp.arange(1, 4))
    want, gwant = jax.value_and_grad(fj)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = (losses.soft_jaccard_loss(lt, torch.from_numpy(labels),
                                    torch.from_numpy(obj_nums))
           * torch.arange(1, 4)).sum()
    got.backward()
    _close(got.item(), float(want))
    _close(lt.grad.numpy(), np.asarray(gwant))
    seg = losses.segmentation_loss(lt.detach(), torch.from_numpy(labels), 7,
                                   100, 0.5, 0.15, torch.from_numpy(obj_nums))
    _close(seg.numpy(), np.asarray(jlosses.segmentation_loss(
        jnp.asarray(logits), jnp.asarray(labels), 7, 100, 0.5, 0.15,
        jnp.asarray(obj_nums))))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_trainable_bn_matches_jax(dtype):
    """Train mode: batch statistics normalise, the running statistics move
    at momentum 0.1 to the batch mean and unbiased variance (f32 whatever
    the input dtype); deferred, they land in `pending` and the buffers
    stay. Eval mode: the running statistics normalise."""
    rs = np.random.RandomState(1)
    x = (rs.randn(3, 6, 5, 7) * 2 + 0.5).astype(np.float32)   # NCHW
    jbn = jlayers.BatchNorm(6)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 7, 6)))
    params = {'weight': rs.rand(6).astype(np.float32) + 0.5,
              'bias': rs.randn(6).astype(np.float32)}
    stats = {'running_mean': rs.randn(6).astype(np.float32),
             'running_var': rs.rand(6).astype(np.float32) + 0.5}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    jvars = {'params': params, 'batch_stats': stats}
    out, upd = jbn.apply(jvars, xj, mutable=['batch_stats'])
    out_eval = jbn.apply(jvars, xj)

    bn = BatchNorm2d(6)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**params, **stats}.items()})
    xt = torch.from_numpy(x).to(dtype)
    got = bn.train()(xt)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _close(got.detach().float().numpy().transpose(0, 2, 3, 1),
           np.asarray(out, np.float32), tol)
    for name in ('running_mean', 'running_var'):
        _close(getattr(bn, name).numpy(),
               np.asarray(upd['batch_stats'][name]), 1e-5)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**params, **stats}.items()})
    bn.defer_stats = True
    bn(xt)
    _close(bn.running_mean.numpy(), stats['running_mean'], 0.0)
    _close(bn.pending[1].numpy(), np.asarray(upd['batch_stats'][
        'running_var']), 1e-5)
    got_eval = bn.eval()(xt)
    _close(got_eval.detach().float().numpy().transpose(0, 2, 3, 1),
           np.asarray(out_eval, np.float32), tol)


def test_one_hot_and_shuffle_match_jax():
    """one_hot_mask with ignored and out-of-range labels; the shuffle and
    unshuffle of a given permutation; each permutation keeps id 0."""
    rs = np.random.RandomState(4)
    mask = (rs.rand(2, 6, 7) * 5).astype(np.int32)
    mask[0, 0, :3] = 255
    mask[1, 2, 2] = 9
    oh, ig = one_hot_mask(torch.from_numpy(mask), 4)
    joh, jig = jmasks.one_hot_mask(jnp.asarray(mask), 4)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(joh))
    np.testing.assert_array_equal(ig.numpy(), np.asarray(jig))

    perm = generate_permute_matrix(5, 2, torch.Generator().manual_seed(3))
    p = perm.numpy()
    assert (p[:, 0, 0] == 1).all()
    np.testing.assert_array_equal(p.sum(1), 1)
    np.testing.assert_array_equal(p.sum(2), 1)
    assert not np.array_equal(p[0], np.eye(5)) or not np.array_equal(
        p[1], np.eye(5))
    sh = shuffle_one_hot(oh, perm)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(
        jmasks.shuffle_one_hot(joh, jnp.asarray(p))))
    logits = rs.randn(2, 6, 7, 5).astype(np.float32)
    un = unshuffle_logits(torch.from_numpy(logits), perm)
    np.testing.assert_array_equal(un.numpy(), np.asarray(
        jmasks.unshuffle_logits(jnp.asarray(logits), jnp.asarray(p))))
    # unshuffling the shuffled one-hot's logits restores the ids
    np.testing.assert_array_equal(
        unshuffle_logits(sh, perm).numpy(), oh.numpy())


def test_drop_path_and_channel_dropout():
    """Rate 0 and eval mode are the identity; in training a sample is kept
    with probability 1 - rate and scaled by 1 / keep (drop-path: whole
    samples; DWConv2d: whole channels of a sample); the same generator
    seed draws the same masks."""
    x = torch.randn(4000, 3, 5) + 3.0
    assert drop_path(x, 0.0, True) is x
    assert DropPath(0.3).eval()(x) is x
    with noise_from(torch.Generator().manual_seed(0)):
        y = DropPath(0.3).train()(x)
    with noise_from(torch.Generator().manual_seed(0)):
        y2 = drop_path(x, 0.3, True)
    assert torch.equal(y, y2)
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | ~kept.any(1)).all())     # per sample
    share = kept.all(1).float().mean().item()
    assert abs(share - 0.7) < 0.03
    torch.testing.assert_close(y[kept.all(1)], x[kept.all(1)] / 0.7)

    conv = DWConv2d(16, dropout=0.25)
    tok = torch.randn(64, 12, 16)
    with torch.no_grad():
        base = conv.eval()(tok, (3, 4))
        with noise_from(torch.Generator().manual_seed(1)):
            dropped = conv.train()(tok, (3, 4))
    zero = (dropped == 0).all(1)                         # [B, C]
    assert bool(((dropped == 0) == zero[:, None]).all())
    assert abs(zero.float().mean().item() - 0.25) < 0.04
    torch.testing.assert_close(dropped[~zero[:, None].expand_as(dropped)],
                               (base / 0.75)[~zero[:, None].expand_as(
                                   dropped)])


def test_batched_iou_and_meter():
    rs = np.random.RandomState(5)
    pred = (rs.rand(3, 9, 9) * 4).astype(np.int32)
    gt = (rs.rand(3, 9, 9) * 4).astype(np.int32)
    for obj in ([2, 3, 1], [0, 0, 0], [3, 0, 2]):
        obj = np.array(obj, np.int32)
        want = float(jax_batched_iou(jnp.asarray(pred), jnp.asarray(gt),
                                     jnp.asarray(obj), 4))
        got = float(batched_iou(torch.from_numpy(pred), torch.from_numpy(gt),
                                torch.from_numpy(obj), 4))
        assert got == pytest.approx(want, rel=1e-6)
    m = AverageMeter(momentum=0.9)
    for v in (1.0, 3.0, 2.0):
        m.update(v)
    assert m.avg == pytest.approx(2.0)
    assert m.moving_avg == pytest.approx(0.9 * (0.9 * 1.0 + 0.1 * 3.0)
                                         + 0.1 * 2.0)


def test_functional_memory_matches_jax():
    """The training engine's functional append / evict / push against the
    JAX package's, step by step over a write every frame and evictions of
    the default drop slot past the budget: identical buffers and
    bookkeeping, the inputs untouched, and gradients reaching the frames
    written."""
    rs = np.random.RandomState(6)
    n_layers, b, cap, hw, ck, cv, skip = 2, 2, 4, 3, 5, 6, 2
    jb = jbank.init_bank(n_layers, b, cap, hw, ck, cv, True)
    js = jbank.init_short_term(n_layers, b, skip, hw, ck, cv, True)
    pb = bank.init_bank(n_layers, b, cap, hw, ck, cv, torch.float32, 'cpu')
    ps = bank.init_short_term(n_layers, b, skip, hw, ck, cv, torch.float32,
                              'cpu')
    leaves = []
    for t in range(6):
        news = [[rs.randn(b, hw, c).astype(np.float32)
                 for _ in range(n_layers)] for c in (ck, cv, cv)]
        tnews = [[torch.from_numpy(a).requires_grad_() for a in group]
                 for group in news]
        leaves += tnews[0]
        jnews = [tuple(jnp.asarray(a) for a in group) for group in news]
        old, before = pb, [x.detach().clone() for x in pb.k]
        pb = bank.append_frame_functional(pb, *tnews, t)
        jb = jbank.append_frame(jb, *jnews, t)
        assert all(torch.equal(x, y) for x, y in zip(old.k, before))
        over = pb.length > cap - 1
        pb = bank.evict_frame_functional(
            pb, bank.default_drop_index(pb, 1), enabled=over)
        jb = jbank.evict_frame(jb, jbank.default_drop_index(jb, 1),
                               enabled=jnp.asarray(over.numpy()))
        ps = bank.push_short_term_functional(ps, *tnews)
        js = jbank.push_short_term(js, *jnews)
        for got, want in ((pb.k, jb.k), (pb.v, jb.v), (pb.id_v, jb.id_v),
                          (ps.k, js.k), (ps.id_v, js.id_v)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.detach().numpy(),
                                              np.asarray(w))
        for name in ('length', 'pos', 'frame_ids', 'visits'):
            np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                          np.asarray(getattr(jb, name)))
        np.testing.assert_array_equal(ps.count.numpy(), np.asarray(js.count))
    sum(x.sum() for x in pb.k + ps.k).backward()
    # the frames still in the bank or the window get gradient, the
    # evicted-and-overwritten ones none
    live = [x.grad is not None and bool(x.grad.abs().sum() > 0)
            for x in leaves]
    assert any(live) and not all(live)


def test_trainable_bn_weights_convert_from_flax():
    """freeze_bn off: the flax 'batch_stats' collection lands in the
    trainable BN's running statistics, the affine in its parameters, and
    the model loads strictly."""
    from rmem_ocu_tpu import get_config as jax_get_config
    from rmem_ocu_tpu.models import build_vos_model as jax_build
    from rmem_ocu_tpu_torch import build_vos_model, get_config
    from rmem_ocu_tpu_torch.utils.convert import params_from_flax
    jcfg = jax_get_config('pre_vost', model='deaott', freeze_bn=False).model
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 33, 33, 3)),
                            jnp.zeros((1, 33, 33, jcfg.id_dim)))
    rs = np.random.RandomState(7)
    tree = jax.tree_util.tree_map(
        lambda x: rs.rand(*x.shape).astype(np.float32), dict(shapes))
    assert 'batch_stats' in tree
    cfg = get_config('pre_vost', model='deaott', freeze_bn=False).model
    model = build_vos_model(cfg, device='cpu')
    model.load_state_dict(params_from_flax(tree, cfg), strict=True)
    bn = model.get_submodule('encoder.features.0.1')
    assert isinstance(bn, BatchNorm2d) and bn.weight.requires_grad
    stats = tree['batch_stats']['encoder']['feat_0']['bn']
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  stats['running_var'])
