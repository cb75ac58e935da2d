"""Tensor-parallel serving of the port on the CPU: a model group of two
ranks over gloo against one process, and against the JAX package's model
mesh.

The spec table: the port's `tp_param_spec` splits exactly the leaves the
JAX package's `tp_param_spec` splits, along the corresponding dimension
of torch's layout, for every leaf of four models at tp 2 and 4 (mapped
through `flax_key_map`, the names `params_from_flax` gives), and each
model's module layouts agree with it. ZeRO-1 under TP picks the JAX
package's dimensions on a (data 2, model 2) mesh.

Serving: the same weights (a JAX init converted with `params_from_flax`)
and the same clip (49x49, 2 objects, 6 frames at write gap 1 with
latter_mem_len=2, so that eviction fires) go through the port in two
processes (tests/torch_dp_worker.py, one model group of two), through the
port in this process, and through the JAX package's InferEngine on a
('model',) mesh of 2 CPU devices with `shard_params` (as
tests/test_tensor_parallel.py drives it), for one head (`deaott`: B1 and
B2 on value shards), 8 heads (`aott`: 4 a rank, the mass averaged over
the group), two heads (`deaott` with `no_memory_gap`: B3) and the
ConvGRU's compression of an evicted slot (`aott` with `gru_memory`, the
slot gathered whole). Bars:
eviction ids identical at every update, more than 99.9% of mask pixels
equal, fp32 logits within 1e-4 of one process, both ranks alike. The eval
CLI with `--mesh 2` in two processes writes the masks of one process.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.engine import InferEngine as JaxEngine
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.parallel import tp as jtp

import torch_threads  # noqa: F401
import torch_dp_worker as worker
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.parallel import tp
from rmem_ocu_tpu_torch.parallel.dist import World
from rmem_ocu_tpu_torch.tools import eval as eval_cli
from rmem_ocu_tpu_torch.utils.convert import flax_key_map, params_from_flax

WORLD_TIMEOUT, GROUP_TIMEOUT = 300, 120
SPEC_MODELS = ('deaott', 'aott', 'r50_deaotl', 'r50_aotl')
SERVE_CASES = {'deaot': ('deaott', {}), 'aot': ('aott', {}),
               'deaot_2heads': ('deaott', dict(no_memory_gap=True,
                                               use_temporal_pe=False)),
               'aot_gru': ('aott', dict(gru_memory=True))}
S = worker.SERVE_SIZE


# ------------------------------------------------------ the spec table
@functools.lru_cache(maxsize=None)
def _template(name: str):
    """(port config, the JAX package's variables as shapes)."""
    jexp = jax_get_config('pre_vost', model=name)
    size = 65
    tree = jax.eval_shape(
        jax_build(jexp.model).init, jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, size, size, jexp.model.id_dim)))
    return get_config('pre_vost', model=name), tree


def _names(path):
    return [str(getattr(k, 'key', k)) for k in path]


def _torch_dim(names, shape, jdim):
    """The dimension of the port's tensor that is dimension jdim of the
    flax leaf (a Dense kernel transposes, a Conv kernel goes HWIO ->
    OIHW)."""
    if names[-1] == 'kernel' and len(shape) == 2:
        return 1 - jdim
    if names[-1] == 'kernel' and len(shape) == 4:
        return {0: 2, 1: 3, 2: 1, 3: 0}[jdim]
    return jdim


def _torch_shape(names, shape):
    out = [0] * len(shape)
    for d, n in enumerate(shape):
        out[_torch_dim(names, shape, d)] = n
    return tuple(out)


def _leaves(tree, cfg):
    """(flax names, shape, the port's key) of every 'params' leaf."""
    zeros = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.zeros((), np.float32), x.shape), tree)
    keys = flax_key_map(zeros, cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree['params'])[0]:
        names = _names(path)
        yield names, tuple(leaf.shape), keys['/'.join(names)]


@pytest.mark.parametrize('tp_size', [2, 4])
@pytest.mark.parametrize('name', SPEC_MODELS)
def test_spec_table_matches_jax(name, tp_size):
    """Every leaf: the JAX spec's 'model' dimension, in torch's layout, is
    the port's; the port's model splits exactly those tensors
    (`check_layout` raises otherwise)."""
    exp, tree = _template(name)
    split = {}
    for names, shape, key in _leaves(tree, exp.model):
        jspec = jtp.tp_param_spec(
            [jax.tree_util.DictKey(n) for n in ['params'] + names],
            np.broadcast_to(np.zeros((), np.float32), shape), tp_size)
        jdims = [d for d, e in enumerate(jspec) if e == 'model']
        want = _torch_dim(names, shape, jdims[0]) if jdims else None
        got = tp.tp_param_spec(key, _torch_shape(names, shape), tp_size)
        assert got == want, (key, got, want)
        if got is not None:
            split[key] = got
    assert split and all(k.startswith('LSTT.') for k in split)
    model = build_vos_model(exp.model, device='cpu')
    layout = tp.model_layout(model)
    tp.check_layout(layout, {k: p.shape for k, p in
                             model.named_parameters()}, tp_size)
    assert {k: d for k, (d, _) in layout.items()} == split


@pytest.mark.parametrize('name', ['deaott', 'aott'])
def test_zero1_under_tp_matches_jax(name):
    """state_shardings(zero1=True) on a (data 2, model 2) JAX mesh of CPU
    devices: on every leaf tensor parallelism splits, the port's ZeRO-1
    dimension (zero1_dim with TP's dimension taken) is the JAX one; on the
    others, which tie-break by layout where two dimensions are equally
    large, it is one of the same size."""
    exp, tree = _template(name)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ('data', 'model'))
    shards = jtp.state_shardings({'mu': tree['params']}, mesh, zero1=True)
    specs = {tuple(_names(p)[1:]): s.spec for p, s in
             jax.tree_util.tree_flatten_with_path(shards)[0]}
    n_split = 0
    for names, shape, key in _leaves(tree, exp.model):
        spec = list(specs[tuple(names)]) + [None] * len(shape)
        tdim = lambda e: next((_torch_dim(names, shape, d)
                               for d in range(len(shape)) if spec[d] == e),
                              None)
        tshape = _torch_shape(names, shape)
        taken = tp.tp_param_spec(key, tshape, 2)
        assert taken == tdim('model'), key
        got = tp.zero1_dim(tshape, () if taken is None else (taken,), 2)
        want = tdim('data')
        if taken is not None:
            n_split += 1
            assert got == want, (key, got, want)
        else:
            assert (got is None) == (want is None), key
            assert got is None or tshape[got] == tshape[want], key
    assert n_split


# ------------------------------------------------------------- serving
def _jax_weights(model: str, over: dict):
    jexp = jax_get_config('pre_vost', model=model, **over)
    jmodel = jax_build(jexp.model)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
        jnp.zeros((1, S, S, jexp.model.id_dim)))
    return jexp, jmodel, params


def _run_jax_tp(jexp, jmodel, params, seed):
    """The JAX package's engine on a ('model',) mesh of 2 CPU devices."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('model',))
    repl = NamedSharding(mesh, P())
    params = jtp.shard_params(params, mesh)
    eng = JaxEngine(jmodel, jexp, long_term_mem_gap=1)
    st = jax.device_put(eng.init_state(1, ((S - 1) // 16 + 1,) * 2), repl)
    img0, mask0, frames = worker.serving_clip(seed)
    st = eng.add_reference_frame(
        params, st, jax.device_put(jnp.asarray(img0), repl),
        jnp.asarray(mask0.astype(np.int32)), jnp.array([2], jnp.int32))
    out = {'logits': [], 'preds': [], 'ids': []}
    for f in frames:
        logits, st = eng.propagate(params, st,
                                   jax.device_put(jnp.asarray(f), repl))
        pred = eng.predict_mask(logits, (S, S))
        st = eng.update_memory(params, st, pred)
        out['logits'].append(np.asarray(logits))
        out['preds'].append(np.asarray(pred))
        out['ids'].append(np.asarray(st.bank.ordered_frame_ids))
    return out


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """{case: (one process, the group of two, the JAX model mesh)}. The
    group runs while this process runs the others."""
    root = str(tmp_path_factory.mktemp('tp_serve'))
    cases, jax_inputs = [], {}
    for name, (model, over) in SERVE_CASES.items():
        over = dict(over, latter_mem_len=2)
        jexp, jmodel, params = _jax_weights(model, over)
        path = os.path.join(root, f'{name}.pt')
        torch.save(params_from_flax(jax.device_get(params),
                                    get_config('pre_vost', model=model,
                                               **over).model), path)
        cases.append(dict(kind='serve', name=name, model=model,
                          overrides=over, weights=path, seed=5))
        jax_inputs[name] = (jexp, jmodel, params)
    spec = os.path.join(root, 'spec.json')
    with open(spec, 'w') as f:
        json.dump(dict(device='cpu', backend='gloo', timeout=GROUP_TIMEOUT,
                       out=root, cases=cases, tp=2), f)
    procs = worker.spawn(2, [worker.__file__, spec])
    try:
        one = {c['name']: worker.run_serving(c, World()) for c in cases}
        # the JAX engine reads its bank through its Pallas kernels in
        # interpret mode, whose bf16 operand rounding the port's plain
        # versions repeat
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv('RMEM_PALLAS', '1')
            jx = {c['name']: _run_jax_tp(*jax_inputs[c['name']], c['seed'])
                  for c in cases}
    finally:
        worker.wait(procs, WORLD_TIMEOUT)
    return {c['name']: (one[c['name']], torch.load(worker.digest_path(
        root, c['name'], 2)), jx[c['name']]) for c in cases}


def _agree(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize('name', list(SERVE_CASES))
def test_group_of_two_serves_as_one_process(served, name):
    one, two, _ = served[name]
    assert two['same_on_ranks']
    for i, (a, b) in enumerate(zip(one['ids'], two['ids'])):
        assert torch.equal(a, b), (i, a, b)
    # a frame's slot was evicted on the way
    assert set(range(1, worker.SERVE_FRAMES + 1)) - set(
        one['ids'][-1][0].tolist()), one['ids'][-1]
    for a, b in zip(one['logits'], two['logits']):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)
    for a, b in zip(one['preds'], two['preds']):
        assert _agree(a, b) > 0.999


@pytest.mark.parametrize('name', list(SERVE_CASES))
def test_group_of_two_serves_as_the_jax_model_mesh(served, name):
    _, two, jx = served[name]
    for a, b in zip(jx['ids'], two['ids']):
        np.testing.assert_array_equal(b.numpy(), a)
    for a, b in zip(jx['preds'], two['preds']):
        assert _agree(a, b.numpy()) > 0.999


def test_bank_holds_the_ranks_shard(served):
    """AOT's bank is split by heads (half a rank); DeAOT's keys stay whole
    and its values split (V and ID_V are 4 of each layer's 5 widths at one
    head, 2 of 3 at two)."""
    one, two, _ = served['aot']
    assert two['bank_bytes'] * 2 == one['bank_bytes']
    for name, whole_k in (('deaot', 1), ('deaot_2heads', 2)):
        one, two, _ = served[name]
        k = one['bank_bytes'] * whole_k // (whole_k + 8)
        assert two['bank_bytes'] == k + (one['bank_bytes'] - k) // 2


def test_eval_cli_mesh_two(tmp_path):
    """`--mesh 2` in two processes over gloo serves the synthetic test set
    as one model group: rank 0 of the group writes the masks, which are
    one process's."""
    from PIL import Image
    args = ['--stage', 'default', '--model', 'deaott', '--dataset', 'test',
            '--device', 'cpu', '--output']
    procs = worker.spawn(2, ['-m', 'rmem_ocu_tpu_torch.tools.eval', *args,
                             str(tmp_path / 'two'), '--mesh', '2',
                             '--backend', 'gloo'], cwd=str(tmp_path))
    old = os.getcwd()
    try:
        os.chdir(tmp_path)
        eval_cli.main(args + [str(tmp_path / 'one')])
    finally:
        os.chdir(old)
        worker.wait(procs, WORLD_TIMEOUT)
    one, two = tmp_path / 'one', tmp_path / 'two'
    seqs = sorted(p.name for p in one.iterdir() if p.is_dir())
    assert seqs and seqs == sorted(p.name for p in two.iterdir()
                                   if p.is_dir())
    n = same = 0
    for seq in seqs:
        names = sorted(os.listdir(one / seq))
        assert names == sorted(os.listdir(two / seq))
        for f in names:
            a = np.asarray(Image.open(one / seq / f))
            b = np.asarray(Image.open(two / seq / f))
            n, same = n + a.size, same + int((a == b).sum())
    assert same > 0.999 * n
    with open(two / 'print.log') as f:
        assert '[rank 0]' in f.read()
