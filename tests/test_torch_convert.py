"""Weight bridge of the PyTorch port: flax params -> params_from_flax ->
the port's state_dict (strict load) -> back through the JAX package's own
convert_torch_params gives the original flax leaves exactly, and the
state_dict keys are the reference torch names."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rmem_ocu_tpu import get_config as jax_get_config
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.utils.torch_convert import (_flax_key_to_torch,
                                              convert_torch_params)

from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

SIZE = 33


@pytest.fixture(scope='module')
def flax_params():
    jexp = jax_get_config('pre_vost_2', model='r50_deaotl')
    # the leaves' shapes only (an abstract trace, not an initialisation)
    shapes = jax.eval_shape(
        jax_build(jexp.model).init, jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, jexp.model.id_dim)))
    # distinct values in every leaf, so a swapped or transposed leaf shows
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), shapes)
    return jexp, params


def _reference_keys(params, cfg):
    """The torch key of every flax leaf, by the JAX package's own map."""
    keys = set()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for kp, _ in flat:
        *mod, leaf = [k.key for k in kp][1:]
        pre = _flax_key_to_torch(tuple(mod), cfg)
        pre = f'{pre}.' if pre else ''
        if leaf in ('relative_emb_k_w', 'relative_emb_k_b'):
            keys.add(pre + 'relative_emb_k.'
                     + ('weight' if leaf.endswith('_w') else 'bias'))
        elif leaf in ('kernel', 'scale'):
            keys.add(pre + 'weight')
        else:
            keys.add(pre + leaf)
    return keys


def test_flax_to_port_round_trip(flax_params):
    jexp, params = flax_params
    exp = get_config('pre_vost_2', model='r50_deaotl')
    model = build_vos_model(exp.model, device='cpu')
    model.load_state_dict(params_from_flax(params, exp.model), strict=True)
    back, missing = convert_torch_params(model.state_dict(), params,
                                         jexp.model)
    assert not missing
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for (kp, w), g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), w,
                                      err_msg=jax.tree_util.keystr(kp))


def test_state_dict_keys_are_reference_names(flax_params):
    jexp, params = flax_params
    exp = get_config('pre_vost_2', model='r50_deaotl')
    model = build_vos_model(exp.model, device='cpu')
    assert set(model.state_dict()) == _reference_keys(params, jexp.model)
    assert set(params_from_flax(params, exp.model)) == set(model.state_dict())
