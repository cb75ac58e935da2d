"""The port's model registry and weight keys against the JAX package's.

Every model of the JAX registry, in every stage, has the same field values
in the port (the port's fields; training settings are not in it). Every
model's state_dict keys are exactly the reference torch keys that the JAX
package's converter (`_flax_key_to_torch`) gives its flax tree; the tree,
converted with params_from_flax, loads strictly; and a `.pth` written from
those keys loads through load_torch_pretrained with nothing left at init.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmem_ocu_tpu.config import defaults as jax_defaults
from rmem_ocu_tpu.models import build_vos_model as jax_build
from rmem_ocu_tpu.utils.torch_convert import _flax_key_to_torch

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import build_vos_model, get_config
from rmem_ocu_tpu_torch.config import MODEL_REGISTRY, STAGE_REGISTRY
from rmem_ocu_tpu_torch.utils.checkpoint import load_torch_pretrained
from rmem_ocu_tpu_torch.utils.convert import params_from_flax

MODELS = sorted(jax_defaults.MODEL_REGISTRY)


def test_registry_has_every_jax_model():
    assert sorted(MODEL_REGISTRY) == MODELS
    assert set(STAGE_REGISTRY) == set(jax_defaults.STAGE_REGISTRY)


@pytest.mark.parametrize('model', MODELS)
def test_model_config_matches_jax(model):
    for stage in STAGE_REGISTRY:
        port = get_config(stage, 'x', model).model
        ref = jax_defaults.get_config(stage, 'x', model).model
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), (
                stage, f.name)


def _reference_keys(params, cfg):
    """The torch key of every flax leaf, by the JAX package's own map."""
    keys = set()
    for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
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


@pytest.mark.parametrize('model', MODELS)
def test_weight_keys_match_reference(model, tmp_path):
    jcfg = jax_defaults.get_config('pre_vost_2', model=model).model
    # a 16k+1 input for align_corners models, 16k without: the id bank's
    # grid then equals the encoder's
    size = 33 if jcfg.align_corners else 32
    shapes = jax.eval_shape(
        jax_build(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, size, size, jcfg.id_dim)))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: rng.rand(*x.shape).astype(np.float32),
        {'params': shapes['params']})
    cfg = get_config('pre_vost_2', model=model).model
    net = build_vos_model(cfg, device='cpu')
    assert set(net.state_dict()) == _reference_keys(params, jcfg)

    state_dict = params_from_flax(params, cfg)
    net.load_state_dict(state_dict, strict=True)
    path = str(tmp_path / 'w.pth')
    torch.save(state_dict, path)
    fresh = build_vos_model(cfg, device='cpu', seed=1)
    assert load_torch_pretrained(path, fresh) == []
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, state_dict[key]), key
