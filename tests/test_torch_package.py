"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on the card unless asked for the CPU, its
config agrees with the JAX package's, and chip_smoke.py refuses to report
without a GPU."""
import os
import pkgutil
import re
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import pytest
import torch

from rmem_ocu_tpu.config import get_config as jax_get_config

import torch_threads  # noqa: F401
from rmem_ocu_tpu_torch import InferEngine, build_vos_model, get_config
from rmem_ocu_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'rmem_ocu_tpu_torch'
FORBIDDEN = ('jax', 'flax', 'rmem_ocu_tpu')


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix='rmem_ocu_tpu_torch.')]


def test_import_loads_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest),
    importing every module of the port (the training data, checkpoints and
    CLIs among them) leaves JAX, flax and the JAX package out of
    sys.modules."""
    assert {f'rmem_ocu_tpu_torch.{m}' for m in (
        'data.train_datasets', 'data.video_transforms', 'utils.checkpoint',
        'utils.run_utils', 'tools.train', 'tools.pipeline', 'tools.accept',
        'tools.prepare_extracted', 'tools.eval')} <= set(_port_modules())
    code = (
        'import importlib, sys\n'
        f'for name in {_port_modules()!r}:\n'
        '    importlib.import_module(name)\n'
        f'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        f'{FORBIDDEN!r})\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_imports_in_sources():
    pattern = re.compile(
        r'^\s*(?:from|import)\s+(?:jax|flax|rmem_ocu_tpu)(?:\.|\s|$)',
        re.MULTILINE)
    sources = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    assert len(sources) > 10
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = get_config('pre_vost_2', model='r50_deaotl').model
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        build_vos_model(cfg)
    model = build_vos_model(cfg, device='cpu')
    eng = InferEngine(model, get_config('pre_vost_2', model='r50_deaotl'))
    assert eng.device.type == 'cpu'
    assert eng.init_state(1, (2, 3)).bank.k[0].device.type == 'cpu'


@pytest.mark.parametrize('stage,model,overrides', [
    ('pre_vost_2', 'r50_deaotl', {'compute_dtype': 'bfloat16'}),
    ('pre_vost', 'r50_deaotl', {'latter_mem_len': 2}),
    ('pre_vost_2', 'r50_deaotl', {'no_memory_gap': True}),
    ('pre_vost_2', 'r50_aotl', {}),
    ('default', 'r50_aotl', {'gru_memory': True}),
])
def test_config_matches_jax(stage, model, overrides):
    port = get_config(stage, model=model, **overrides)
    ref = jax_get_config(stage, model=model, **overrides)
    for f in fields(port.model):
        assert getattr(port.model, f.name) == getattr(ref.model, f.name), \
            f.name
    for f in fields(port):
        if f.name != 'model':
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.model.id_dim == ref.model.id_dim == 12
    assert port.model.mem_bank_capacity == ref.model.mem_bank_capacity == (
        1 + ref.model.latter_mem_len + 1)


@pytest.mark.parametrize('alone', [False, True], ids=['repo', 'alone'])
def test_chip_smoke_fails_without_a_gpu(alone, tmp_path):
    """With no CUDA device (hidden here), or copied alone into an empty
    directory, chip_smoke.py exits non-zero and prints no result."""
    script = ROOT / 'chip_smoke.py'
    if alone:
        script = tmp_path / 'chip_smoke.py'
        script.write_text((ROOT / 'chip_smoke.py').read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
