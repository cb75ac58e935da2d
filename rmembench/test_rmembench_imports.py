"""In a fresh interpreter: a whole run of the harness (on the CPU, at a
tiny size) loads no module whose top-level name is jax, jaxlib, flax or
rmem_ocu_tpu (the JAX package; the port's name only begins with it), and
the reference, every family of it included, loads nothing of the port."""
import json
import subprocess
import sys

from rmembench.testutil import ROOT

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from rmembench import run
from rmembench.testutil import run_cpu, tiny_cell
run_cpu(tiny_cell())
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import rmembench.reference.model, rmembench.reference.stream
import rmembench.reference.deaot, rmembench.reference.aot
import rmembench.check, rmembench.flops, rmembench.roofline
top = sorted({{m.split('.', 1)[0] for m in sys.modules}})
print(json.dumps(top))
"""


def _fresh(code):
    out = subprocess.run([sys.executable, '-c', code.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True,
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    assert _fresh(RUN) == []


def test_the_reference_loads_nothing_of_the_port():
    top = _fresh(REFERENCE)
    assert 'torch' in top
    for name in ('rmem_ocu_tpu_torch', 'rmem_ocu_tpu', 'jax', 'jaxlib',
                 'flax'):
        assert name not in top
