"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled for `sm_90a` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) under
`rmem_ocu_tpu_torch/build/`, which git ignores. A library's file name holds
a hash of its sources and flags, so an edited source is rebuilt and a
finished build is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output of the last build of each library (ptxas register and
# spill report), kept for the smoke script to print
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob('*.cu*')):
        if src.suffix == '.cuh' or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}_{h.hexdigest()[:12]}.so'


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named kernels, one nvcc process each, all at once.
    Returns {name: library path}; raises with the compiler's output if one
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-I', str(CSRC_DIR), '-o', str(tmp),
               str(CSRC_DIR / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f'{name}:\n{log}')
            continue
        os.replace(tmp, out)       # atomic: concurrent builds agree
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib
