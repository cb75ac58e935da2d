"""Run infrastructure: stdout tee, timestamped log dirs, source snapshot.

Reference: aot_plus/utils/utils.py:44-100 (Tee, make_log_dir, copy_codes).
"""
from __future__ import annotations

import os
import shutil
import sys
import time


class Tee:
    """Mirror stdout to a log file (reference utils.py:81-100)."""

    def __init__(self, path: str, mode: str = 'a'):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        self.file = open(path, mode)
        self.stdout = sys.stdout
        sys.stdout = self

    def close(self):
        sys.stdout = self.stdout
        self.file.close()

    def write(self, data):
        self.file.write(data)
        self.stdout.write(data)
        self.flush()

    def flush(self):
        self.file.flush()
        self.stdout.flush()


def make_log_dir(root: str, prefix: str = '') -> str:
    """A new directory `root/<prefix><YYYYmmdd-HHMMSS>`."""
    path = os.path.join(root, prefix + time.strftime('%Y%m%d-%H%M%S'))
    os.makedirs(path, exist_ok=True)
    return path


def copy_codes(log_dir: str, src_root: str = None) -> str:
    """Snapshot the port's sources (.py, .sh, .md, and the CUDA sources)
    into `log_dir/code_snapshot` (reference utils.py:66-73)."""
    src_root = src_root or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    dst = os.path.join(log_dir, 'code_snapshot')
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = [d for d in dirnames
                       if d not in ('__pycache__', '.git', 'results',
                                    'build')]
        for fn in filenames:
            if fn.endswith(('.py', '.sh', '.md', '.cu', '.cuh')):
                src = os.path.join(dirpath, fn)
                out = os.path.join(dst, os.path.relpath(src, src_root))
                os.makedirs(os.path.dirname(out), exist_ok=True)
                shutil.copyfile(src, out)
    return dst
