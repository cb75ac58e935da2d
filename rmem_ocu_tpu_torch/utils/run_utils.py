"""Run infrastructure: stdout tee (reference aot_plus/utils/utils.py)."""
from __future__ import annotations

import os
import sys


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
