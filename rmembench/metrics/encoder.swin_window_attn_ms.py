"""Device milliseconds a traced step in Swin-B's window attention (every
kernel under a `WindowAttention` module of the encoder, qkv and proj
linears included); nothing to read in an encoder without one."""
import re

PART = re.compile(r'^encoder\.layers\.N\.blocks\.N\.attn$')


def read(run):
    if run.census is None:
        return None
    parts = [v for k, v in run.census['parts'].items() if PART.match(k)]
    return sum(parts) if parts else None
