"""Kernel B2's share of its roofline, %: the least time of its calls in a
traced step (operations and bytes of a 15x15-window read at the cell's
grid, `rmembench/roofline.py`) over the device time of the B2 kernel
group in the step. Calls a step from the model's structure: one
short-term read a GPM layer, all streams in one call."""
from rmembench.roofline import b2_work, bound_s

GROUP = 'B2 local_attn'


def read(run):
    if run.census is None or not run.census['groups'].get(GROUP):
        return None
    mc = run.config['model']
    d = mc['encoder_embedding_dim']
    n_bytes, n_flops = b2_work(run.streams, run.grid, d // 2, 4 * d)
    least_s = bound_s(n_bytes, n_flops, run.config['compute_dtype'])[0]
    calls = mc['lstt_num']
    return 100.0 * least_s * calls / (run.census['groups'][GROUP] / 1e3)
