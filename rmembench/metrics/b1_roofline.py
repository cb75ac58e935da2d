"""Kernel B1's share of its roofline, %: the least time of its calls in a
traced step (operations and bytes of a read of the full bank at the
cell's shapes, `rmembench/roofline.py`, against the published peaks)
over the device time of the B1 kernel group in the step. Calls a step
from the model's structure: one bank read a GPM layer, all streams in
one call, however many launches the program makes of a call."""
from rmembench.roofline import b1_work, bound_s

GROUP = 'B1 memory_read'


def read(run):
    if run.census is None or not run.census['groups'].get(GROUP):
        return None
    mc = run.config['model']
    d = mc['encoder_embedding_dim']
    n_live = mc['former_mem_len'] + mc['latter_mem_len']
    n_bytes, n_flops = b1_work(run.streams, run.grid[0] * run.grid[1],
                               n_live, n_live + 1, d // 2, (2 * d, 2 * d))
    least_s = bound_s(n_bytes, n_flops, run.config['compute_dtype'])[0]
    calls = mc['lstt_num']
    return 100.0 * least_s * calls / (run.census['groups'][GROUP] / 1e3)
