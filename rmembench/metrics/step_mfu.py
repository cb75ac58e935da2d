"""The whole step's share of the card's peak, %: the operations of a step
(counted on the configuration's reference family at the cell's shapes,
its `step_flops` through `rmembench/flops.py`, times the streams) times
the steps of the traced run's untraced window, over its seconds times the
bf16 dense peak."""
from rmembench.roofline import PEAK_FLOPS


def read(run):
    if run.timeline is None or run.n_steps == 0:
        return None
    work = run.flops_per_frame() * run.streams * run.n_steps
    return 100.0 * work / (run.window_s * PEAK_FLOPS['bfloat16'])
