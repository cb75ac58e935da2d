"""Kernel B2's share of its roofline, %: the least time of its calls in a
traced step (the bytes and operations of a 15x15-window read at the
cell's grid, as the configuration's reference family counts them in
`kernel_work` with `rmembench/roofline.py`) over the device time of the
B2 kernel group in the step. Calls a step from the model's structure: one
short-term read a layer, all streams in one call. None in a family that
has no windowed read."""
from rmembench.roofline import share


def read(run):
    return share(run, 'B2 local_attn')
