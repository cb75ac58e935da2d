"""Kernel B1's share of its roofline, %: the least time of its calls in a
traced step (the bytes and operations of a read of the full bank at the
cell's shapes, as the configuration's reference family counts them in
`kernel_work` with `rmembench/roofline.py`, against the published peaks)
over the device time of the B1 kernel group in the step. Calls a step
from the model's structure: one bank read a layer, all streams in one
call, however many launches the program makes of a call."""
from rmembench.roofline import share


def read(run):
    return share(run, 'B1 memory_read')
