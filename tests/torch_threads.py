"""One intra-op thread for torch in the port's tests.

The suite runs in several pytest-xdist workers at once, each importing
every test file. Left at its default, each worker's torch starts a thread
per core, and the workers' threads, many more than the cores, wait on one
another and on XLA's compiles in the other workers: the port's tests took
three times as long with them. Every port test file imports this module.
"""
import torch

torch.set_num_threads(1)
