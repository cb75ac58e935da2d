"""MiB held by the engine state's long-term bank and short-term memory,
from their tensors' shapes and dtypes."""


def read(run):
    return run.bank_bytes / 2 ** 20
