"""Kernels, memcpys and memsets a traced step, from the profile."""


def read(run):
    if run.census is None:
        return None
    return run.census['launches'] + run.census['copies']
