"""Host milliseconds a traced step in the program's `propagate/gpm` span:
enqueueing the GPM's work (the temporal PE, the memories' read-out and
the LSTT with its bank reads). Read under torch.profiler, so the
profiler's own cost per op is in it."""
from rmembench.spans import host_ms


def read(run):
    return host_ms(run, ['propagate/gpm'])
