"""Host milliseconds a traced step in the program's `propagate/encode`
span: enqueueing the encoder's work. Read under torch.profiler, so the
profiler's own cost per op is in it."""
from rmembench.spans import host_ms


def read(run):
    return host_ms(run, ['propagate/encode'])
