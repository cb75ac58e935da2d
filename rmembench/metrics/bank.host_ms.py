"""Host milliseconds a traced step in the program's spans of the bank's
write, scoring and eviction (`update_memory/bank_append`, `bank_score`,
`bank_evict`), over all traced steps, those without a write included.
Read under torch.profiler, so the profiler's own cost per op is in it."""
from rmembench.spans import host_ms


def read(run):
    return host_ms(run, ['update_memory/bank_append',
                         'update_memory/bank_score',
                         'update_memory/bank_evict'])
