"""Bank writes a traced step: the program's counter `bank.writes` (a
stream's append to the long-term bank) counted inside the traced steps.
The traffic's write gap fixes it; `bank.update_ms` and `bank.host_ms`
over it are their cost a write."""
from rmembench.spans import counted


def read(run):
    return counted(run, 'bank.writes')
