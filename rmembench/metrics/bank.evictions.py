"""Evictions a traced step: the program's counter `bank.evictions` (the
streams over budget at each bank write) counted inside the traced steps.
With the bank at its budget every write evicts once, so it equals
`bank.writes`: fewer would leave a bank over budget, more cannot be."""
from rmembench.spans import counted


def read(run):
    return counted(run, 'bank.evictions')
