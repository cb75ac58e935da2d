"""Data parallelism over processes: the process group and ZeRO-1."""
