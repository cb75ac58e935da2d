"""Device milliseconds a traced step in the memory update (census components
'memory_update' and 'id_embed': the id tokens of the masks, the fused id
values, the short-term push, the bank's write, scoring and eviction)."""


def read(run):
    if run.census is None:
        return None
    comps = run.census['components']
    parts = [comps[c] for c in ('memory_update', 'id_embed') if c in comps]
    return sum(parts) if parts else None
