"""Device milliseconds a traced step in the GPM's long-term reads (census
component 'long_term_attn': kernel B1 and the gating around it)."""


def read(run):
    if run.census is None:
        return None
    return run.census['components'].get('long_term_attn')
