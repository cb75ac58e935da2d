"""Device milliseconds a traced step in the GPM's short-term reads (census
component 'short_term_attn': kernel B2 and the gating around it)."""


def read(run):
    if run.census is None:
        return None
    return run.census['components'].get('short_term_attn')
