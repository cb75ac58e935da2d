"""Device milliseconds a traced step in the encoder (the census's component
'encoder': every kernel launched under the encoder's modules)."""


def read(run):
    if run.census is None:
        return None
    return run.census['components'].get('encoder')
