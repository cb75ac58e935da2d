"""Device milliseconds a traced step in the FPN decoder (census component
'decode')."""


def read(run):
    if run.census is None:
        return None
    return run.census['components'].get('decode')
