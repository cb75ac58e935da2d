"""Host milliseconds a step spent in the calls into the engine (propagate,
predict_mask, update_memory), from the harness's own clock around them,
averaged over the untraced window's steps."""
import statistics


def read(run):
    return statistics.fmean(run.host_ms) if run.host_ms else None
