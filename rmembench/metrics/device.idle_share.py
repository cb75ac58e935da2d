"""Share of the traced steps' wall time with nothing running on the
device, %: one minus the union of kernel, memcpy and memset intervals
over the traced window's length."""


def read(run):
    if run.timeline is None:
        return None
    t = run.timeline
    return 100.0 * max(0.0, 1.0 - t['busy_s'] / t['window_s'])
