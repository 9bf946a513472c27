"""device, in training: the share of the traced window (the traced
steps) in which no device operation ran, in %."""

from yardstick import tracing


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - tracing.busy_s(rec.trace) / rec.trace.window_s)
