"""engine.trainer (host dispatch): device operations (kernels, memsets,
copies) per training step in the traced steps, as the port's
scripts/torch_step_profile.py counts them."""

from yardstick import tracing


def read(rec):
    if rec.trace is None:
        return None
    return tracing.launches_in_window(rec.trace) / rec.trace.steps
