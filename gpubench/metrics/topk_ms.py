"""engine.evaluator: device ms of the top-k kernels per user batch in
the traced sweeps, the batches being the test users in batches of
``test_batch_size``. The kernels are found by name; with none in the
trace the metric is absent."""

from yardstick import tracing

NAMES = ("topk", "TopK", "radixFindKthValues", "computeBlockwise", "gatherTopK")


def read(rec):
    if rec.trace is None:
        return None
    seconds = tracing.device_time(rec.trace, tracing.matcher(NAMES))
    if seconds <= 0:
        return None
    per_sweep = -(-rec.graph["test_users"] // rec.cell.keys.int("test_batch_size"))
    return 1e3 * seconds / (rec.trace.steps * per_sweep)
