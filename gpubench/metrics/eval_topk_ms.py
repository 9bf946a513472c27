"""engine.evaluator (top-k): device ms a user batch of the ranking
(``torch.topk``, or ``sharded_topk`` on a model axis), the program's span
``engine.evaluator.topk``, mean over its spans: whatever kernels
implement it."""

from yardstick import spans


def read(rec, log=None):
    return spans.per_span(log, "engine.evaluator.topk")
