"""engine.evaluator (mask): device ms a user batch of the mask of the
train positives (the spare column's pad, the ``index_put_``, the
slice), the program's span ``engine.evaluator.mask``, mean over its
spans."""

from yardstick import spans


def read(rec, log=None):
    return spans.per_span(log, "engine.evaluator.mask")
