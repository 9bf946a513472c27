"""engine.evaluator (score): device ms a user batch of the scores
(``score_batch``, its product and sigmoid, and the cast to float32),
the program's span ``engine.evaluator.score``, mean over its spans."""

from yardstick import spans


def read(rec, log=None):
    return spans.per_span(log, "engine.evaluator.score")
