"""engine.trainer (backward): device ms of a training step's
``backward()``, the program's span ``engine.trainer.backward``: the sum
over the traced steps recorded whole over their count."""

from yardstick import spans


def read(rec, log=None):
    return spans.per_unit(log, "engine.trainer.backward", "engine.trainer.step")
