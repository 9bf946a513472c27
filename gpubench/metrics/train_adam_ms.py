"""engine.trainer (Adam): device ms of a training step's
``optimizer.step()``, the program's span ``engine.trainer.adam``: the
sum over the traced steps recorded whole over their count (the step in
which the traced window closes, inside its Adam, is left out)."""

from yardstick import spans


def read(rec, log=None):
    return spans.per_unit(log, "engine.trainer.adam", "engine.trainer.step")
