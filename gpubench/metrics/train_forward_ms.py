"""engine.trainer (forward): device ms of a training step's forward
(``model.loss_terms`` and the sum of its terms), the program's span
``engine.trainer.forward``: the sum over the traced steps recorded
whole over their count."""

from yardstick import spans


def read(rec, log=None):
    return spans.per_unit(log, "engine.trainer.forward", "engine.trainer.step")
