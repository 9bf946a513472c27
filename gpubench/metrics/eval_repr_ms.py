"""models (``RecModel.eval_embeddings`` as ``Evaluator.compute_repr``
calls it): device ms of a sweep's representation, the program's span
``models.eval_embeddings`` inside ``engine.evaluator.sweep``, over the
count of sweeps."""

from yardstick import spans


def read(rec, log=None):
    return spans.per_unit(log, "models.eval_embeddings", "engine.evaluator.sweep")
