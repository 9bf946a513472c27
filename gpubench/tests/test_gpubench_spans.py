"""The eight metrics that read the program's span log
(``idgrec_torch.engine.profiling.span_log``, source ``program_span``):
each reader on a hand-made log against its value by hand, and absent
when its spans, or the program's log, are missing."""

from __future__ import annotations

import pytest

from yardstick import manifest


def metric(name):
    return manifest.metric_reader(name)


# the metrics that read the program's span log
SPAN_METRICS = ("train_forward_ms", "train_backward_ms", "train_adam_ms", "k6_roofline.span",
                "eval_repr_ms", "eval_score_ms", "eval_mask_ms", "eval_topk_ms")


def _span(name, parent, ms, whole=True, thread=1):
    from idgrec_torch.engine.profiling import Span

    return Span(name=name, parent=parent, thread=thread, device_ms=ms, whole=whole)


def _train_log():
    # two whole steps and the one the traced window closed in (its Adam
    # not whole); the backward's K6 spans on another thread, no parent
    log = []
    for fwd, bwd, adam, whole in ((3.0, 4.0, 2.0, True), (5.0, 6.0, 1.0, True),
                                  (100.0, 100.0, 100.0, False)):
        step = len(log)
        log.append(_span("engine.trainer.step", None, fwd + bwd + adam + 0.5, whole))
        log.append(_span("engine.trainer.forward", step, fwd))
        log.append(_span("ops.fusedmm.k6", step + 1, 1.0))
        log.append(_span("ops.fusedmm.k6", None, 1.5, thread=2))
        log.append(_span("engine.trainer.backward", step, bwd))
        log.append(_span("engine.trainer.adam", step, adam, whole))
    return log


def _eval_log():
    log = []
    for repr_ms, batches in ((2.0, ((1.0, 2.0, 3.0), (1.5, 2.5, 3.5))), (3.0, ((2.0, 3.0, 4.0),))):
        sweep = len(log)
        log.append(_span("engine.evaluator.sweep", None, 50.0))
        log.append(_span("models.eval_embeddings", sweep, repr_ms))
        log.append(_span("ops.fusedmm.k6", sweep + 1, 0.5))
        for score, mask, topk in batches:
            log += [_span("engine.evaluator.score", sweep, score),
                    _span("engine.evaluator.mask", sweep, mask),
                    _span("engine.evaluator.topk", sweep, topk)]
    return log


def test_train_span_metrics_by_hand(tiny_cell):
    from yardstick.drivers import Record

    rec = Record(cell=tiny_cell("recdcl-yelp2018.train"),
                 graph={"num_users": 3, "num_items": 5, "nnz": 7, "test_users": 2})
    log = _train_log()
    # the steps recorded whole: (3 + 5) / 2, (4 + 6) / 2, (2 + 1) / 2
    assert metric("train_forward_ms").read(rec, log) == pytest.approx(4.0)
    assert metric("train_backward_ms").read(rec, log) == pytest.approx(5.0)
    assert metric("train_adam_ms").read(rec, log) == pytest.approx(1.5)
    # six K6 applications of 1.0 and 1.5 ms: 7.5 ms
    width = rec.cell.keys.int("embedding_size") * rec.cell.config["work"]["chains"]
    least = metric("k6_roofline").least_seconds(3, 5, 7, width)
    assert metric("k6_roofline.span").read(rec, log) == pytest.approx(
        100 * 6 * least / 7.5e-3)


def test_eval_span_metrics_by_hand(tiny_cell):
    from yardstick.drivers import Record

    rec = Record(cell=tiny_cell("lightgcn-amazon-book.eval"),
                 graph={"num_users": 3, "num_items": 5, "nnz": 7, "test_users": 2})
    log = _eval_log()
    assert metric("eval_repr_ms").read(rec, log) == pytest.approx((2.0 + 3.0) / 2)
    # three batches in two sweeps
    assert metric("eval_score_ms").read(rec, log) == pytest.approx((1.0 + 1.5 + 2.0) / 3)
    assert metric("eval_mask_ms").read(rec, log) == pytest.approx((2.0 + 2.5 + 3.0) / 3)
    assert metric("eval_topk_ms").read(rec, log) == pytest.approx((3.0 + 3.5 + 4.0) / 3)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_metric_without_its_spans_is_absent(name, tiny_cell, monkeypatch):
    from idgrec_torch.engine import profiling
    from yardstick.drivers import Record

    rec = Record(cell=tiny_cell("recdcl-yelp2018.train"),
                 graph={"num_users": 3, "num_items": 5, "nnz": 7, "test_users": 2})
    reader = metric(name)
    assert reader.read(rec, []) is None
    other = _eval_log() if name.startswith("train") or name.startswith("k6") else _train_log()
    assert reader.read(rec, [s for s in other if s.name != "ops.fusedmm.k6"]) is None
    # units with none of the metric's spans inside, or none whole
    assert reader.read(rec, [_span("engine.trainer.step", None, 1.0),
                             _span("engine.evaluator.sweep", None, 1.0, whole=False)]) is None
    # the program's own log, empty; and a program that keeps no log
    profiling.clear_spans()
    assert reader.read(rec) is None
    monkeypatch.delattr(profiling, "span_log")
    assert reader.read(rec) is None
