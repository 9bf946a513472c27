"""The FLOP and byte counts of the per-layer metrics against hand counts
at tiny shapes, and the trace arithmetic on a hand-made trace."""

from __future__ import annotations

import pytest

from yardstick import manifest, peaks, tracing
from yardstick.manifest import Keys


def metric(name):
    return manifest.metric_reader(name)


def test_k6_application_bytes_by_hand():
    # 3 users, 5 items, 7 edges, width 4: edge indices 28, row offsets 16,
    # degrees 32, bf16 activations 2·8·4 = 64, float32 sums 4·8·4 = 128
    assert metric("k6_roofline").application_bytes(3, 5, 7, 4) == 28 + 16 + 32 + 64 + 128


def test_k6_least_time_is_the_larger_bound():
    k6 = metric("k6_roofline")
    nu, ni, nnz, w = 52_643, 91_599, 2_380_730, 64
    by_bytes = k6.application_bytes(nu, ni, nnz, w) / peaks.HBM_BYTES_PER_S
    by_flops = 4 * nnz * w / peaks.BF16_FLOPS
    assert by_bytes > by_flops
    assert k6.least_seconds(nu, ni, nnz, w) == by_bytes
    # about 19.6 µs an application at Amazon-Book's scale, d = 64
    assert by_bytes == pytest.approx(19.6e-6, rel=0.01)


def test_step_flops_by_hand():
    keys = Keys({"GCN_layer": 2, "embedding_size": 8})
    # LightGCN: 2 layers × (forward + backward) × 4·nnz·d
    assert metric("train_step_mfu").step_flops(keys, {"chains": 1, "loss_products": []},
                                               10) == 2 * 2 * 4 * 10 * 8
    # SimGCL: three chains side by side, and a [4, 8] · [8, 4] product
    # counted forward and twice backward
    assert metric("train_step_mfu").step_flops(
        keys, {"chains": 3, "loss_products": [[4, 4, 8]]}, 10) == (
        2 * 2 * 4 * 10 * 8 * 3 + 3 * 2 * 4 * 4 * 8)


def test_sweep_flops_by_hand():
    keys = Keys({"GCN_layer": 3, "embedding_size": 8})
    graph = {"nnz": 10, "test_users": 6, "num_items": 5}
    assert metric("eval_mfu").sweep_flops(keys, graph) == 3 * 4 * 10 * 8 + 2 * 6 * 8 * 5


def _trace():
    # window [0, 10) s of 2 steps; device busy [1, 3) ∪ [2, 4) ∪ [6, 7)
    device = [("(anonymous namespace)::prep_kernel(float const*, float const*, int)", 1.0, 3.0),
              ("void (anonymous namespace)::dual_walk_kernel<(anonymous namespace)::FixedSums, 2>"
               "((anonymous namespace)::PlanList)", 2.0, 4.0),
              ("void (anonymous namespace)::dual_walk_kernel<(anonymous namespace)::IntSums, 2>"
               "((anonymous namespace)::PlanList)", 4.0, 4.5),
              ("gatherTopK", 6.0, 7.0), ("late", 12.0, 13.0)]
    host = [("aten::sampler", 0, 4.0, 6.0), ("cudaLaunchKernel", 0, 4.5, 4.6),
            ("aten::outer", 0, 6.5, 9.5), ("aten::inner", 0, 7.5, 9.0)]
    return tracing.Trace(window=(0.0, 10.0), device=device, host=host, steps=2)


def test_trace_arithmetic_by_hand():
    tr = _trace()
    assert tracing.busy_intervals(tr) == [(1.0, 4.5), (6.0, 7.0)]
    assert tracing.busy_s(tr) == 4.5
    assert tracing.launches_in_window(tr) == 4
    # K6 is the fixed-point instance and its prep; K7's walk (IntSums) is not
    assert tracing.device_time(tr, metric("k6_roofline").is_k6) == 4.0
    gaps = tracing.idle_gaps(tr)
    # [0, 1) no host op; [4.5, 6) the sampler at 5.25; [7, 10) the inner op at 8.5
    assert gaps == {"(no host operation)": 1.0, "aten::sampler": 1.5, "aten::inner": 3.0}


def test_metric_readers_on_a_hand_made_record(tiny_cell):
    from yardstick.drivers import Record

    cell = tiny_cell("lightgcn-amazon-book.train")
    rec = Record(cell=cell, graph={"num_users": 3, "num_items": 5, "nnz": 7, "test_users": 2},
                 trace=_trace())
    assert metric("device_idle_pct.train").read(rec) == pytest.approx(55.0)
    assert metric("launches_per_step").read(rec) == 2.0
    assert metric("sampler_ms").read(rec) is None
    rec.span("sample_epoch", 0.002)
    rec.span("sample_epoch", 0.004)
    assert metric("sampler_ms").read(rec) == pytest.approx(3.0)
    least = metric("k6_roofline").least_seconds(3, 5, 7, 64)
    assert metric("k6_roofline").read(rec) == pytest.approx(100 * 2 * 3 * 2 * least / 4.0)
    assert metric("train_step_mfu").read(rec) is None  # no untraced epoch
    rec.untraced = (4, 2.0)
    flops = 2 * 3 * 4 * 7 * 64
    assert metric("train_step_mfu").read(rec) == pytest.approx(
        100 * flops * 4 / 2.0 / peaks.BF16_FLOPS)


def test_a_metric_with_nothing_to_read_is_absent(tiny_cell):
    from yardstick.drivers import Record

    rec = Record(cell=tiny_cell("lightgcn-amazon-book.eval"),
                 graph={"num_users": 3, "num_items": 5, "nnz": 7, "test_users": 2})
    for name in ("k6_roofline", "topk_ms", "device_idle_pct.eval", "eval_embeddings_ms",
                 "eval_mfu", "launches_per_step"):
        assert metric(name).read(rec) is None
    rec.trace = tracing.Trace(window=(0.0, 1.0), device=[("other", 0.1, 0.2)], host=[],
                              steps=1)
    assert metric("k6_roofline").read(rec) is None
    assert metric("topk_ms").read(rec) is None
