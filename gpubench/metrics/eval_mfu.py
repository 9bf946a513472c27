"""engine.evaluator (the sweep): a sweep's FLOPs over the time of a
sweep at the dense bf16 peak, in %. The time is the host clock of the
window's untraced sweeps over their count. FLOPs: the representation's
propagation, 4·nnz·d a layer, and the scores, 2·U_test·d·I."""

from yardstick import peaks


def sweep_flops(keys, graph):
    d = keys.int("embedding_size")
    return (4 * graph["nnz"] * d * keys.int("GCN_layer")
            + 2 * graph["test_users"] * d * graph["num_items"])


def read(rec):
    sweeps, seconds = rec.untraced
    if not sweeps or seconds <= 0:
        return None
    return 100.0 * sweep_flops(rec.cell.keys, rec.graph) * sweeps / seconds / peaks.BF16_FLOPS
