"""engine.trainer (the whole step): a step's model FLOPs over the time
of a step at the dense bf16 peak, in %. The time of a step is the host
clock of the window's untraced steps over their count: the epochs the
trace did not touch (sampling included) and the rest of the epoch it
ended in. FLOPs, from the configuration's shapes and the graph's nnz:
each propagation layer 4·nnz·w forward (both directions) and as much
backward, w the width of the chains the model propagates together
(d times ``work.chains``); each loss product [m, k]·[k, n] 2·m·n·k
forward and twice that backward (``work.loss_products``: [m, n, k] or
[m, n, k, how many]). Elementwise work and Adam count
nothing."""

from yardstick import peaks


def step_flops(keys, work, nnz):
    layers, d = keys.int("GCN_layer"), keys.int("embedding_size")
    propagation = 2 * layers * 4 * nnz * d * work["chains"]
    products = sum(3 * 2 * m * n * k * (rest[0] if rest else 1)
                   for m, n, k, *rest in work["loss_products"])
    return propagation + products


def read(rec):
    steps, seconds = rec.untraced
    if not steps or seconds <= 0:
        return None
    flops = step_flops(rec.cell.keys, rec.cell.config["work"], rec.graph["nnz"])
    return 100.0 * flops * steps / seconds / peaks.BF16_FLOPS
