"""ops.fusedmm K6: the least time of K6's applications in the traced
steps over their device time in the program's span ``ops.fusedmm.k6``,
in %. Each span is one application (forward or backward, 2·GCN_layer a
step), whatever kernels implement it; its least time is
``k6_roofline``'s, counted from the graph and the configuration's width.
The span's time holds every launch of the application and the gaps
between them in stream order, so this reads at most what the kernels'
own time gives."""

from yardstick import manifest, spans

K6 = "ops.fusedmm.k6"


def read(rec, log=None):
    ms = spans.whole_ms(log, K6)
    if not ms:
        return None
    keys, g = rec.cell.keys, rec.graph
    width = keys.int("embedding_size") * rec.cell.config["work"]["chains"]
    least = manifest.metric_reader("k6_roofline").least_seconds(
        g["num_users"], g["num_items"], g["nnz"], width)
    return 100.0 * least * len(ms) / (1e-3 * sum(ms))
