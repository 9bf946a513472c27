"""ops.fusedmm K6 (csrc/dual_bf16.cu): the least time of the
propagation's applications in the traced steps over K6's device time
there, in %. An application is one product of the normalised adjacency
with the chains' activations in both directions, 2·GCN_layer a step
(forward and backward) at width w = d · ``work.chains``. Its least time
is the larger of 4·nnz·w FLOPs at the dense bf16 peak and its bytes at
the HBM peak: each edge once as an int32 column index, int32 row
offsets, one float32 degree a node, both sides' activations read once
in bf16 and both sides' sums written once in float32. Counted from the
graph, never from the program's plan or padding. K6 is found by the
names of its kernels; with none in the trace the metric is absent."""

import re

from yardstick import peaks, tracing

# K6's launches as the trace names them: its walk (or, without a plan, its
# scan) instantiated on the 64-bit fixed-point sums, and its prep and
# convert kernels; names carry namespace qualifiers
NAMES = re.compile(r"dual_(walk|scan)_kernel<.*FixedSums|prep_kernel\(float const\*|"
                   r"convert_kernel\(long long const\*")


def is_k6(name: str) -> bool:
    return NAMES.search(name) is not None


def application_bytes(num_users, num_items, nnz, width):
    nodes = num_users + num_items
    return 4 * nnz + 4 * (num_users + 1) + 4 * nodes + 2 * nodes * width + 4 * nodes * width


def least_seconds(num_users, num_items, nnz, width):
    return max(4 * nnz * width / peaks.BF16_FLOPS,
               application_bytes(num_users, num_items, nnz, width) / peaks.HBM_BYTES_PER_S)


def read(rec):
    if rec.trace is None:
        return None
    k6 = tracing.device_time(rec.trace, is_k6)
    if k6 <= 0:
        return None
    keys, g = rec.cell.keys, rec.graph
    width = keys.int("embedding_size") * rec.cell.config["work"]["chains"]
    apps = 2 * keys.int("GCN_layer") * rec.trace.steps
    least = apps * least_seconds(g["num_users"], g["num_items"], g["nnz"], width)
    return 100.0 * least / k6
