"""Device mesh and the placement rule (counterpart of
idgrec_tpu/parallel/mesh.py; ROADMAP A.9).

One process a card, joined in one `torch.distributed` process group
(`parallel.distributed.initialize`). The mesh lays the ranks out as
``("data", "model")``:

* ``model``: the embedding tables, their Adam moments and the int8
  count matrix M are row-sharded over it (`EpochRunner`,
  `parallel.spmm_shard`); each rank scores and ranks its slice of the
  items (`parallel.topk`);
* ``data``: each step's batch is split over it as the JAX package shards
  its batches (``P(None, "data")``): data rank r takes rows
  [r·B/D, (r+1)·B/D) of the batch (`split_batch`, entered by
  `EpochRunner.run_epoch`) and computes only those rows' loss and their
  backward. Its loss is a share: the D shares sum to the whole batch's
  loss. What the rows couple is gathered: in-batch contrasts take the
  rank's rows against the all-gathered batch (`gather_batch`), a log of
  a mean over the batch's pairs all-reduces the pair sum
  (`all_reduce`), batch norm its statistics; a collective's backward
  is its adjoint under that sum, as JAX transposes it (all-gather ↔
  sum of the cotangent and the rank's own block; all-reduce ↔
  all-reduce).

Activations stay replicated within the model group: every rank holds
the whole [N, d] input of an application and gets its whole output
(`parallel.spmm_shard`), so the propagation runs whole on every rank of
a model group. Every tensor that is the same on every data rank enters
the split part of a step through a data sum: the batch's row lookups
(`lookup`, and K4's gathers in ops/scatter.py, both through
`WholeBatch`) all-gather the rows' cotangents and scatter the whole
batch, every other read sums its
cotangent over "data" (`data_sum`). So the propagation's backward runs
once per model group on the summed cotangent, as the JAX package runs
its custom VJP on the cotangent its shard_map sums over "data": the
quantized chains round their cotangent by its amax, so summing their
partial gradients after the backward would not be JAX's result, and
there is no gradient all-reduce after ``backward()``.

The shape rules are the JAX package's: power-of-two axes, by default a
data axis of the largest power of two <= sqrt(n), ``data_parallel``
dividing n, and a model axis that is not a power of two shrinks with a
warning. `mesh_shape` applies them without a process group.
"""

from __future__ import annotations

import logging
import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist

_logger = logging.getLogger("idgrec_torch")

_ACTIVE_MESH: "Mesh | None" = None


def get_active_mesh() -> "Mesh | None":
    return _ACTIVE_MESH


@contextmanager
def use_mesh(mesh: "Mesh | None"):
    """Bind ``mesh`` as the active mesh for the duration (None binds none):
    the adjacency builders shard M over it and the chains decline under
    its model axis."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


def mesh_shape(n: int, data_parallel: int | None = None) -> tuple[int, int]:
    """(data, model) of the mesh `make_mesh` lays over ``n`` devices, with
    the JAX package's warnings and errors; data · model may be below n."""
    if data_parallel is None:
        n2 = 1 << (n.bit_length() - 1)
        if n2 != n:
            _logger.warning("device count %d is not a power of two — using %d devices "
                            "(the sharding layout needs power-of-two axes)", n, n2)
            n = n2
        data_parallel = 1
        while data_parallel * 2 <= math.isqrt(n) and n % (data_parallel * 2) == 0:
            data_parallel *= 2
    elif data_parallel <= 0 or n % data_parallel != 0:
        raise ValueError(f"data_parallel={data_parallel} must be positive and divide "
                         f"the device count ({n})")
    model_parallel = n // data_parallel
    if model_parallel & (model_parallel - 1):
        pow2 = 1 << (model_parallel.bit_length() - 1)
        _logger.warning("model axis %d is not a power of two — tables would replicate "
                        "(parallel/padding.py contract); using %d of the %d devices "
                        "(mesh %dx%d)", model_parallel, data_parallel * pow2, n,
                        data_parallel, pow2)
        model_parallel = pow2
    return data_parallel, model_parallel


@dataclass(eq=False)
class Mesh:
    """A ("data", "model") layout of the ranks, rank = data · model_width +
    model. ``device_mesh`` and the axis groups are None on a mesh of one
    rank without a process group; collectives over a one-rank axis are
    skipped."""

    data: int
    model: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    device_mesh: object = None
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(n_devices: int | None = None, data_parallel: int | None = None,
              device=None) -> Mesh:
    """The ("data", "model") mesh over the process group's ranks
    (`torch.distributed.device_mesh.init_device_mesh`), one card a rank
    (``device`` default: this rank's card, set by `distributed.initialize`;
    "cpu" for a gloo group). ``n_devices`` defaults to the world size; a
    mesh must use every rank of the group (start as many processes as
    `mesh_shape` gives). Without a process group, a one-rank mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    dp, mp = mesh_shape(n, data_parallel)
    if dp * mp != world:
        raise ValueError(f"a {dp}x{mp} mesh needs {dp * mp} ranks; the process group has "
                         f"{world}: start {dp * mp} processes")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() and dist.is_initialized()
                  and dist.get_backend() == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(dp, mp, 0, device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (dp, mp), mesh_dim_names=("data", "model"))
    return Mesh(dp, mp, dist.get_rank(), device, dm, dm.get_group("data"), dm.get_group("model"))


def model_width(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.model


# placements of `placement`
ROWS, EDGES, REPLICATED = "rows", "edges", "replicated"


def placement(x, width: int) -> str:
    """Where a leaf of the training state lives on a model axis of
    ``width`` (the JAX ``param_shardings``): a 2-D leaf of at least
    2·width rows that divide the width is row-sharded, a 1-D edge array of
    2**20 entries or more is chunked, everything else is replicated."""
    shape = tuple(x.shape)
    if len(shape) == 2 and shape[0] >= 2 * width and shape[0] % width == 0:
        return ROWS
    if len(shape) == 1 and shape[0] >= (1 << 20) and shape[0] % width == 0:
        return EDGES
    return REPLICATED


# ---------------------------------------------------------------------------
# collectives on one axis (identity on a one-rank axis)


def all_gather_rows(x: torch.Tensor, group, width: int) -> torch.Tensor:
    """The ranks' [r, ...] blocks concatenated in rank order."""
    if width == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(width)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def all_reduce_sum(x: torch.Tensor, group, width: int) -> torch.Tensor:
    """The sum over the axis, the same bits on every rank."""
    if width == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the mesh (nothing on a one-rank mesh)."""
    if mesh is not None and mesh.size > 1:
        dist.barrier()


class _GatherOwnGrad(torch.autograd.Function):
    """All-gather of the ranks' blocks; the backward keeps the rank's own
    block of the cotangent, which every rank computed whole and alike."""

    @staticmethod
    def forward(ctx, x, group, width, index):
        ctx.rows, ctx.index = x.shape[0], index
        return all_gather_rows(x, group, width)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.rows: (ctx.index + 1) * ctx.rows], None, None, None


def gather_model_rows(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-sharded table gathered whole over the model axis;
    differentiable, the gradient of the rank's own rows."""
    return _GatherOwnGrad.apply(shard, mesh.model_group, mesh.model, mesh.model_index)


# ---------------------------------------------------------------------------
# the data axis: a step's batch split over it


_ACTIVE_SPLIT: "DataSplit | None" = None


@dataclass(eq=False)
class DataSplit:
    """The split of one step's batch of ``batch`` rows over ``mesh``'s data
    axis: this rank takes rows [lo, lo + rows). ``indices`` pairs each of
    the rank's index slices with the whole batch's index tensor."""

    mesh: Mesh
    batch: int
    indices: tuple = ()

    @property
    def parts(self) -> int:
        return self.mesh.data

    @property
    def rows(self) -> int:
        return self.batch // self.mesh.data

    @property
    def lo(self) -> int:
        return self.mesh.data_index * self.rows

    def whole_index(self, idx: torch.Tensor) -> torch.Tensor:
        """The whole batch's indices of which ``idx`` is this rank's slice:
        the batch's own tensor for a slice `split_batch` made, else the
        slices all-gathered."""
        for part, whole in self.indices:
            if idx is part:
                return whole
        return all_gather_rows(idx, self.mesh.data_group, self.parts)


def active_split() -> "DataSplit | None":
    """The data split of the step being run, or None (no mesh, a data
    axis of 1, or outside `EpochRunner.run_epoch`)."""
    return _ACTIVE_SPLIT


@contextmanager
def split_batch(mesh: "Mesh | None", batch: dict[str, torch.Tensor]):
    """Split ``batch`` (int64 [B] index tensors) over the mesh's data axis
    for the duration and yield this rank's rows of it; with no mesh or a
    data axis of 1 the batch itself, and no split. B divides the axis."""
    global _ACTIVE_SPLIT
    if mesh is None or mesh.data == 1:
        yield batch
        return
    b = next(iter(batch.values())).shape[0]
    split = DataSplit(mesh, b)
    own = {k: v[split.lo: split.lo + split.rows] for k, v in batch.items()}
    split.indices = tuple((own[k], batch[k]) for k in batch)
    prev = _ACTIVE_SPLIT
    _ACTIVE_SPLIT = split
    try:
        yield own
    finally:
        _ACTIVE_SPLIT = prev


def batch_rows(n: int) -> int:
    """The whole batch's row count for a rank's block of ``n`` rows: n
    times the data axis under a split, else n."""
    split = _ACTIVE_SPLIT
    return n if split is None else n * split.parts


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor over the whole batch (dim 0 of B
    rows); ``x`` itself without a split."""
    split = _ACTIVE_SPLIT
    return x if split is None else x[split.lo: split.lo + split.rows]


def whole_index(idx: torch.Tensor) -> torch.Tensor:
    """The whole batch's indices of which ``idx`` is this rank's slice
    (`DataSplit.whole_index`); ``idx`` itself without a split."""
    split = _ACTIVE_SPLIT
    return idx if split is None else split.whole_index(idx)


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a term every rank computes whole from tensors
    that entered through `data_sum`, `gather_batch` or `all_reduce`:
    x / D, so that the D shares sum to the term."""
    split = _ACTIVE_SPLIT
    return x if split is None else x / float(split.parts)


class _DataSum(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the data axis."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.split
        return all_reduce_sum(g, sp.mesh.data_group, sp.parts), None


class _AllReduce(torch.autograd.Function):
    """The sum over the data axis; its adjoint is the same sum."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return all_reduce_sum(x, split.mesh.data_group, split.parts)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.split
        return all_reduce_sum(g, sp.mesh.data_group, sp.parts), None


class _GatherBatch(torch.autograd.Function):
    """The ranks' row blocks all-gathered in rank order; the backward sums
    the cotangent over the data axis and keeps the rank's own block."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return all_gather_rows(x, split.mesh.data_group, split.parts)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.split
        g = all_reduce_sum(g, sp.mesh.data_group, sp.parts)
        return g[sp.lo: sp.lo + sp.rows], None


class WholeBatch:
    """What the backward of a gather of batch rows scatters: made in the
    forward from the rank's index slices, it keeps the whole batch's
    indices (`indices`) and all-gathers the rows' cotangents over the data
    axis (`cotangents`), so the scatter runs over the whole batch as in
    one process and every data rank gets the data sum of the table's
    cotangent. Without a split both are the rank's own."""

    def __init__(self, *idxs: torch.Tensor):
        self.split = _ACTIVE_SPLIT
        self.indices = idxs if self.split is None else tuple(
            self.split.whole_index(i) for i in idxs)

    def cotangents(self, *grads: torch.Tensor) -> tuple:
        sp = self.split
        if sp is None:
            return grads
        return tuple(all_gather_rows(g.contiguous(), sp.mesh.data_group, sp.parts)
                     for g in grads)


class _Lookup(torch.autograd.Function):
    """``table[idx]`` for this rank's slice ``idx`` of the batch; the
    backward scatters the whole batch's cotangent (`WholeBatch`), as one
    process's indexing backward does."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.batch, ctx.shape = WholeBatch(idx), table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (whole,), (g_all,) = ctx.batch.indices, ctx.batch.cotangents(g)
        return g.new_zeros(ctx.shape).index_put_((whole,), g_all, accumulate=True), None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """The data-sum boundary: ``x``, a tensor that is the same on every
    data rank, read by the rank's part of the step; the backward sums its
    cotangent over the data axis. Identity without a split."""
    split = _ACTIVE_SPLIT
    return x if split is None else _DataSum.apply(x, split)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data axis (differentiable, the backward
    the same sum). Identity without a split."""
    split = _ACTIVE_SPLIT
    return x if split is None else _AllReduce.apply(x, split)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The whole batch's rows of a tensor of which ``x`` is this rank's
    block (differentiable: the cotangent summed over the data axis, the
    rank's block kept). ``x`` itself without a split."""
    split = _ACTIVE_SPLIT
    return x if split is None else _GatherBatch.apply(x, split)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, ``table`` the same on every data rank and ``idx``
    this rank's slice of the batch: the backward scatters the whole
    batch's cotangent (`_Lookup`). Plain indexing without a split."""
    return table[idx] if _ACTIVE_SPLIT is None else _Lookup.apply(table, idx)
