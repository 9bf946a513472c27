"""Device mesh and the placement rule (counterpart of
idgrec_tpu/parallel/mesh.py; ROADMAP A.9).

One process a card, joined in one `torch.distributed` process group
(`parallel.distributed.initialize`). The mesh lays the ranks out as
``("data", "model")``:

* ``model``: the embedding tables, their Adam moments and the int8
  count matrix M are row-sharded over it (`EpochRunner`,
  `parallel.spmm_shard`); each rank scores and ranks its slice of the
  items (`parallel.topk`);
* ``data``: each rank of a model group looks up the rows of its slice of
  every batch (`models.base.batch_final_embeddings`), the slices are
  all-gathered and the tables' row cotangents summed over the data
  group. That is all it splits: every rank then computes the whole
  batch's loss and every product but M's, so a (2, n/2) mesh does the
  work of a (1, n) mesh twice and holds twice the rows of M a rank. The
  default shape is the JAX package's rule (2x2 on 4 cards), kept for
  parity, not for speed; no run on several cards has compared the two
  layouts (ROADMAP A.12).

Activations stay replicated within the model group: every rank holds
the whole [N, d] input of an application and gets its whole output
(`parallel.spmm_shard`), so the model code runs unchanged on every rank
and computes the same loss.

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
    the adjacency builders shard M over it, the chains decline under its
    model axis and the batch lookups split over its data axis."""
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


class _SumGrad(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the axis."""

    @staticmethod
    def forward(ctx, x, group, width):
        ctx.group, ctx.width = group, width
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group, ctx.width), None, None


def gather_model_rows(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-sharded table gathered whole over the model axis;
    differentiable, the gradient of the rank's own rows."""
    return _GatherOwnGrad.apply(shard, mesh.model_group, mesh.model, mesh.model_index)


def split_rows_fn(fn, tables, idxs, mesh: Mesh | None):
    """``fn(*tables, *idxs)``, a lookup returning one row block an index,
    with the rows split over the data axis: the rank looks up the rows of
    its slice of the indices and the slices are all-gathered, so every
    rank holds the whole batch's rows; the backward keeps the rank's rows
    of the cotangent and sums the tables' cotangents over the data group.
    The index length divides the data axis."""
    if mesh is None or mesh.data == 1:
        return fn(*tables, *idxs)
    b = idxs[0].shape[0] // mesh.data
    lo = mesh.data_index * b
    ts = [_SumGrad.apply(t, mesh.data_group, mesh.data) for t in tables]
    outs = fn(*ts, *(i[lo: lo + b] for i in idxs))
    return tuple(_GatherOwnGrad.apply(o, mesh.data_group, mesh.data, mesh.data_index)
                 for o in outs)
