"""Batch inference / serving API (counterpart of idgrec_tpu/serving.py).

A `Recommender` wraps a model and answers top-K requests:

* the model representation (`eval_embeddings`) is computed once at
  construction and kept on the model's device, drawing whatever it
  draws from ``generator`` (default: seeded 0 on the model's device);
  a request pays a [B, d] gather, a [B, num_items] float32 product and
  a top-k;
* seen-item filtering uses padded per-user exclusion lists kept on the
  host (train positives are never recommended);
* ranking is exact (`torch.topk`), in ``topk_mode`` 'approx' too (the
  JAX package's `approx_max_k` is a TPU op); its order among tied scores
  may differ from `jax.lax.top_k`'s.

Example:

    rec = Recommender.from_train_result("LightGCN", data, cfg, result)
    items, scores = rec.recommend([1, 17, 42], k=10)

`Recommender.from_checkpoint` serves from a directory of training
checkpoints, the deploy path: train in one process, recommend from the
saved weights in another.

On a mesh (``mesh=``; every rank of it serving the same requests, the
model built under the mesh) the representation's products run sharded
over the model axis and, where the items are sharded, each model rank
scores and ranks only its column slice of the catalog
(`parallel.topk.sharded_topk`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from idgrec_torch import convert
from idgrec_torch.config import Config
from idgrec_torch.data.dataset import Dataset
from idgrec_torch.engine import checkpoint as ckpt
from idgrec_torch.engine.evaluator import TOPK_MODES
from idgrec_torch.models import get_model
from idgrec_torch.parallel.mesh import use_mesh
from idgrec_torch.parallel.topk import item_slice, items_sharded, local_columns, sharded_topk

_MASK_VALUE = -1e9


class Recommender:
    """Device-resident top-K recommendation server for one model."""

    def __init__(self, model, data: Dataset, filter_seen: bool = True,
                 topk_mode: str = "exact", generator: torch.Generator | None = None,
                 mesh=None):
        if topk_mode not in TOPK_MODES:
            raise ValueError(f"topk_mode={topk_mode!r}: expected one of {TOPK_MODES}")
        self.model = model
        self.data = data
        self.filter_seen = filter_seen
        self.mesh = mesh
        self.device = model.device
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        if generator is None:
            # the JAX server's default key, PRNGKey(0)
            generator = torch.Generator(device=self.device).manual_seed(0)
        with use_mesh(mesh):
            self._repr = model.eval_embeddings(generator)
        # Padded per-user positives (int32 [U, P], pad column num_items,
        # which the mask drops). Kept on the host: a request moves only
        # its [B, P] rows to the device.
        deg = np.diff(data.row_ptr)
        p = max(int(deg.max()) if deg.size else 1, 1)
        excl = np.full((data.num_users, p), data.num_items, np.int64)
        if data.nnz:
            rows = np.repeat(np.arange(data.num_users), deg)
            slots = np.arange(data.nnz) - np.repeat(data.row_ptr[:-1], deg)
            excl[rows, slots] = data.col_idx
        self._excl = excl

    @classmethod
    def from_train_result(cls, model_name: str, data: Dataset, config: Config, result,
                          device=None, **kw) -> "Recommender":
        """Serve the tables of a `train_model` result from a new model
        on ``device`` (default the card)."""
        with use_mesh(kw.get("mesh")):
            model = get_model(model_name)(config, data, device=device)
        model.load_state_dict({k: v.detach().to(model.device) for k, v in result.params.items()})
        return cls(model, data, **kw)

    @classmethod
    def from_checkpoint(cls, model_name: str, data: Dataset, config: Config,
                        checkpoint_dir: str, epoch: int | None = None, device=None,
                        **kw) -> "Recommender":
        """Serve from a training checkpoint written by
        ``train_model(checkpoint_dir=...)`` of this package or of the
        JAX package: both keep Adam's state and the model's tables in
        the same first leaves (`convert.split_adam_and_params`). A
        model's state (RecDCL's histories) is not read: evaluation does
        not use it, as in the JAX package. Loads the latest checkpoint
        unless ``epoch`` picks one."""
        epoch = ckpt.resolve_epoch(checkpoint_dir, epoch)
        with use_mesh(kw.get("mesh")):
            model = get_model(model_name)(config, data, device=device)
        leaves, _meta = ckpt.read_checkpoint(checkpoint_dir, epoch)
        convert.load_jax_params(
            model, convert.split_adam_and_params(leaves, convert.table_names(model))[3])
        return cls(model, data, **kw)

    def _score_impl(self, repr_, users: torch.Tensor, excl_rows: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [B, k], items [B, k]) of one request."""
        if items_sharded(self.mesh):
            # the rank's slice of the catalog; ids outside it go to the spare
            items, width = item_slice(self.data.num_items, self.mesh)
            ratings = self.model.score_batch(repr_, users, items).to(torch.float32)
            if self.filter_seen:
                ratings = F.pad(ratings, (0, 1))
                ratings.scatter_(1, local_columns(excl_rows, items), _MASK_VALUE)
                ratings = ratings[:, :-1]
            return sharded_topk(ratings, items, width, self.mesh, k)
        ratings = self.model.score_batch(repr_, users).to(torch.float32)
        if self.filter_seen:
            # one spare column takes the pad index num_items, then goes
            ratings = F.pad(ratings, (0, 1))
            ratings.scatter_(1, excl_rows, _MASK_VALUE)
            ratings = ratings[:, : self.data.num_items]
        return torch.topk(ratings, k, dim=1)

    @torch.no_grad()
    def recommend(self, users, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """Top-k unseen items for each user id. Returns (items [B, k]
        int64, scores [B, k] float32) as numpy arrays."""
        users = np.asarray(users, np.int64)
        if users.ndim != 1:
            raise ValueError("users must be a 1-D list of user ids")
        if np.any((users < 0) | (users >= self.data.num_users)):
            raise ValueError("user id out of range")
        if not 0 < k <= self.data.num_items:
            raise ValueError(
                f"k must be in [1, num_items={self.data.num_items}], got {k}")
        users_t = torch.from_numpy(users).to(self.device)
        excl = torch.from_numpy(self._excl[users]).to(self.device)
        scores, items = self._score_impl(self._repr, users_t, excl, int(k))
        return items.cpu().numpy().astype(np.int64), scores.cpu().numpy()
