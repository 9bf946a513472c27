"""Full-catalog top-K evaluation on the model's device (counterpart of
idgrec_tpu/engine/evaluator.py).

Batch the test users, score the whole catalog, mask train positives,
take the exact top-K, and sum Recall/Precision/NDCG, normalized by the
number of test users:

* the model representation is computed once per sweep;
* train positives are masked with a large negative value below any
  possible score;
* metric sums accumulate on the device; only the final per-k vectors
  return to the host.

Early stopping (`BestResults`): best Recall@topK[0], patience
``early_stopping`` evaluations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from idgrec_torch.config import Config
from idgrec_torch.data.dataset import Dataset
from idgrec_torch.device import resolve_device
from idgrec_torch.models.base import RecModel
from idgrec_torch.ops.metrics import topk_metric_sums

_MASK_VALUE = -1e9


@dataclass
class EvalPlan:
    """Precomputed user batches for one test split, on the device."""

    users: torch.Tensor  # [nb, B] int64
    valid: torch.Tensor  # [nb, B] bool
    truth: torch.Tensor  # [nb, B, T] int64, -1 padded
    excl_rows: torch.Tensor  # [nb, P] int64 local batch row
    excl_cols: torch.Tensor  # [nb, P] int64 item col (num_items = spare column)
    num_test_users: int


def build_eval_plan(data: Dataset, batch_size: int, users: list[int] | None = None,
                    device=None) -> EvalPlan:
    """The user batches of one test split (all test users, or ``users``),
    built with numpy and placed on ``device`` (default the card)."""
    test_users = np.asarray(
        sorted(data.test_dict.keys()) if users is None else users, dtype=np.int64)
    n = test_users.size
    if n == 0:
        # fail at construction: a 0-user plan would divide metric sums
        # by zero and early stopping would run on NaNs
        raise ValueError("evaluation requires at least one test user "
                         "(empty test split or empty users list)")
    nb = max(1, -(-n // batch_size))
    padded = nb * batch_size

    users_pad = np.zeros(padded, dtype=np.int64)
    users_pad[:n] = test_users
    valid = np.zeros(padded, dtype=bool)
    valid[:n] = True

    truth_flat = data.padded_test_truth(users_pad)
    truth_flat[~valid] = -1  # padding rows have no ground truth
    t_width = truth_flat.shape[1]

    # per-batch flat exclusion lists (train positives of batch users),
    # one CSR scatter over the batch users' interactions
    degrees = np.diff(data.row_ptr)
    batch_users = users_pad.reshape(nb, batch_size)
    batch_valid = valid.reshape(nb, batch_size)
    deg_pad = degrees[users_pad] * valid  # padded rows contribute 0
    deg_b = deg_pad.reshape(nb, batch_size)
    p_width = max(1, int(deg_b.sum(axis=1).max()))

    excl_rows = np.zeros((nb, p_width), dtype=np.int64)
    excl_cols = np.full((nb, p_width), data.num_items, dtype=np.int64)
    total = int(deg_pad.sum())
    if total:
        # within-batch start slot of each user's run = exclusive cumsum
        start = (np.cumsum(deg_b, axis=1) - deg_b).reshape(-1)
        within = np.arange(total) - np.repeat(np.cumsum(deg_pad) - deg_pad, deg_pad)
        dst_b = np.repeat(np.arange(padded) // batch_size, deg_pad)
        dst_slot = np.repeat(start, deg_pad) + within
        src = np.repeat(data.row_ptr[users_pad], deg_pad) + within
        excl_rows[dst_b, dst_slot] = np.repeat(np.arange(padded) % batch_size, deg_pad)
        excl_cols[dst_b, dst_slot] = data.col_idx[src]

    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return EvalPlan(
        users=put(batch_users, torch.int64),
        valid=put(batch_valid, torch.bool),
        truth=put(truth_flat.reshape(nb, batch_size, t_width), torch.int64),
        excl_rows=put(excl_rows, torch.int64),
        excl_cols=put(excl_cols, torch.int64),
        num_test_users=int(n),
    )


class Evaluator:
    """Full-catalog evaluator for one model/dataset pair, on the
    model's device."""

    def __init__(self, model: RecModel, data: Dataset, config: Config,
                 users: list[int] | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("sharded evaluation over a mesh is ROADMAP A.9")
        self.model = model
        self.data = data
        self.top_ks = tuple(config.int_list("top_K"))
        self.max_k = max(self.top_ks)
        self.topk_mode = config.str("eval_topk", "exact")
        if self.topk_mode != "exact":
            raise NotImplementedError(
                f"eval_topk = {self.topk_mode}: approximate top-k is the TPU's "
                "approx_max_k; the port ranks exactly")
        if model.device.type == "cuda":
            # full float32 scoring, as the JAX Precision.HIGHEST
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.plan = build_eval_plan(data, config.int("test_batch_size"), users=users,
                                    device=model.device)

    @torch.no_grad()
    def compute_repr(self):
        """The model representation used for scoring, computed once per
        sweep; shareable across Evaluators of the same model."""
        self.model.eval()
        return self.model.eval_embeddings()

    def _sweep(self, eval_repr) -> dict[str, torch.Tensor]:
        p = self.plan
        num_items = self.data.num_items
        sums = None
        for b in range(p.users.shape[0]):
            ratings = self.model.score_batch(eval_repr, p.users[b]).to(torch.float32)
            # mask train positives below any reachable score; one spare
            # column takes the pad index num_items, then goes
            ratings = F.pad(ratings, (0, 1))
            ratings[p.excl_rows[b], p.excl_cols[b]] = _MASK_VALUE
            ratings = ratings[:, :num_items]
            topk_idx = torch.topk(ratings, self.max_k, dim=1).indices
            m = topk_metric_sums(topk_idx, p.truth[b], self.top_ks, valid=p.valid[b])
            sums = m if sums is None else {k: sums[k] + v for k, v in m.items()}
        return sums

    @torch.no_grad()
    def evaluate(self, eval_repr=None) -> dict[str, np.ndarray]:
        """Full-catalog metrics. Pass ``eval_repr`` (from
        `compute_repr`) to reuse one representation across several
        evaluators instead of propagating again."""
        if eval_repr is None:
            eval_repr = self.compute_repr()
        sums = self._sweep(eval_repr)
        n = float(self.plan.num_test_users)
        return {k: sums[k].cpu().numpy() / n for k in ("recall", "precision", "ndcg")}


@dataclass
class BestResults:
    """Early-stopping bookkeeping."""

    patience: int
    count: int = 0
    epoch: int = 0
    recall: np.ndarray | None = None
    ndcg: np.ndarray | None = None
    stop: bool = False

    def update(self, result: dict[str, np.ndarray], epoch: int) -> None:
        if self.recall is None or result["recall"][0] > self.recall[0]:
            self.count = 0
            self.epoch = epoch + 1
            self.recall = result["recall"].copy()
            self.ndcg = result["ndcg"].copy()
        else:
            self.count += 1
            if self.count >= self.patience:
                self.stop = True
