"""BPR triple sampling on the model's device (counterpart of
idgrec_tpu/engine/sampler.py).

One uniform negative per training interaction per epoch, the whole
epoch at once:

* candidate negatives drawn uniformly from an explicit
  `torch.Generator` on the sampler's device;
* positive-set membership tested against a bit-packed positives matrix
  (one byte gather and a bit test per candidate) when that bitmap fits
  ``BITMAP_BUDGET_BYTES``, else by a vectorized binary search into the
  row-sorted CSR column array;
* a fixed number of resample rounds replaces the unbounded rejection
  loop: enough that the expected number of residual collisions per
  epoch stays below 1e-6 for the densest user.

The random streams are PyTorch's, not JAX's: the two packages draw
different triples from the same seed, and the sampler is held to its
invariants (no train positive drawn, a permutation of the train list,
uniform negatives), not to bits. Index math is int64 throughout.

Also provides `sample_random_users`, the reference's alternative
"random user" sampler.
"""

from __future__ import annotations

import numpy as np
import torch

from idgrec_torch.device import resolve_device


def _membership(row_ptr: torch.Tensor, col_idx: torch.Tensor, users: torch.Tensor,
                cand: torch.Tensor, n_iters: int) -> torch.Tensor:
    """For each (user, candidate): is candidate in the user's sorted
    positive list? Vectorized binary search, fixed n_iters >=
    ceil(log2(max_degree)) iterations."""
    if col_idx.shape[0] == 0:
        return torch.zeros_like(users, dtype=torch.bool)
    lo = row_ptr[users]
    end = row_ptr[users + 1]
    hi = end
    last = col_idx.shape[0] - 1
    for _ in range(n_iters):
        mid = lo + (hi - lo) // 2
        mid_val = col_idx[torch.clamp(mid, 0, last)]
        go_right = (mid_val < cand) & (lo < hi)
        new_lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
        lo = new_lo
    in_range = lo < end
    found = col_idx[torch.clamp(lo, 0, last)] == cand
    return in_range & found


# positives-bitmap device-memory budget: [U, ceil(I/8)] uint8 (yelp2018
# scale is 31,668 x 4,756 B = 151 MB); larger graphs take the binary search
BITMAP_BUDGET_BYTES = 2 * 1024 * 1024 * 1024


def build_positives_bitmap(data) -> np.ndarray:
    """Bit-packed positives: uint8 [num_users, ceil(num_items/8)], bit
    (row u, col i>>3, 1<<(i&7)) set iff (u, i) is a train positive."""
    width = -(-data.num_items // 8)
    bitmap = np.zeros((data.num_users, width), np.uint8)
    users = np.repeat(np.arange(data.num_users, dtype=np.int64), np.diff(data.row_ptr))
    cols = np.asarray(data.col_idx, np.int64)
    np.bitwise_or.at(bitmap, (users, cols >> 3), (np.uint8(1) << (cols & 7)).astype(np.uint8))
    return bitmap


class NegativeSampler:
    """Per-epoch negative sampling over the full interaction list.
    ``device`` defaults to the card."""

    def __init__(self, data, rounds: int | None = None, *, device=None):
        self.device = resolve_device(device)
        self.num_items = data.num_items
        max_deg = int(np.max(np.diff(data.row_ptr))) if data.nnz else 1
        if rounds is None:
            # enough resample rounds that the expected number of residual
            # collisions per epoch is < 1e-6 even for the densest user
            # (p = max_deg / num_items per draw)
            p = min(max_deg / max(data.num_items, 1), 0.99)
            n = max(data.num_train, 1)
            rounds = int(np.ceil((np.log(1e-6) - np.log(n)) / np.log(p))) if p > 0 else 1
            rounds = int(np.clip(rounds, 4, 64))
        self.rounds = rounds
        self.search_iters = max(1, int(np.ceil(np.log2(max(max_deg, 2)))) + 1)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

        self.train_user = put(data.train_user)
        self.train_item = put(data.train_item)
        self.row_ptr = put(data.row_ptr)
        self.col_idx = put(data.col_idx)
        self.num_train = int(data.train_user.shape[0])
        width = -(-data.num_items // 8)
        if data.num_users * width <= BITMAP_BUDGET_BYTES:
            self.bitmap_flat = torch.from_numpy(build_positives_bitmap(data).reshape(-1)).to(dev)
            self.bitmap_width = width
        else:
            self.bitmap_flat = None
            self.bitmap_width = 0

    def _bitmap_member(self, users: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """(user, cand) positive-membership via the packed bitmap."""
        byte = self.bitmap_flat[users * self.bitmap_width + (cand >> 3)]
        return ((byte.to(torch.int64) >> (cand & 7)) & 1) != 0

    def member(self, users: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """Whether each (user, cand) is a train positive, by the
        sampler's membership path."""
        if self.bitmap_flat is not None:
            return self._bitmap_member(users, cand)
        return _membership(self.row_ptr, self.col_idx, users, cand, self.search_iters)

    @torch.no_grad()
    def sample_epoch(self, generator: torch.Generator):
        """Shuffled (users, pos, neg) int64 tensors [num_train] on the
        sampler's device; ``generator`` must live there too."""
        users, pos = self.train_user, self.train_item
        n = users.shape[0]

        def draw():
            return torch.randint(0, self.num_items, (n,), generator=generator,
                                 device=self.device, dtype=torch.int64)

        neg = draw()
        for _ in range(self.rounds):
            neg = torch.where(self.member(users, neg), draw(), neg)
        # shuffle the epoch
        perm = torch.randperm(n, generator=generator, device=self.device)
        return users[perm], pos[perm], neg[perm]


@torch.no_grad()
def sample_random_users(generator: torch.Generator, num_users: int, num_items: int,
                        row_ptr: torch.Tensor, col_idx: torch.Tensor, n_samples: int,
                        search_iters: int = 24, rounds: int = 4):
    """The reference's alternative sampler: uniform random users, one of
    their positives, one rejected negative. Users with no positives keep
    a sentinel pos and should be filtered by the caller via the returned
    validity mask. Returns (users, pos, neg, valid)."""
    dev = row_ptr.device

    def randint(high):
        return torch.randint(0, high, (n_samples,), generator=generator, device=dev,
                             dtype=torch.int64)

    users = randint(num_users)
    deg = row_ptr[users + 1] - row_ptr[users]
    valid = deg > 0
    # uniform offset in [0, deg): a uniform variate scaled by the degree
    frac = torch.rand(n_samples, generator=generator, device=dev, dtype=torch.float64)
    offset = torch.clamp((frac * deg).to(torch.int64), max=torch.clamp(deg - 1, min=0))
    pos = col_idx[torch.clamp(row_ptr[users] + offset, 0, max(col_idx.shape[0] - 1, 0))]
    neg = randint(num_items)
    for _ in range(rounds):
        colliding = _membership(row_ptr, col_idx, users, neg, search_iters)
        neg = torch.where(colliding, randint(num_items), neg)
    return users, pos, neg, valid
