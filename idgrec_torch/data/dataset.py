"""Interaction dataset loader (the port's own copy of
idgrec_tpu/data/dataset.py, reduced to what serving, training and
evaluation need).

Reads the reference dataset format, one line per user
``uid iid iid ...``, and keeps the CSR user->item structure as numpy
arrays. Semantics held equal to the JAX package bit for bit
(tests/test_torch_data.py):

* ``num_users``/``num_items`` are max-id+1 over both train and test
  files, counted over interacting pairs only;
* duplicate (user, item) pairs are kept in ``num_train`` and summed
  into ``csr_vals``; ``col_idx`` is sorted within each row;
* `make_synthetic_dataset` draws the same pairs from the same seed.

The JAX package's native mmap scanner (data/native.py) is not ported:
the numpy parser gives the same arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


def _parse_interaction_file(path: str) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """(inter_users, inter_items, pos_lengths) of one train/test file,
    the flattened (user, item) pairs in file order."""
    with open(path, "r") as f:
        raw = f.read()
    users: list[np.ndarray] = []
    items: list[np.ndarray] = []
    pos_lengths: list[int] = []
    for line in raw.split("\n"):
        line = line.strip()
        if not line:
            continue
        arr = np.array(line.split(), dtype=np.int64)
        if arr.size < 2:
            continue
        pos = arr[1:]
        users.append(np.full(pos.size, int(arr[0]), dtype=np.int64))
        items.append(pos)
        pos_lengths.append(int(pos.size))
    inter_users = np.concatenate(users) if users else np.zeros(0, dtype=np.int64)
    inter_items = np.concatenate(items) if items else np.zeros(0, dtype=np.int64)
    return inter_users, inter_items, pos_lengths


def _csr_from_pairs(users: np.ndarray, items: np.ndarray,
                    num_users: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row_ptr int32, col_idx int32, multiplicity float32) CSR of the
    pairs; duplicates summed, columns sorted within each row."""
    order = np.lexsort((items, users))
    u = users[order]
    i = items[order]
    if u.size:
        first = np.ones(u.size, dtype=bool)
        first[1:] = (u[1:] != u[:-1]) | (i[1:] != i[:-1])
        uu = u[first]
        ii = i[first]
        vals = np.diff(np.append(np.nonzero(first)[0], u.size)).astype(np.float32)
    else:
        uu, ii = u, i
        vals = np.zeros(0, dtype=np.float32)
    counts = np.bincount(uu, minlength=num_users) if uu.size else np.zeros(num_users, np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    return row_ptr.astype(np.int32), ii.astype(np.int32), vals


def _max_ids(pairs) -> tuple[int, int]:
    nu, ni = 0, 0
    for u_arr, i_arr in pairs:
        if u_arr.size:
            nu = max(nu, int(u_arr.max()))
            ni = max(ni, int(i_arr.max()))
    return nu + 1, ni + 1


@dataclass
class Dataset:
    """Loaded interaction data for one benchmark dataset."""

    path: str
    name: str
    num_users: int
    num_items: int
    num_train: int
    num_test: int
    train_user: np.ndarray  # int64 [num_train], file order, duplicates kept
    train_item: np.ndarray  # int64 [num_train]
    row_ptr: np.ndarray  # int32 [num_users + 1]
    col_idx: np.ndarray  # int32 [nnz], sorted per row
    csr_vals: np.ndarray  # float32 [nnz], multiplicities
    test_user: np.ndarray  # int64 [num_test]
    test_item: np.ndarray  # int64 [num_test]
    pos_length: list[int] = field(default_factory=list)
    _test_dict: dict | None = field(default=None, repr=False, compare=False)

    @property
    def num_nodes(self) -> int:
        return self.num_users + self.num_items

    @property
    def nnz(self) -> int:
        return int(self.col_idx.size)

    @classmethod
    def load(cls, path: str, name: str | None = None) -> "Dataset":
        """Load ``<path>/train.txt`` and ``<path>/test.txt``."""
        train_user, train_item, pos_length = _parse_interaction_file(
            os.path.join(path, "train.txt"))
        test_user, test_item, _ = _parse_interaction_file(
            os.path.join(path, "test.txt"))
        num_users, num_items = _max_ids(
            ((train_user, train_item), (test_user, test_item)))
        row_ptr, col_idx, csr_vals = _csr_from_pairs(train_user, train_item, num_users)
        return cls(
            path=path,
            name=name or os.path.basename(os.path.normpath(path)),
            num_users=num_users,
            num_items=num_items,
            num_train=int(train_user.size),
            num_test=int(test_user.size),
            train_user=train_user,
            train_item=train_item,
            row_ptr=row_ptr,
            col_idx=col_idx,
            csr_vals=csr_vals,
            test_user=test_user,
            test_item=test_item,
            pos_length=pos_length,
        )

    @classmethod
    def from_pairs(
        cls,
        train_user: np.ndarray,
        train_item: np.ndarray,
        test_user: np.ndarray,
        test_item: np.ndarray,
        num_users: int | None = None,
        num_items: int | None = None,
        name: str = "synthetic",
        path: str = "",
    ) -> "Dataset":
        """Build a Dataset from in-memory interaction pairs."""
        train_user = np.asarray(train_user, dtype=np.int64)
        train_item = np.asarray(train_item, dtype=np.int64)
        test_user = np.asarray(test_user, dtype=np.int64)
        test_item = np.asarray(test_item, dtype=np.int64)
        nu, ni = _max_ids(((train_user, train_item), (test_user, test_item)))
        num_users = num_users if num_users is not None else nu
        num_items = num_items if num_items is not None else ni
        row_ptr, col_idx, csr_vals = _csr_from_pairs(train_user, train_item, num_users)
        return cls(
            path=path,
            name=name,
            num_users=num_users,
            num_items=num_items,
            num_train=int(train_user.size),
            num_test=int(test_user.size),
            train_user=train_user,
            train_item=train_item,
            row_ptr=row_ptr,
            col_idx=col_idx,
            csr_vals=csr_vals,
            test_user=test_user,
            test_item=test_item,
        )

    @property
    def sparsity(self) -> float:
        return 1 - (self.num_train + self.num_test) / self.num_users / self.num_items

    def get_statistics(self) -> str:
        """Stats line in the exact format of the reference (the header
        of its committed logs)."""
        strs = "dataset:" + self.name + "\t"
        strs += "num_users:%d, num_items:%d \t" % (self.num_users, self.num_items)
        strs += "|num_train:%d, num_test:%d, sparsity: %.6f" % (
            self.num_train,
            self.num_test,
            self.sparsity,
        )
        return strs

    def positive_items(self, user: int) -> np.ndarray:
        """Sorted unique positive item ids of one user."""
        return self.col_idx[self.row_ptr[user] : self.row_ptr[user + 1]]

    @property
    def test_dict(self) -> dict[int, list[int]]:
        """Test ground truth: user -> items in file order."""
        if self._test_dict is None:
            d: dict[int, list[int]] = {}
            for u, i in zip(self.test_user.tolist(), self.test_item.tolist()):
                d.setdefault(u, []).append(i)
            self._test_dict = d
        return self._test_dict

    def padded_test_truth(self, users: np.ndarray, pad: int = -1) -> np.ndarray:
        """[len(users), max_truth] ground-truth item ids padded with -1."""
        lists = [self.test_dict.get(int(u), []) for u in users]
        width = max((len(l) for l in lists), default=1) or 1
        out = np.full((len(users), width), pad, dtype=np.int32)
        for r, l in enumerate(lists):
            out[r, : len(l)] = l
        return out


def make_synthetic_dataset(
    num_users: int,
    num_items: int,
    num_train: int,
    num_test: int,
    seed: int = 0,
    name: str = "synthetic",
) -> Dataset:
    """A power-law-ish random bipartite dataset with unique pairs (the
    interaction matrix is binary). bench.py's yelp2018 scale is 31,668
    users / 38,048 items / 1,237,259 train / 324,147 test at seed 0."""
    rng = np.random.default_rng(seed)
    # Zipf-like item popularity for realistic degree skew.
    item_p = (1.0 / np.arange(1, num_items + 1)) ** 0.8
    item_p /= item_p.sum()

    def unique_pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
        total = num_users * num_items
        n = min(n, total)
        if total <= 4_000_000 and n > total // 8:
            # near-saturation (tiny graphs): sample pair ids exactly
            flat = rng.choice(total, size=n, replace=False)
            return flat // num_items, flat % num_items
        users = np.empty(0, np.int64)
        items = np.empty(0, np.int64)
        while users.size < n:
            k = int((n - users.size) * 1.2) + 16
            u = rng.integers(0, num_users, k)
            i = rng.choice(num_items, size=k, p=item_p)
            users = np.concatenate([users, u])
            items = np.concatenate([items, i])
            _, idx = np.unique(users * num_items + items, return_index=True)
            idx.sort()
            users, items = users[idx], items[idx]
        return users[:n], items[:n]

    train_user, train_item = unique_pairs(num_train)
    test_user, test_item = unique_pairs(num_test)
    return Dataset.from_pairs(
        train_user, train_item, test_user, test_item,
        num_users=num_users, num_items=num_items, name=name,
    )
