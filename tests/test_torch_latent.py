"""The port's learnable synthetic dataset against the JAX package's.

`make_latent_synthetic_dataset` is numpy alone in both packages, so the
same seed must give the same pairs exactly: the chunking of the logits,
the float32 uniforms, the per-row permutation and the order of the
draws all shift the random stream, and any change among them shows here
as a different pair."""

from __future__ import annotations

import numpy as np
import pytest

from idgrec_torch.data import dataset as t_dataset
from idgrec_tpu.data import dataset as j_dataset

_ARRAYS = ("train_user", "train_item", "test_user", "test_item", "row_ptr", "col_idx",
           "csr_vals")
_SIZES = [
    (50, 80, 800, 200),
    (300, 500, 6_000, 1_500),
    # 1,200 pairs over 30 items for 40 users: most users' k_total hits num_items
    (40, 30, 900, 300),
]
_DRAWS = [
    dict(rank=16, temperature=0.25, seed=0),
    dict(rank=4, temperature=0.5, seed=3),
    dict(rank=8, temperature=1.0, seed=11),
]


@pytest.mark.parametrize("draw", _DRAWS, ids=lambda d: f"r{d['rank']}-t{d['temperature']}-s{d['seed']}")
@pytest.mark.parametrize("shape", _SIZES, ids=lambda s: "x".join(map(str, s)))
def test_latent_pairs_equal_jax(shape, draw):
    got = t_dataset.make_latent_synthetic_dataset(*shape, **draw)
    want = j_dataset.make_latent_synthetic_dataset(*shape, **draw)
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("num_users", "num_items", "num_train", "num_test", "name"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.name == "latent-synthetic"


def test_latent_pairs_are_unique_and_split_per_user():
    shape = (40, 30, 900, 300)
    data = t_dataset.make_latent_synthetic_dataset(*shape, seed=2)
    train = set(zip(data.train_user.tolist(), data.train_item.tolist()))
    test = set(zip(data.test_user.tolist(), data.test_item.tolist()))
    # every pair once, train and test disjoint, the counts binary
    assert len(train) == data.num_train and len(test) == data.num_test
    assert not train & test and (data.csr_vals == 1).all()
    # a user holds at most every item once across train and test
    per_user = np.bincount(np.concatenate([data.train_user, data.test_user]),
                           minlength=shape[0])
    assert per_user.max() == shape[1]
    assert data.num_train <= shape[2] and data.num_test <= shape[3]
