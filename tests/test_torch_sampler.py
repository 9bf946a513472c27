"""The port's negative sampler. Its random stream is PyTorch's, not
JAX's, so it is held to the sampler's invariants on both membership
paths (and its membership tests to the JAX package's, which are
deterministic):

* no sampled negative is a train positive of its user;
* every triple's (user, pos) is a train pair and the epoch is a
  permutation of the train list;
* negatives are roughly uniform over the catalog: a chi-square
  statistic over item bins below a bar that a uniform draw misses with
  probability under 1e-6."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.engine import sampler as t_sampler
from idgrec_tpu.data.dataset import make_synthetic_dataset as j_make
from idgrec_tpu.engine import sampler as j_sampler

_SHAPE = (200, 300, 6000, 500)  # dense: 10 % of the cells are positives


@pytest.fixture(scope="module")
def data():
    return t_make(*_SHAPE, seed=3)


def _sampler(data, use_bitmap, monkeypatch):
    """A CPU sampler on the chosen membership path: a zero budget sends
    it to the binary search."""
    if not use_bitmap:
        monkeypatch.setattr(t_sampler, "BITMAP_BUDGET_BYTES", 0)
    s = t_sampler.NegativeSampler(data, device="cpu")
    assert (s.bitmap_flat is not None) == use_bitmap
    return s


def _positives(data):
    return set(zip(data.train_user.tolist(), data.train_item.tolist()))


@pytest.mark.parametrize("use_bitmap", [True, False], ids=["bitmap", "search"])
def test_sample_epoch_invariants(data, use_bitmap, monkeypatch):
    s = _sampler(data, use_bitmap, monkeypatch)
    gen = torch.Generator().manual_seed(0)
    users, pos, neg = (t.numpy() for t in s.sample_epoch(gen))
    assert users.dtype == pos.dtype == neg.dtype == np.int64
    assert users.shape == pos.shape == neg.shape == (data.num_train,)
    positives = _positives(data)
    assert not any((u, n) in positives for u, n in zip(users.tolist(), neg.tolist()))
    assert neg.min() >= 0 and neg.max() < data.num_items
    # a permutation of the train list (pairs are unique in this dataset)
    assert sorted(zip(users.tolist(), pos.tolist())) == sorted(positives)
    assert not np.array_equal(users, data.train_user)  # shuffled
    # another epoch from the same generator differs; the same seed repeats
    again = s.sample_epoch(gen)
    assert not np.array_equal(again[2].numpy(), neg)
    same = s.sample_epoch(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(same[2].numpy(), neg)


@pytest.mark.parametrize("use_bitmap", [True, False], ids=["bitmap", "search"])
def test_negatives_roughly_uniform(data, use_bitmap, monkeypatch):
    s = _sampler(data, use_bitmap, monkeypatch)
    gen = torch.Generator().manual_seed(1)
    neg = torch.cat([s.sample_epoch(gen)[2] for _ in range(5)]).numpy()
    bins = 30
    counts = np.bincount(neg * bins // data.num_items, minlength=bins).astype(np.float64)
    # expected share of each bin: its non-positive cells (rejection
    # sampling is uniform over each user's non-positives)
    dense = np.zeros((data.num_users, data.num_items))
    dense[data.train_user, data.train_item] = 1
    deg = dense.sum(axis=1)
    weight = ((1 - dense) * (deg / (data.num_items - deg))[:, None]).sum(axis=0)
    expect = np.bincount(np.arange(data.num_items) * bins // data.num_items, weights=weight,
                         minlength=bins)
    expect *= neg.size / expect.sum()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 90.0  # 29 degrees of freedom: P(chi2 > 90) < 1e-7


@pytest.mark.parametrize("use_bitmap", [True, False], ids=["bitmap", "search"])
def test_membership_paths_match_jax(data, use_bitmap, monkeypatch):
    jdata = j_make(*_SHAPE, seed=3)
    rng = np.random.default_rng(5)
    users = rng.integers(0, data.num_users, 4000)
    cand = rng.integers(0, data.num_items, 4000)
    js = j_sampler.NegativeSampler(jdata)
    ref_search = np.asarray(j_sampler._membership(
        js.row_ptr, js.col_idx, jnp.asarray(users, jnp.int32), jnp.asarray(cand, jnp.int32),
        js.search_iters))
    ref_bitmap = np.asarray(js._bitmap_member(
        js.bitmap_flat, jnp.asarray(users, jnp.int32), jnp.asarray(cand, jnp.int32)))
    truth = np.array([(u, c) in _positives(data) for u, c in zip(users.tolist(), cand.tolist())])
    ut, ct = torch.from_numpy(users), torch.from_numpy(cand)
    s = _sampler(data, use_bitmap, monkeypatch)
    got = s.member(ut, ct).numpy()
    np.testing.assert_array_equal(got, ref_bitmap if use_bitmap else ref_search)
    np.testing.assert_array_equal(got, truth)
    assert (s.rounds, s.search_iters) == (js.rounds, js.search_iters)
    assert 0 < truth.sum() < truth.size


def test_bitmap_bit_equal_to_jax(data):
    jdata = j_make(*_SHAPE, seed=3)
    np.testing.assert_array_equal(t_sampler.build_positives_bitmap(data),
                                  j_sampler.build_positives_bitmap(jdata))


def test_sample_random_users(data):
    gen = torch.Generator().manual_seed(2)
    row_ptr = torch.from_numpy(data.row_ptr.astype(np.int64))
    col_idx = torch.from_numpy(data.col_idx.astype(np.int64))
    users, pos, neg, valid = t_sampler.sample_random_users(
        gen, data.num_users, data.num_items, row_ptr, col_idx, 3000, search_iters=12, rounds=12)
    positives = _positives(data)
    u, p, n, v = users.numpy(), pos.numpy(), neg.numpy(), valid.numpy()
    assert v.all()  # every user of this dataset has positives
    assert all((a, b) in positives for a, b in zip(u.tolist(), p.tolist()))
    assert not any((a, b) in positives for a, b in zip(u.tolist(), n.tolist()))
    assert len(set(u.tolist())) > data.num_users // 2


def test_sampler_needs_a_device_without_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_sampler.NegativeSampler(data)
