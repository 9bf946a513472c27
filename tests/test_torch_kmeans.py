"""The port's on-device k-means (idgrec_torch/ops/kmeans.py) against the
JAX package's (idgrec_tpu/ops/kmeans.py), from the same initial rows.

JAX's k-means is jitted, so its initial rows are derived eagerly from
the same key (``jax.random.choice(key, n, (k,), replace=False)``, which
the jitted function draws alike: checked at zero iterations) and handed
to the port as its ``noise.choice``.

Bars: the assignments are equal (the same expansion x² − 2x·c + c² and
argmin; no row of these sets lies within an ulp of two centroids); the
centroids within 1e-5 (the same means of the same rows, JAX's
``segment_sum`` and the port's K4 plain version both adding in index
order; the products' float32 sums may differ in order). The port's
routes agree bit for bit: K4's plain version against a plain
``index_add_`` of the sums (both in index order on the CPU).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from idgrec_torch.ops import kmeans as t_kmeans
from idgrec_torch.ops import noise as t_noise
from idgrec_torch.ops import scatter as t_scatter
from idgrec_tpu.ops.kmeans import kmeans as j_kmeans

torch.set_num_threads(1)

CENTROID_ATOL = 1e-5


def _x(n, d, seed, clustered=True):
    """float32 [n, d]: rows around a few centres (clustered) or plain
    normal, made with numpy."""
    rng = np.random.default_rng(seed)
    if not clustered:
        return rng.normal(size=(n, d)).astype(np.float32)
    centres = rng.normal(scale=3.0, size=(8, d))
    return (centres[rng.integers(0, 8, n)] + rng.normal(size=(n, d))).astype(np.float32)


def _jax_rows(key, n, k):
    return np.asarray(jax.random.choice(key, n, (k,), replace=False))


@pytest.fixture
def fixed_choice(monkeypatch):
    """Makes the port's ``noise.choice`` return the given rows, once."""
    queue = []

    def choice(n, k, generator):
        rows = queue.pop(0)
        assert rows.shape == (k,) and rows.max() < n
        return torch.from_numpy(rows.astype(np.int64))

    monkeypatch.setattr(t_noise, "choice", choice)
    return queue


@pytest.mark.parametrize("n,k,d,iters,clustered", [
    (300, 16, 32, 20, True), (200, 16, 32, 5, False), (1000, 64, 64, 20, True),
    (300, 300, 8, 3, False), (500, 7, 16, 1, True)])
def test_kmeans_matches_jax_from_the_same_initial_rows(fixed_choice, n, k, d, iters, clustered):
    x = _x(n, d, n + k, clustered)
    key = jax.random.PRNGKey(n * k)
    rows = _jax_rows(key, n, k)
    # the eager derivation is the jitted function's draw
    j_init, _ = j_kmeans(key, x, k, iters=0)
    np.testing.assert_array_equal(np.asarray(j_init), x[rows])
    jc, ja = j_kmeans(key, x, k, iters=iters)
    fixed_choice.append(rows)
    tc, ta = t_kmeans.kmeans(torch.from_numpy(x), k, torch.Generator(), iters=iters)
    assert not fixed_choice
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (k, d)
    assert ta.dtype == torch.int64 and tuple(ta.shape) == (n,)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=CENTROID_ATOL)


def test_an_empty_cluster_keeps_its_centroid(fixed_choice):
    """Rows 0 and 1 are equal, far from the others, and both start a
    centroid: both rows go to the same one of the two (whichever the
    float32 product puts nearer), so the other never gets a row and stays
    where it began, not at zero; every other centroid is the mean of its
    rows."""
    x = _x(120, 8, 3)
    x[0] = x[1] = 50.0
    rows = np.array([0, 1, 40, 80], dtype=np.int64)
    fixed_choice.append(rows)
    c, a = t_kmeans.kmeans(torch.from_numpy(x), 4, torch.Generator(), iters=6)
    a = a.numpy()
    assert a[0] == a[1] in (0, 1) and not (a[2:] < 2).any()
    empty = 1 - a[0]
    assert not (a == empty).any()
    np.testing.assert_array_equal(c[empty].numpy(), x[1])
    for j in (a[0], 2, 3):
        members = x[a == j]
        assert len(members)
        np.testing.assert_allclose(c[j].numpy(), members.mean(axis=0), rtol=0, atol=1e-5)


def test_k4_plain_version_and_a_plain_index_add_give_the_same_bits(monkeypatch):
    """The sums through K4's plain version (what the kernel wrapper runs
    on the CPU) and through ``index_add_`` (index order on the CPU):
    the same clustering bit for bit, and the wrapper is what k-means
    calls."""
    x = torch.from_numpy(_x(600, 16, 4))
    calls = []
    k4 = t_scatter.scatter_add_rows_unchecked

    def counted(idx, vals, n_rows):
        calls.append(n_rows)
        return k4(idx, vals, n_rows)

    monkeypatch.setattr(t_scatter, "scatter_add_rows_unchecked", counted)
    got = t_kmeans.kmeans(x, 24, torch.Generator().manual_seed(5), iters=7)
    assert calls == [24] * 7
    monkeypatch.setattr(t_scatter, "scatter_add_rows_unchecked",
                        lambda idx, vals, n_rows: torch.zeros(
                            (n_rows, vals.shape[1])).index_add_(0, idx, vals))
    want = t_kmeans.kmeans(x, 24, torch.Generator().manual_seed(5), iters=7)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_same_generator_seed_gives_the_same_clustering():
    x = torch.from_numpy(_x(400, 8, 6))
    a = t_kmeans.kmeans(x, 10, torch.Generator().manual_seed(1))
    b = t_kmeans.kmeans(x, 10, torch.Generator().manual_seed(1))
    c = t_kmeans.kmeans(x, 10, torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_kmeans_takes_no_gradient_and_refuses_too_many_clusters():
    x = torch.from_numpy(_x(50, 4, 7)).requires_grad_()
    c, a = t_kmeans.kmeans(x, 5, torch.Generator())
    assert not c.requires_grad and not a.requires_grad
    with pytest.raises(ValueError, match="cannot choose 60 distinct indices"):
        t_kmeans.kmeans(x, 60, torch.Generator())
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        t_kmeans.kmeans(x, 5, None)
