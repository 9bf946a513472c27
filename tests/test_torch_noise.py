"""The draws of a step (idgrec_torch/ops/noise.py) held to their
distributions, on a seeded CPU generator with many draws, and the two
model helpers that draw (`base.torch_linear_init`, `base.dropout`).

Bounds, with their reasons: 10**6 draws put the standard error of a mean
at sqrt(var / 10**6), at most 1e-3 here, and of a variance below 3e-4;
MEAN_TOL = 5e-3 and VAR_TOL = 3e-3 are five times that or more, so a
correct sampler fails with odds far below one in a million, and a
sampler off by a percent of the spread fails.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from idgrec_torch.models import base
from idgrec_torch.ops import noise

torch.set_num_threads(1)

N = 1_000_000
MEAN_TOL, VAR_TOL = 5e-3, 3e-3


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _beta_moments(a, b):
    return a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))


@pytest.mark.parametrize("kind,mean,var", [("uniform", 0.5, 1 / 12), ("normal", 0.0, 1.0)])
def test_uniform_and_normal_moments(kind, mean, var):
    x = getattr(noise, kind)((1000, 1000), _gen(1))
    assert x.dtype == torch.float32 and x.shape == (1000, 1000)
    assert abs(float(x.mean()) - mean) < MEAN_TOL
    assert abs(float(x.var()) - var) < VAR_TOL * max(var, 1.0)
    if kind == "uniform":
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0


@pytest.mark.parametrize("a,b", [(0.1, 0.1), (2.0, 5.0), (0.5, 3.0)])
def test_beta_moments_and_no_nan(a, b):
    """Beta(0.1, 0.1), MixRec's published draw, has mean 0.5 and
    variance ab / ((a+b)²(a+b+1)) = 0.2083; (2, 5) draws with no boost,
    (0.5, 3) with one side boosted."""
    x = noise.beta(a, b, _gen(2), shape=(N,))
    mean, var = _beta_moments(a, b)
    assert x.shape == (N,) and x.dtype == torch.float32
    assert not bool(torch.isnan(x).any())
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert abs(float(x.mean()) - mean) < MEAN_TOL
    assert abs(float(x.var()) - var) < VAR_TOL


def test_beta_is_a_scalar_by_default_and_the_mass_sits_at_the_ends():
    x = noise.beta(0.1, 0.1, _gen(3))
    assert x.dim() == 0 and 0.0 <= float(x) <= 1.0
    # Beta(0.1, 0.1): P(x < 0.01) = P(x > 0.99) = 0.3203 (the regularized
    # incomplete beta function), standard error 4.7e-4 at 10**6 draws
    y = noise.beta(0.1, 0.1, _gen(4), shape=(N,))
    lo, hi = float((y < 0.01).float().mean()), float((y > 0.99).float().mean())
    assert abs(lo - 0.3203) < 0.003 and abs(hi - 0.3203) < 0.003


def test_dirichlet_rows_sum_to_one():
    alpha = torch.full((200, 2048), 0.1)
    x = noise.dirichlet(alpha, _gen(5))
    assert x.shape == (200, 2048) and x.dtype == torch.float32
    assert not bool(torch.isnan(x).any()) and float(x.min()) >= 0.0
    torch.testing.assert_close(x.sum(dim=-1), torch.ones(200), rtol=0, atol=1e-5)
    # each coordinate's mean is alpha_i / sum(alpha) = 1/2048
    assert abs(float(x.mean()) - 1 / 2048) < 1e-7
    # and its variance a_i (a0 - a_i) / (a0² (a0 + 1)), a0 = 204.8
    a0 = 204.8
    var = 0.1 * (a0 - 0.1) / (a0 ** 2 * (a0 + 1))
    assert abs(float(x.var()) / var - 1) < 0.05


def test_dirichlet_of_two_is_beta():
    """Dirichlet([a, b])'s first coordinate has Beta(a, b)'s moments."""
    x = noise.dirichlet(torch.tensor([0.1, 0.1]).repeat(N, 1), _gen(6))[:, 0]
    mean, var = _beta_moments(0.1, 0.1)
    assert abs(float(x.mean()) - mean) < MEAN_TOL and abs(float(x.var()) - var) < VAR_TOL


@pytest.mark.parametrize("n", [1, 7, 2048])
def test_permutation_is_a_permutation(n):
    p = noise.permutation(n, _gen(7))
    assert p.dtype == torch.int64 and p.shape == (n,)
    np.testing.assert_array_equal(np.sort(p.numpy()), np.arange(n))


def test_permutations_are_uniform():
    """Where each of 4 items lands over 24,000 permutations: 1/4 a place."""
    g = _gen(8)
    first = np.zeros((4, 4))
    for _ in range(24_000):
        first[np.arange(4), noise.permutation(4, g).numpy()] += 1
    assert np.abs(first / 24_000 - 0.25).max() < 0.015


@pytest.mark.parametrize("p", [0.5, 0.6, 0.95])
def test_bernoulli_mean(p):
    x = noise.bernoulli(p, (1000, 1000), _gen(12))
    assert x.dtype == torch.bool and x.shape == (1000, 1000)
    assert abs(float(x.float().mean()) - p) < MEAN_TOL


@pytest.mark.parametrize("n,k", [(38_048, 2000), (300, 16), (5, 5), (7, 0)])
def test_choice_gives_k_distinct_indices(n, k):
    x = noise.choice(n, k, _gen(13))
    assert x.dtype == torch.int64 and x.shape == (k,)
    assert len(set(x.tolist())) == k and all(0 <= i < n for i in x.tolist())


def test_choice_is_uniform_and_refuses_too_many():
    """Which of 6 indices a draw of 2 takes, over 30,000 draws: 1/3 each."""
    g = _gen(14)
    hits = np.zeros(6)
    for _ in range(30_000):
        hits[noise.choice(6, 2, g).numpy()] += 1
    assert np.abs(hits / 30_000 - 1 / 3).max() < 0.015
    with pytest.raises(ValueError, match="cannot choose 7 distinct indices of range"):
        noise.choice(6, 7, g)


def test_torch_linear_init_bounds_and_order():
    """W [in, out] then b [out], each U(-k, k) with k = 1/sqrt(fan_in),
    W drawn first from the generator."""
    w, b = base.torch_linear_init(_gen(15), 64, 3)
    k = 1.0 / np.sqrt(64)
    assert tuple(w.shape) == (64, 3) and tuple(b.shape) == (3,)
    assert w.dtype == b.dtype == torch.float32
    w2, _ = base.torch_linear_init(_gen(15), 400, 500)
    assert float(w2.abs().max()) <= 1 / 20 and float(w2.abs().max()) > 0.99 / 20
    assert abs(float(w2.mean())) < MEAN_TOL / 20
    g = _gen(15)
    first = torch.empty((64, 3)).uniform_(-k, k, generator=g)
    then = torch.empty((3,)).uniform_(-k, k, generator=g)
    assert torch.equal(w, first) and torch.equal(b, then)


def test_dropout_scales_the_kept_entries_and_is_the_identity_at_rate_0():
    x = torch.from_numpy(np.random.default_rng(16).normal(size=(1000, 1000)).astype(np.float32))
    g = _gen(17)
    state = g.get_state()
    assert base.dropout(x, 0.0, g) is x and torch.equal(g.get_state(), state)
    y = base.dropout(x, 0.4, g)
    kept = y != 0
    assert y.dtype == x.dtype and abs(float(kept.float().mean()) - 0.6) < MEAN_TOL
    # kept values are x / 0.6, correctly rounded
    want = x / torch.full((), 0.6, dtype=torch.float32)
    assert torch.equal(y[kept], want[kept])
    mask = noise.bernoulli(0.6, x.shape, _gen(17))
    assert torch.equal(kept, mask & (x != 0))
    assert base.dropout(x.to(torch.bfloat16), 0.4, g).dtype == torch.bfloat16


_CALLS = {
    "uniform": lambda g: noise.uniform((64, 32), g),
    "normal": lambda g: noise.normal((64, 32), g),
    "beta": lambda g: noise.beta(0.1, 0.1, g, shape=(64,)),
    "dirichlet": lambda g: noise.dirichlet(torch.full((4, 64), 0.1), g),
    "permutation": lambda g: noise.permutation(64, g),
    "bernoulli": lambda g: noise.bernoulli(0.5, (64, 32), g),
    "choice": lambda g: noise.choice(64, 16, g),
}


@pytest.mark.parametrize("kind", sorted(_CALLS))
def test_the_same_seed_gives_the_same_draws(kind):
    a, b, c = (_CALLS[kind](_gen(s)) for s in (9, 9, 10))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("kind", sorted(_CALLS))
def test_no_generator_raises(kind):
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        _CALLS[kind](None)


@pytest.mark.parametrize("kind", sorted(_CALLS))
def test_the_global_generator_is_not_touched(kind):
    torch.manual_seed(123)
    state = torch.get_rng_state()
    g = _gen(11)
    before = g.get_state()
    _CALLS[kind](g)
    assert torch.equal(torch.get_rng_state(), state)
    assert not torch.equal(g.get_state(), before)
