"""The encoder-switch family's losses (`ops/losses.py`: align_loss,
uniform_loss, neighbor_aggregate_loss, lightcscf_loss,
margin_alignment_loss, dot_uniformity_loss) and SCCF's loss against the
JAX package on the same seeded inputs: values and gradients.

Tolerances, with their reasons:
* values within rtol VALUE_RTOL = 1e-5: the same float32 operations in
  the same order, but the reductions sum in another order and XLA's exp,
  log, arccos and cos differ from PyTorch's by an ulp; the means over
  B² entries (MAWU's broadcast margin term, dot_uniformity) gather the
  most round-off: measured 1.8e-6 relative (the margin term on 64 × 64
  entries), 2 ulps elsewhere;
* gradients within GRAD_REL = 2e-5 of the largest entry: the backward
  sums the same terms in another order; uniform_loss's
  d2 = |e_i|² + |e_j|² − 2 e_i·e_j cancels to ~0 on the diagonal and
  near pairs, which turns those ulps into the largest error measured,
  5.9e-6 of the largest entry; exp(total/τ) at τ = 0.2 (LightCSCF) and
  0.22 (LightCCF) amplifies a similarity's ulp ~5 times;
* SCCF's terms (exp(s²/τ) at τ = 0.1, counts of distinct users and
  items on batches with repeats) within rtol 1e-5, tests/test_torch_zoo.py's
  bar, its gradient within GRAD_REL of the largest entry: a batch of one
  distinct user sums all 256 rows' contributions into one table row, in
  another order in each package (measured 1.0e-5).
* A cosine exactly on MAWU's clip bound (0.99999988 = 1 − 1e-7 in
  float32 in both packages): both packages pass half the cotangent
  there (JAX's max and min split a tie; the port clips with
  torch.maximum and torch.minimum, which split it too, where
  torch.clamp would pass all of it); values and gradients equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.config import load_model_config as t_load_config
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import losses as T
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.ops import losses as J

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_REL = 2e-5

# name -> (port loss, JAX loss) of (emb_1, emb_2, margin)
LOSSES = {
    "align": (lambda a, b, m: T.align_loss(a, b), lambda a, b, m: J.align_loss(a, b)),
    "uniform": (lambda a, b, m: T.uniform_loss(a), lambda a, b, m: J.uniform_loss(a)),
    "neighbor_aggregate": (lambda a, b, m: T.neighbor_aggregate_loss(a, b, 0.22),
                           lambda a, b, m: J.neighbor_aggregate_loss(a, b, 0.22)),
    "lightcscf": (lambda a, b, m: T.lightcscf_loss(a, b, 0.2, 0.7),
                  lambda a, b, m: J.lightcscf_loss(a, b, 0.2, 0.7)),
    "margin_alignment": (lambda a, b, m: T.margin_alignment_loss(a, b, m),
                         lambda a, b, m: J.margin_alignment_loss(a, b, m)),
    "dot_uniformity": (lambda a, b, m: T.dot_uniformity_loss(a),
                       lambda a, b, m: J.dot_uniformity_loss(a)),
}


def _inputs(seed, b, d, scale=1.0):
    rng = np.random.default_rng(seed)
    emb_1 = (rng.normal(size=(b, d)) * scale).astype(np.float32)
    emb_2 = (rng.normal(size=(b, d)) * scale).astype(np.float32)
    margin = rng.normal(size=(b, 1)).astype(np.float32)
    return emb_1, emb_2, margin


def _port(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    value = fn(*ts)
    value.backward()
    return float(value.detach()), [t_.grad.numpy() if t_.grad is not None else None for t_ in ts]


def _jax(fn, *arrays):
    value, grads = jax.value_and_grad(fn, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    return float(value), [np.asarray(g) for g in grads]


def _grads_close(got, ref):
    for g, r in zip(got, ref):
        top = float(np.abs(r).max())
        if g is None or top == 0.0:  # an argument the loss does not read
            assert g is None or not g.any()
            continue
        assert float(np.abs(g - r).max()) <= GRAD_REL * top, (float(np.abs(g - r).max()), top)


@pytest.mark.parametrize("seed,b,d,scale", [(0, 256, 32, 1.0), (1, 64, 16, 0.01),
                                            (2, 512, 64, 3.0)])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name, seed, b, d, scale):
    t_fn, j_fn = LOSSES[name]
    arrays = _inputs(seed, b, d, scale)
    got, got_g = _port(t_fn, *arrays)
    ref, ref_g = _jax(j_fn, *arrays)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=VALUE_RTOL)
    _grads_close(got_g, ref_g)


def test_dot_uniformity_keeps_the_tril_quirk():
    """The masked entries count as cos = 0: exp(-2·2) each."""
    e = np.zeros((4, 8), np.float32)
    e[:, 0] = 1.0  # every pair has cos 1
    got = float(T.dot_uniformity_loss(torch.from_numpy(e)))
    # 6 entries below the diagonal at exp(0), 10 at exp(-4)
    np.testing.assert_allclose(got, np.log((6 + 10 * np.exp(-4.0)) / 16), rtol=VALUE_RTOL)
    np.testing.assert_allclose(got, float(J.dot_uniformity_loss(jnp.asarray(e))),
                               rtol=VALUE_RTOL)


def test_clip_on_the_bound_passes_half_the_cotangent_as_jax():
    lo, hi = -1 + 1e-7, 1 - 1e-7
    assert np.float32(hi) == np.float32(0.99999988) and np.float32(lo) == np.float32(-0.99999988)
    x = np.array([np.float32(hi), np.float32(lo), 0.5, 1.0, -1.0, np.float32(hi) - 2 ** -24],
                 np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = T._clip(xt, lo, hi)
    got.sum().backward()
    ref, ref_g = jax.value_and_grad(lambda v: jnp.clip(v, lo, hi).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jnp.clip(jnp.asarray(x), lo,
                                                                            hi)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_g))
    assert xt.grad.numpy().tolist() == [0.5, 0.5, 1.0, 0.0, 0.0, 1.0]


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_margin_alignment_at_the_clip_bounds(sign):
    """emb_2 = ±emb_1 on rows with one non-zero entry, whose cosines are
    exactly ±1 in both packages: beyond a clip bound, so no gradient
    reaches the embeddings; with -1 the angle plus the margin term passes
    π and the second clip holds it, so none reaches the margins either."""
    rng = np.random.default_rng(3)
    emb_1 = np.zeros((64, 16), np.float32)
    emb_1[np.arange(64), rng.integers(0, 16, 64)] = rng.uniform(0.5, 2.0, 64)
    emb_2 = (sign * emb_1).astype(np.float32)
    margin = rng.normal(size=(64, 1)).astype(np.float32)
    t_fn, j_fn = LOSSES["margin_alignment"]
    got, got_g = _port(t_fn, emb_1, emb_2, margin)
    ref, ref_g = _jax(j_fn, emb_1, emb_2, margin)
    np.testing.assert_allclose(got, ref, rtol=VALUE_RTOL)
    for g, r in zip(got_g[:2], ref_g[:2]):
        assert not g.any() and not r.any()
    if sign < 0:
        assert not got_g[2].any() and not ref_g[2].any()
    else:  # the margins' gradient, of -mean(cos(arccos(hi) + 1 - σ(m)))
        _grads_close(got_g[2:], ref_g[2:])
        assert np.abs(got_g[2]).min() > 0


# ---------------------------------------------------------------------------
# SCCF's loss: the counts of distinct users and items on batches with repeats

_SHAPE = (200, 300, 3000, 400)


@pytest.fixture(scope="module")
def sccf_pair():
    cfg = {**t_load_config("SCCF").as_dict(), "embedding_size": "32", "encoder": "MF"}
    tdata = t_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    jdata = j_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    jmodel = j_get_model("SCCF")(JConfig(cfg), jdata)
    params = jmodel.init_params(jax.random.PRNGKey(11))
    tmodel = t_get_model("SCCF")(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    return jmodel, tmodel, params


@pytest.mark.parametrize("distinct_users,distinct_items", [(256, 256), (7, 300), (1, 3),
                                                           (40, 1)])
def test_sccf_terms_with_repeated_ids_match_jax(sccf_pair, distinct_users, distinct_items):
    jmodel, tmodel, params = sccf_pair
    rng = np.random.default_rng(distinct_users + distinct_items)
    u = rng.choice(rng.permutation(200)[:min(distinct_users, 200)], 256)
    p = rng.choice(rng.permutation(300)[:distinct_items], 256)
    n = rng.integers(0, 300, 256)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in zip(("user", "pos", "neg"), (u, p, n))}
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in zip(("user", "pos", "neg"),
                                                                  (u, p, n))}

    def j_loss(prm):
        terms, _ = jmodel.loss_terms(prm, {}, (), jb, jax.random.PRNGKey(0), 0)
        return sum(terms), terms

    (_, jterms), ref = jax.value_and_grad(j_loss, has_aux=True)(params)
    tmodel.zero_grad(set_to_none=True)
    terms = tmodel.loss_terms(tb)
    np.testing.assert_allclose([float(t_.detach()) for t_ in terms], np.asarray(jterms),
                               rtol=1e-5)
    sum(terms).backward()
    _grads_close([getattr(tmodel, k).grad.numpy() for k in ("user_emb", "item_emb")],
                 [np.asarray(ref[k]) for k in ("user_emb", "item_emb")])
