"""The quantized chain's sweep, `chainmm.dual_sweep` (forward) and
`dual_sweep_inject` (the straight-through backward): on the card the
dual kernel (K1, or K5 on the nibble-packed matrix) with K2's epilogue
in its turn-out; on the CPU its plain version, which is the plain dual
followed by K2's plain version on each side.

Bars:
* the sweep against the separate plain calls (the dual, then two K2
  calls), int8 and int4, every combine mode, with and without a next
  input, injecting or not: exact equality (z or the store, the
  combine, amax); int4 against int8 on the same counts: exact;
* the linear chain through the new `ChainOps` against a chain whose
  sweeps are the separate calls (K3, the dual, two K2 calls): exact,
  forward and backward;
* the chain against the JAX chain (Pallas kernels interpreted on the
  CPU), forward and backward, int8 and int4: TIGHT at one sweep, NOISE
  at three plus a relative L2 error below 1e-2, the bars of
  tests/test_torch_propagate.py and tests/test_torch_chain_bwd.py (an
  ulp on a rounding tie moves one quantized activation by 1 lsb)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import fusedmm as t_fusedmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.ops import chainmm as j_chainmm
from idgrec_tpu.ops import propagate as j_prop

torch.set_num_threads(1)

TIGHT = dict(rtol=3e-5, atol=3e-6)
NOISE = dict(rtol=2e-2, atol=1e-2)
D = 8
_SHAPE = (300, 500, 4000, 800)
_COMBINES = (t_chainmm.COMBINE_NONE, t_chainmm.COMBINE_SET, t_chainmm.COMBINE_ADD)


def _sweep_inputs(seed, u_pad=128, i_pad=4096):
    """One sweep's operands from a seed: the int8 counts and their
    packing, the quantized inputs and scales (K3's plain version),
    (user, item) post and pre vectors zero past the real nodes, and
    [d, N] combines or cotangents."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((u_pad, i_pad)) < 0.03, rng.integers(1, 8, (u_pad, i_pad)), 0)
    m8 = torch.from_numpy(m.astype(np.int8))
    qs = []
    for n in (u_pad, i_pad):
        z = torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32))
        qs.append(t_prop.quantize_rows_plain(z, z.abs().amax(dim=1)))
    (qu, su), (qi, si) = qs
    post, pre, ext = [], [], []
    for n, real in ((u_pad, u_pad - 7), (i_pad, i_pad - 300)):
        vec = rng.random((2, n)).astype(np.float32)
        vec[:, real:] = 0.0
        post.append(torch.from_numpy(vec[0]))
        pre.append(torch.from_numpy(vec[1]))
        ext.append(torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32) * 1e-2))
    return m8, qu, su, qi, si, tuple(post), tuple(pre), tuple(ext)


def _stored(quant, m8):
    return t_fusedmm.pack_nibbles(m8) if quant == "int4" else m8


def _separate(quant, m, qu, su, qi, si, post, pre, ext, flag, want_next, inject):
    """The sweep as separate plain calls: the dual, then K2 (or its
    inject mode) on each side."""
    dual = (t_fusedmm.fused_adj_matmul_int4_t_plain if quant == "int4"
            else t_fusedmm.fused_adj_matmul_int8_t_plain)
    yu, yi = dual(m, qu, qi)
    epi = t_chainmm.chain_sweep_inject_plain if inject else t_chainmm.chain_sweep_epilogue_plain
    return (*epi(yu, si[:, 0], post[0], pre[0], ext[0], flag, want_next),
            *epi(yi, su[:, 0], post[1], pre[1], ext[1], flag, want_next))


def _equal(a, b):
    return (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("combine", _COMBINES)
@pytest.mark.parametrize("want_next", [True, False])
def test_sweep_equals_separate_plain_calls(quant, combine, want_next):
    m8, qu, su, qi, si, post, pre, c0 = _sweep_inputs(1)
    m = _stored(quant, m8)
    c_got, c_want, c_int8 = ([t.clone() for t in c0] for _ in range(3))
    before = (t_chainmm.dual_sweep.launches, t_chainmm.chain_sweep_epilogue.launches)
    got = t_chainmm.dual_sweep(quant, m, qu, su, qi, si, post, pre, c_got, combine, want_next)
    # the CPU takes the plain version: no kernel is counted
    assert (t_chainmm.dual_sweep.launches, t_chainmm.chain_sweep_epilogue.launches) == before
    want = _separate(quant, m, qu, su, qi, si, post, pre, c_want, combine, want_next, False)
    int8 = t_chainmm.dual_sweep_plain("int8", m8, qu, su, qi, si, post, pre, c_int8, combine,
                                      want_next)
    assert all(_equal(a, b) and _equal(a, c) for a, b, c in zip(got, want, int8))
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(c_got, c_want, c_int8))
    if combine == t_chainmm.COMBINE_NONE:
        assert all(torch.equal(a, b) for a, b in zip(c_got, c0))
    assert (got[1] is None) == (not want_next)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("inject,want_next", [(True, True), (True, False), (False, True),
                                              (False, False)])
def test_sweep_inject_equals_separate_plain_calls(quant, inject, want_next):
    m8, qu, su, qi, si, post, pre, g0 = _sweep_inputs(2)
    m = _stored(quant, m8)
    g = tuple(t.clone() for t in g0)
    before = (t_chainmm.dual_sweep_inject.launches, t_chainmm.chain_sweep_inject.launches)
    got = t_chainmm.dual_sweep_inject(quant, m, qu, su, qi, si, post, pre, g, inject, want_next)
    assert (t_chainmm.dual_sweep_inject.launches, t_chainmm.chain_sweep_inject.launches) == before
    want = _separate(quant, m, qu, su, qi, si, post, pre, g, inject, want_next, True)
    int8 = t_chainmm.dual_sweep_inject_plain("int8", m8, qu, su, qi, si, post, pre, g, inject,
                                             want_next)
    assert all(_equal(a, b) and _equal(a, c) for a, b, c in zip(got, want, int8))
    assert all(torch.equal(a, b) for a, b in zip(g, g0))  # read only
    assert (got[1] is None) == (not want_next)


def _separate_ops():
    """`PLAIN` with the linear chain's sweeps made of the separate calls,
    as the chain ran them before the quantization moved into the dual's
    turn-in and the epilogue into its turn-out: K3 on each side, the
    dual, then two K2 calls."""
    quantize = t_prop.quantize_rows_plain

    def sweep(quant, m, zu, au, zi, ai, post, pre, c, combine, want_next):
        return _separate(quant, m, *quantize(zu, au), *quantize(zi, ai), post, pre, c, combine,
                         want_next, False)

    def sweep_inject(quant, m, zu, au, zi, ai, post, pre, g, inject, want_next):
        return _separate(quant, m, *quantize(zu, au), *quantize(zi, ai), post, pre, g, inject,
                         want_next, True)

    return t_chainmm.PLAIN._replace(sweep=sweep, sweep_inject=sweep_inject)


@pytest.fixture(scope="module")
def adjs():
    tdata = t_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    jdata = j_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    return {quant: (t_prop.build_adjacency(tdata, "sym", "auto", compute_dtype=quant,
                                           emb_size=D, device="cpu"),
                    j_prop.build_adjacency(jdata, "sym", "auto", compute_dtype=quant,
                                           emb_size=D))
            for quant in ("int8", "int4")}


def _run(adj, x, w, layers, include_layer0, reduce, ops):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_chainmm._chain(adj, xt, layers, include_layer0, reduce, ops)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), xt.grad


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("include_layer0", [True, False])
def test_chain_equals_the_separate_sweeps(adjs, quant, include_layer0):
    t, _ = adjs[quant]
    rng = np.random.default_rng(3)
    x, w = (rng.normal(size=(t.shape[0], D)).astype(np.float32) for _ in range(2))
    got = _run(t, x, w, 3, include_layer0, "mean", t_chainmm.KERNELS)
    want = _run(t, x, w, 3, include_layer0, "mean", _separate_ops())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[1].abs().sum() > 0)


@pytest.mark.parametrize("quant,layers,include_layer0,reduce", [
    ("int8", 1, True, "mean"), ("int8", 3, False, "sum"),
    ("int4", 1, False, "sum"), ("int4", 3, True, "mean"),
    ("int8", 1, False, "sum"), ("int4", 1, True, "mean"), ("int8", 3, True, "mean"),
])
def test_chain_and_gradient_meet_jax(adjs, quant, layers, include_layer0, reduce):
    t, j = adjs[quant]
    rng = np.random.default_rng(layers)
    x, w = (rng.normal(size=(t.shape[0], D)).astype(np.float32) for _ in range(2))
    out, grad = _run(t, x, w, layers, include_layer0, reduce, t_chainmm.KERNELS)
    bar = TIGHT if layers == 1 else NOISE
    ref = np.asarray(j_chainmm.fused_chain_resident(j, jnp.asarray(x), layers, include_layer0,
                                                    reduce))
    ref_grad = np.asarray(jax.grad(lambda e: jnp.sum(j_chainmm.fused_chain_resident(
        j, e, layers, include_layer0, reduce) * w))(jnp.asarray(x)))
    for got, want in ((out.numpy(), ref), (grad.numpy(), ref_grad)):
        np.testing.assert_allclose(got, want, **bar)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2
