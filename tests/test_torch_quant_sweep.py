"""The chain's sweeps on the previous sweep's float32 output: each
`chainmm.DualSweep` instance takes a side's input as (z, amax), which
the dual's turn-in rounds as K3 (`propagate.quantize_rows`) rounds it,
or as a zero input (None: q = 0, scale 1; EGCF's seed sweeps). On the
CPU the sweep is its plain version, which must be the route the fold
replaced: K3's plain version on each side, the plain dual (K1's, or
K5's on the nibble-packed matrix), then the epilogue's plain version on
each side that runs.

Bars:
* `.plain` on (z, amax) against `quantize_rows_plain` followed by the
  plain dual and the side epilogues, and against `.plain` on (q, s),
  `.separate` and the call itself: exact equality of every output (the
  bits of z or the store, amax, the combine, the h slices), int8 and
  int4, every combine and inject flag, with and without a next input;
  the seed sweeps' per-side cases and zero inputs; infinite and NaN
  amax, NaN over a whole node block of z;
* the chains' sweep loops (`chainmm._run_chain` and its three siblings)
  reach no standalone K3 (`propagate.quantize_rows` raises here) and
  equal the plain chain exactly, forward and backward. The chains on
  (z, amax) inputs against the JAX chain are the cases of
  tests/test_torch_chain_sweep.py and tests/test_torch_tanh_sweep.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import fusedmm as t_fusedmm
from idgrec_torch.ops import propagate as t_prop

torch.set_num_threads(1)

D = 8
_SHAPE = (300, 500, 4000, 800)
_PLAIN_DUAL = {"int8": t_fusedmm.fused_adj_matmul_int8_t_plain,
               "int4": t_fusedmm.fused_adj_matmul_int4_t_plain}
_SWEEPS = {"forward": t_chainmm.dual_sweep, "inject": t_chainmm.dual_sweep_inject,
           "tanh": t_chainmm.dual_sweep_tanh, "tanh_inject": t_chainmm.dual_sweep_tanh_inject}
_EPILOGUES = {"forward": t_chainmm.chain_sweep_epilogue_plain,
              "inject": t_chainmm.chain_sweep_inject_plain,
              "tanh": t_chainmm.chain_sweep_tanh_plain,
              "tanh_inject": t_chainmm.chain_sweep_tanh_inject_plain}
_FLAGS = {"forward": (t_chainmm.COMBINE_NONE, t_chainmm.COMBINE_SET, t_chainmm.COMBINE_ADD),
          "tanh": (t_chainmm.COMBINE_NONE, t_chainmm.COMBINE_SET, t_chainmm.COMBINE_ADD),
          "inject": (False, True), "tanh_inject": (False, True)}


def _inputs(seed, u_pad=128, i_pad=4096):
    """A sweep's operands from a seed: the stored counts of int8 and
    int4, each side's z [D, n] with its amax, (user, item) post and pre
    vectors zero past the real nodes, [D, n] combines or cotangents, and
    tanh outputs for the backward's h."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((u_pad, i_pad)) < 0.03, rng.integers(1, 8, (u_pad, i_pad)), 0)
    m8 = torch.from_numpy(m.astype(np.int8))
    zs, post, pre, ext, h = [], [], [], [], []
    for n, real in ((u_pad, u_pad - 7), (i_pad, i_pad - 300)):
        z = torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32))
        z[:, real:] = 0.0
        zs.append((z, z.abs().amax(dim=1)))
        vec = rng.random((2, n)).astype(np.float32)
        vec[:, real:] = 0.0
        post.append(torch.from_numpy(vec[0]))
        pre.append(torch.from_numpy(vec[1]))
        ext.append(torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32) * 1e-2))
        h.append(torch.tanh(torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32))))
    stored = {"int8": m8, "int4": t_fusedmm.pack_nibbles(m8)}
    return stored, zs, tuple(post), tuple(pre), tuple(ext), tuple(h)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _old_route(kind, quant, m, inputs, post, pre, ext, flag, want_next, hs, sides):
    """K3's plain version on each (z, amax) input (int8 zeros with
    scale 1 for a zero input), the plain dual, then the epilogue's plain
    version on each side that runs: the sweep as the chain ran it before
    the rounding moved into the turn-in."""
    q = []
    for (x, a), n in zip(inputs, (m.shape[0], m.shape[1] * (2 if quant == "int4" else 1))):
        q.append(t_prop.quantize_rows_plain(x, a) if x is not None else
                 (torch.zeros((D, n), dtype=torch.int8), torch.ones((D, 1))))
    (qu, su), (qi, si) = q
    yu, yi = _PLAIN_DUAL[quant](m, qu, qi)
    wants = want_next if isinstance(want_next, tuple) else (want_next, want_next)
    h_arg = kind in ("tanh", "tanh_inject")
    out = []
    for k, (y, s_) in enumerate(((yu, si), (yi, su))):
        if not sides[k]:
            out += [None, None]
            continue
        extra = (hs[k],) if h_arg else ()
        out += _EPILOGUES[kind](y, s_[:, 0], post[k], pre[k], ext[k], *extra, flag, wants[k])
    return out, (qu, su, qi, si)


def _check_routes(kind, quant, stored, inputs, post, pre, ext0, h0, flag, want_next,
                  sides=(True, True)):
    """Every route of one sweep on the same operands, bit for bit: the
    call (on the CPU its plain version), `.plain` and `.separate` on the
    (z, amax) inputs, `.plain` on K3's (q, s), and the old route."""
    m = stored[quant]
    sweep = _SWEEPS[kind]
    forward = kind in ("forward", "tanh")
    runs = {}
    for route in ("old", "call", "plain", "separate", "plain_q"):
        ext = [t.clone() if t is not None else None for t in ext0]
        if kind == "tanh":
            hs = [torch.full((D, p.shape[0]), float("nan")) for p in post]
        else:
            hs = list(h0)
        (xu, au), (xi, ai) = inputs
        if route == "old":
            out, q = _old_route(kind, quant, m, inputs, post, pre, ext, flag, want_next, hs,
                                sides)
        else:
            if route == "plain_q":
                xu, au, xi, ai = q
            fn = {"call": sweep, "plain": sweep.plain, "plain_q": sweep.plain,
                  "separate": sweep.separate}[route]
            out = list(fn(quant, m, xu, au, xi, ai, post, pre, ext, flag, want_next, hs, sides))
        runs[route] = out + ext + (hs if kind == "tanh" else [])
    for route, got in runs.items():
        assert all(_same(a, b) for a, b in zip(got, runs["old"])), route
    if not forward:
        assert all(a is None or torch.equal(a, b) for a, b in zip(ext, ext0))  # read only
    return runs["call"]


@pytest.mark.parametrize("kind,flag", [(k, f) for k, flags in _FLAGS.items() for f in flags])
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("want_next", [True, False])
def test_sweep_on_z_equals_quantize_then_sweep(kind, flag, quant, want_next):
    stored, zs, post, pre, ext, h = _inputs(11)
    if kind in ("inject", "tanh_inject"):
        post, pre = pre, post  # the backward binds (post, pre) to (r, l)
    h0 = h if (kind == "tanh_inject" and want_next) else (None, None)
    got = _check_routes(kind, quant, stored, zs, post, pre, ext, h0, flag, want_next)
    assert (got[1] is None) == (not want_next) and (got[3] is None) == (not want_next)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["forward_seed", "forward_reuse", "backward_users_next",
                                  "backward_seed", "zero_users", "zero_items"])
def test_sweep_side_cases_equal_quantize_then_sweep(quant, case):
    """EGCF's seed sweeps and the zero input: the forward's seed sweep
    (a zero user input, the users alone), sweep 1 rounding the seed's
    item input again, the backward's sweep K − 1 (the users' next input
    alone) and sweep K (a zero item input, the items alone); a zero
    input on either side of a linear sweep."""
    stored, zs, post, pre, ext, h = _inputs(12)
    none = (None, None)
    if case == "forward_seed":
        got = _check_routes("tanh", quant, stored, [none, zs[1]], post, pre, ext, none,
                            t_chainmm.COMBINE_NONE, True, (True, False))
        assert got[2] is None and got[3] is None and bool(got[0].abs().sum() > 0)
    elif case == "forward_reuse":
        _check_routes("tanh", quant, stored, zs, post, pre, ext, none, t_chainmm.COMBINE_SET,
                      True)
    elif case == "backward_users_next":
        got = _check_routes("tanh_inject", quant, stored, zs, pre, post, ext, (h[0], None),
                            False, (True, False))
        assert got[1] is not None and got[3] is None
    elif case == "backward_seed":
        got = _check_routes("tanh_inject", quant, stored, [zs[0], none], pre, post,
                            (None, ext[1]), none, True, False, (False, True))
        assert got[0] is None and got[2] is not None
    else:
        inputs = [none, zs[1]] if case == "zero_users" else [zs[0], none]
        got = _check_routes("forward", quant, stored, inputs, post, pre, ext, none,
                            t_chainmm.COMBINE_ADD, True)
        # the sums of the side fed by the zero input are zeros
        zero_side = 2 if case == "zero_users" else 0
        assert not bool(got[zero_side].any())


@pytest.mark.parametrize("kind", list(_SWEEPS))
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["inf_amax", "nan_amax", "nan_z_block"])
def test_sweep_non_finite_amax_equals_quantize_then_sweep(kind, quant, case):
    """An infinite amax (scale inf: the feature rounds to 0 and its
    products turn NaN), a NaN amax (scale 1, as K3 takes it) and NaN z
    over a whole node block of one feature give the old route's bits."""
    stored, zs, post, pre, ext, h = _inputs(13)
    (zu, au), (zi, ai) = ((z.clone(), a.clone()) for z, a in zs)
    if case == "inf_amax":
        au[3] = float("inf")
        ai[5] = float("inf")
    elif case == "nan_amax":
        ai[2] = float("nan")
    else:
        zi[6, 1024:2048] = float("nan")
    flag = _FLAGS[kind][-1]
    h0 = h if kind == "tanh_inject" else (None, None)
    if kind in ("inject", "tanh_inject"):
        post, pre = pre, post
    got = _check_routes(kind, quant, stored, [(zu, au), (zi, ai)], post, pre, ext, h0, flag,
                        True)
    if case == "nan_amax":
        # a NaN amax takes scale 1, as K3 takes it: the user sums of that
        # item feature stay numbers
        assert bool(torch.isfinite(got[0][2]).all())


@pytest.fixture(scope="module")
def adjs():
    data = t_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    return {quant: t_prop.build_adjacency(data, "sym", "fused", compute_dtype=quant, emb_size=D,
                                          device="cpu")
            for quant in ("int8", "int4")}


def _run(adj, x, w, layers, include_layer0, reduce, activation, seed, fn):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(adj, xt, layers, include_layer0, reduce, activation, seed)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), xt.grad


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("tanh", [False, True])
def test_chain_reaches_no_standalone_k3(adjs, monkeypatch, quant, tanh):
    """The sweep loops hand each sweep the previous sweep's (z, amax): K3's
    wrapper is never called, and the chain equals the plain chain."""
    t = adjs[quant]
    rng = np.random.default_rng(17)
    x, w = (rng.normal(size=(t.shape[0], D)).astype(np.float32) for _ in range(2))
    if tanh:
        x[: t.num_users] = 0.0
    args = (3, not tanh, "sum", torch.tanh if tanh else None, tanh)
    want = _run(t, x, w, *args, t_chainmm.fused_chain_resident_plain)

    def refuse(*_):
        raise AssertionError("a chain's sweep loop called K3's wrapper")

    monkeypatch.setattr(t_prop, "quantize_rows", refuse)
    got = _run(t, x, w, *args, t_chainmm.fused_chain_resident)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[1].abs().sum() > 0)
