"""The data axis splits the step (ROADMAP A.12): a (2, 1) mesh of one gloo
group of 2 CPU ranks against the port on one process.

Data rank r takes rows [r·B/2, (r+1)·B/2) of the batch and computes only
their loss and backward (`parallel.mesh.split_batch`); the batch's row
lookups all-gather their rows' cotangents and scatter the whole batch,
so LightGCN's propagation runs its backward on one process's cotangent.
The group runs every case once (tests/_torch_mesh_worker.py
``suite_data_axis``; the join has a 120 s timeout) while the parent
computes the references.

Bars:
* LightGCN int8, int4 and dense bfloat16: the cotangent entering the
  propagation, the step's gradients and the tables after the step equal
  one process's bit for bit (the lookups' backward scatters the whole
  batch in batch order, the L2 term's backward counts the whole batch);
  the reported loss terms, each the sum of the two ranks' shares, within
  rtol 3e-5 / atol 3e-6;
* the quantized backward on that cotangent, run on one process, plus the
  L2 term's gradient is the step's gradient bit for bit;
* CGCL (its full-pool contrasts) and LightGCN's batch-row partial
  product (its input's cotangent summed over the data axis): loss terms
  within rtol 3e-5 / atol 3e-6, gradients within 2**-7 of the largest
  entry (the port's bars on the card, PERF.md §2);
* every loss function a rank calls receives B/2 rows, and each score
  matrix CGCL keeps for the backward is [B/2, U] or [B/2, I]: half of
  one process's bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_mesh_worker import Group, propagation_cotangents, saved_shapes, step_inputs
from idgrec_torch.config import Config
from idgrec_torch.config import load_model_config
from idgrec_torch.data.dataset import make_synthetic_dataset
from idgrec_torch.engine.trainer import EpochRunner
from idgrec_torch.models import get_model
from idgrec_torch.ops import losses

SHAPE, SEED, B = (67, 83, 1024, 128), 21, 64
BASE = {"dataset": "tiny", "top_K": "[3, 5]", "training_epochs": "1", "interval": "1",
        "embedding_size": "16", "batch_size": str(B), "test_batch_size": "32",
        "learn_rate": "0.01", "reg_lambda": "0.0001", "GCN_layer": "2"}
LIGHTGCN = {
    "int8": {"propagation_backend": "fused", "compute_dtype": "int8"},
    "int4": {"propagation_backend": "fused", "compute_dtype": "int4"},
    "dense_bf16": {"propagation_backend": "dense", "compute_dtype": "bfloat16"},
}
TERMS = dict(rtol=3e-5, atol=3e-6)
GRAD = 2.0 ** -7


def _cases():
    cases = {mode: ("LightGCN", {**load_model_config("LightGCN").as_dict(), **BASE, **over})
             for mode, over in LIGHTGCN.items()}
    # the batch-row partial product: the last layer on the rank's rows
    cases["rows"] = ("LightGCN", {**cases["dense_bf16"][1], "batch_rows_propagation": "1"})
    # CGCL at its published weights, its contrasts made to count
    cases["CGCL"] = ("CGCL", {**load_model_config("CGCL").as_dict(), **BASE,
                              "ssl_lambda_alpha": "0.1", "ssl_lambda_beta": "0.1",
                              "ssl_lambda_gamma": "0.1"})
    return cases


def _triple(data):
    rng = np.random.default_rng(4)
    pick = rng.integers(0, data.num_train, B)
    return data.train_user[pick], data.train_item[pick], rng.integers(0, data.num_items, B)


def _one_process(data, name, cfg, triple):
    """One step on one process: terms, gradients, tables after it, the
    propagation's cotangents and the saved float tensors' shapes."""
    model = get_model(name)(Config(cfg), data, device="cpu")
    cot = propagation_cotangents(model) if name == "LightGCN" else {}
    runner = EpochRunner(model, float(cfg["learn_rate"]), B, B)
    (u, p, n), epoch, gen = step_inputs(name, model, triple)
    terms, shapes = saved_shapes(lambda: runner.run_epoch(u, p, n, generator=gen, epoch=epoch))
    return dict(terms=terms.numpy(), saved=shapes, cot={k: v.numpy() for k, v in cot.items()},
                grads={k: p_.grad.numpy().copy() for k, p_ in model.named_parameters()},
                params={k: p_.detach().numpy().copy() for k, p_ in model.named_parameters()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    data = make_synthetic_dataset(*SHAPE, seed=SEED, name="tiny")
    triple = _triple(data)
    inputs = {"shape": SHAPE, "seed": SEED, "triple": triple, "cases": _cases()}
    group = Group("data_axis", tmp_path_factory.mktemp("data_axis"), 2, inputs)
    refs = {key: _one_process(data, name, cfg, triple) for key, (name, cfg) in _cases().items()}
    return group.join(), refs, data


@pytest.mark.parametrize("mode", list(LIGHTGCN))
def test_lightgcn_step_on_the_data_axis_is_one_process_bit_for_bit(run, mode):
    ranks, refs, _ = run
    want = refs[mode]
    for got in (r[mode] for r in ranks):
        np.testing.assert_allclose(got["terms"], want["terms"], **TERMS)
        for k in want["params"]:
            np.testing.assert_array_equal(got["grads"][k], want["grads"][k], err_msg=k)
            np.testing.assert_array_equal(got["params"][k], want["params"][k], err_msg=k)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_the_quantized_backward_runs_on_the_data_summed_cotangent(run, mode):
    """The cotangent each data rank feeds the quantized chain is one
    process's, bit for bit, and the chain's backward on it (here on one
    process) plus the L2 term's gradient is the rank's step gradient: no
    partial gradient was summed after the backward."""
    ranks, refs, data = run
    name, cfg = _cases()[mode]
    u, p, n = (torch.from_numpy(np.asarray(a, np.int64)) for a in _triple(data))
    for got in (r[mode] for r in ranks):
        for k in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(got["cot"][k], refs[mode]["cot"][k], err_msg=k)
        model = get_model(name)(Config(cfg), data, device="cpu")
        tables = (model.user_emb, model.item_emb)
        ua, ia = model.propagate()
        chain = torch.autograd.grad((ua, ia), tables, tuple(
            torch.from_numpy(got["cot"][k]) for k in ("user_emb", "item_emb")))
        reg = model.reg_lambda * losses.reg_loss_indexed(*tables, u, p, n)
        l2 = torch.autograd.grad(reg, tables)
        for k, a, b in zip(("user_emb", "item_emb"), chain, l2):
            np.testing.assert_array_equal((a + b).numpy(), got["grads"][k], err_msg=k)


@pytest.mark.parametrize("key", ["CGCL", "rows"])
def test_coupled_step_on_the_data_axis_matches_one_process(run, key):
    ranks, refs, _ = run
    want = refs[key]
    for got in (r[key] for r in ranks):
        np.testing.assert_allclose(got["terms"], want["terms"], **TERMS)
        for k, a in want["grads"].items():
            err = float(np.abs(got["grads"][k] - a).max())
            assert err <= GRAD * float(np.abs(a).max()), (k, err)


@pytest.mark.parametrize("key", list(_cases()))
def test_each_data_rank_sees_half_the_batch(run, key):
    ranks, _, _ = run
    for r in ranks:
        rows = r[key]["rows"]
        assert rows and {n for _, n in rows} == {B // 2}, sorted(set(rows))


def test_cgcl_keeps_half_the_scores_a_rank(run):
    """CGCL's six contrasts against a full table each keep a float32 score
    matrix for the backward: [B/2, U or I] on a data rank, half of one
    process's bytes, and no rank keeps one over the whole batch."""
    ranks, refs, data = run
    sides = (data.num_users, data.num_items)

    def scores(shapes):
        return [s for s in shapes if len(s) == 2 and s[1] in sides and s[0] in (B, B // 2)]

    want = scores(refs["CGCL"]["saved"])
    assert want and {s[0] for s in want} == {B}
    for r in ranks:
        got = scores(r["CGCL"]["saved"])
        assert {s[0] for s in got} == {B // 2}
        assert 2 * sum(np.prod(s) for s in got) == sum(np.prod(s) for s in want)
