"""MFBPR and the encoder-switch family (DirectAU, MAWU, SCCF, LightCCF,
LightCSCF) in the port against the JAX package: the same tables carried
across (`convert`), the same batches, each model under MF and, where it
has one, the LightGCN encoder over the published default route
(bfloat16, backend ``auto``: dense, whose products run kernel K6's plain
version on the CPU at d = 32). K6 computes the JAX fused backend's
function (bfloat16 operands, float32 sums, the cotangent rounded to
bfloat16 going into the swapped product), so the JAX side of a LightGCN
encoder runs ``propagation_backend = fused``.

Tolerances, with their reasons:
* loss terms within rtol LOSS_RTOL = 1e-5: the same float32 operations
  in the same order, but the reductions sum in another order and XLA's
  exp, log, arccos and cos differ from PyTorch's by an ulp (measured:
  within 1.2e-7 relative); SCCF's exp(s²/τ) at τ = 0.1 and LightCCF's
  and LightCSCF's exp(total/τ) at τ = 0.22 and 0.2 turn an ulp of a
  similarity into up to ~10 ulps of a score, still far below 1e-5;
* gradients: under MF within GRAD_MF = 1e-5 of the largest entry (the
  same terms summed in another order; measured 6.4e-6, DirectAU's
  uniformity cancelling most); under LightGCN within GRAD_BF16 = 2**-8
  of the largest entry (measured 2.4e-4): a cotangent entry within a
  float32 ulp of a bfloat16 rounding boundary rounds to the other
  neighbour in one package, one bfloat16 ulp of that entry;
* three Adam steps within 0.25 learn_rate per element and 1e-3
  learn_rate on average, tests/test_torch_training.py's bars (Adam's
  first updates are learn_rate · g/|g|, so only a gradient entry whose
  terms nearly cancel can move by more than round-off; measured at most
  0.011 learn_rate);
* eval embeddings: MF equal (the tables), LightGCN within TIGHT (the
  forward products share their bfloat16 operands; only the order of the
  float32 additions differs);
* served ids equal except among scores within 1e-5 of each other, the
  scores within 1e-5 (tests/test_torch_egcf.py's rule).
"""

from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch import main as t_main
from idgrec_torch.config import Config as TConfig
from idgrec_torch.config import load_model_config as t_load_config
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.models import sccf as t_sccf
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.config import load_model_config as j_load_config
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.engine.trainer import EpochRunner as JRunner
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.models import sccf as j_sccf
from idgrec_tpu.serving import Recommender as JRecommender

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

LOSS_RTOL = 1e-5
GRAD_MF = 1e-5
GRAD_BF16 = 2.0 ** -8
TIGHT = dict(rtol=3e-5, atol=3e-6)
D, LR, B = 32, 0.001, 256
_SHAPE = (200, 300, 3000, 400)
ZOO = ("MFBPR", "DirectAU", "MAWU", "SCCF", "LightCCF", "LightCSCF")
CASES = [("MFBPR", "MF")] + [(m, e) for m in ZOO[1:] for e in ("MF", "LightGCN")]
_OVERRIDES = {"dataset": "tiny", "embedding_size": str(D), "GCN_layer": "2",
              "learn_rate": str(LR), "batch_size": str(B), "test_batch_size": "64",
              "top_K": "[5, 10]", "interval": "1", "training_epochs": "2"}


def _cfg(name, encoder, **extra):
    """The model's published config (the port's copy) at the test's
    sizes, as a plain dict both packages read."""
    cfg = {**t_load_config(name).as_dict(), **_OVERRIDES, **extra}
    if name != "MFBPR":
        cfg["encoder"] = encoder
    return cfg


@pytest.fixture(scope="module")
def datasets():
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=5, name="tiny"),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=5, name="tiny"))


def _models(datasets, name, encoder, seed=7, **extra):
    tdata, jdata = datasets
    cfg = _cfg(name, encoder, **extra)
    # the port's dense route runs K6's function: JAX's fused backend
    jcfg = {**cfg, "propagation_backend": "fused"} if encoder == "LightGCN" else cfg
    jmodel = j_get_model(name)(JConfig(jcfg), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    tmodel = t_get_model(name)(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    return jmodel, tmodel, params, cfg


def _batch(tdata, rng, size=B):
    pick = rng.integers(0, tdata.num_train, size)
    return (tdata.train_user[pick], tdata.train_item[pick], rng.integers(0, tdata.num_items, size))


def _j32(*arrays):
    return tuple(jnp.asarray(a, jnp.int32) for a in arrays)


def _t64(*arrays):
    return tuple(torch.from_numpy(np.asarray(a, np.int64)) for a in arrays)


def _grad_close(got, ref, encoder):
    top = float(np.abs(ref).max())
    assert top > 0
    bar = GRAD_MF if encoder == "MF" else GRAD_BF16
    assert float(np.abs(got - ref).max()) <= bar * top, (float(np.abs(got - ref).max()), top)


def _close_in_lr(got, ref):
    diff = np.abs(got - ref) / LR
    assert diff.max() <= 0.25 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


# ---------------------------------------------------------------------------
# registry, configs, tables


def test_zoo_is_registered():
    assert set(ZOO) <= set(t_available())
    for name in ZOO:
        assert t_get_model(name).model_name == name


@pytest.mark.parametrize("name", ZOO)
def test_config_copy_is_the_jax_file_key_for_key(name):
    assert t_load_config(name).as_dict() == j_load_config(name).as_dict()
    # no compute_dtype of the port's own: the default route, bfloat16 on auto
    assert t_load_config(name).str("compute_dtype") == "bfloat16"
    assert t_load_config(name).str("propagation_backend") == "auto"
    assert (ROOT / "idgrec_torch" / "configure" / f"{name}.txt").read_text() == \
        (ROOT / "idgrec_tpu" / "configure" / f"{name}.txt").read_text()


@pytest.mark.parametrize("name,encoder", CASES)
def test_tables_and_loss_names_match_jax(datasets, name, encoder):
    jmodel, tmodel, params, _ = _models(datasets, name, encoder)
    assert convert.table_names(tmodel) == tuple(sorted(params))
    assert tuple(tmodel.loss_names) == tuple(jmodel.loss_names)
    for k, v in jax.device_get(params).items():
        np.testing.assert_array_equal(getattr(tmodel, k).detach().numpy(), np.asarray(v))
    if encoder == "LightGCN":
        assert isinstance(tmodel.graph, t_prop.DenseSquareAdj)
        assert tmodel.graph.runs_kernel(D) and tmodel.graph.quant == "none"


def test_lightcscf_loss_names_follow_the_encoder(datasets):
    names = {e: t_get_model("LightCSCF")(TConfig(_cfg("LightCSCF", e)), datasets[0],
                                          device="cpu").loss_names for e in ("MF", "LightGCN")}
    assert names == {"MF": ("bpr", "reg", "cscf"), "LightGCN": ("reg", "cscf")}


def test_unknown_encoder_raises_like_jax(datasets):
    cfg = _cfg("DirectAU", "NGCF")
    with pytest.raises(ValueError, match="unknown encoder 'NGCF'"):
        j_get_model("DirectAU")(JConfig(cfg), datasets[1])
    with pytest.raises(ValueError, match="unknown encoder 'NGCF'"):
        t_get_model("DirectAU")(TConfig(cfg), datasets[0], device="cpu")


def test_mawu_draws_four_tables(datasets):
    m = t_get_model("MAWU")(TConfig(_cfg("MAWU", "MF")), datasets[0], device="cpu",
                            generator=torch.Generator().manual_seed(3))
    assert convert.table_names(m) == ("item_emb", "item_margin", "user_emb", "user_margin")
    assert convert.jax_num_leaves(m) == 14
    nu, ni = datasets[0].num_users, datasets[0].num_items
    assert tuple(m.user_margin.shape) == (nu, 1) and tuple(m.item_margin.shape) == (ni, 1)
    limit = float(np.sqrt(6.0 / (D + nu)))
    assert float(m.user_emb.detach().abs().max()) <= limit
    # the margins standard normal, the reference's embedding default
    margins = torch.cat([m.user_margin, m.item_margin]).detach()
    assert abs(float(margins.mean())) < 0.2 and 0.8 < float(margins.std()) < 1.2


@pytest.mark.parametrize("ids", [[3, 3, 3], [5, 1, 5, 2, 1], list(range(17)), [0]])
def test_sccf_count_unique_matches_jax(ids):
    got = t_sccf._count_unique(torch.tensor(ids, dtype=torch.int64))
    assert got.dim() == 0 and int(got) == int(j_sccf._count_unique(jnp.asarray(ids))) \
        == len(set(ids))


# ---------------------------------------------------------------------------
# one step, three Adam steps, evaluation and serving


@pytest.mark.parametrize("name,encoder", CASES)
def test_loss_terms_and_gradients_match_jax(datasets, name, encoder):
    jmodel, tmodel, params, _ = _models(datasets, name, encoder, seed=9)
    u, p, n = _batch(datasets[0], np.random.default_rng(4))
    assert len(np.unique(u)) < B  # the batch repeats users: SCCF's counts see it
    batch = dict(zip(("user", "pos", "neg"), _j32(u, p, n)))

    def j_loss(prm):
        terms, _ = jmodel.loss_terms(prm, {}, (), batch, jax.random.PRNGKey(0), 0)
        return sum(terms), terms

    (_, jterms), ref = jax.value_and_grad(j_loss, has_aux=True)(params)
    terms = tmodel.loss_terms(dict(zip(("user", "pos", "neg"), _t64(u, p, n))))
    assert len(terms) == len(tmodel.loss_names)
    np.testing.assert_allclose([float(t_.detach()) for t_ in terms], np.asarray(jterms),
                               rtol=LOSS_RTOL)
    sum(terms).backward()
    for k in convert.table_names(tmodel):
        _grad_close(getattr(tmodel, k).grad.numpy(), np.asarray(ref[k]), encoder)


def _three_steps(datasets, name, encoder):
    jmodel, tmodel, params, cfg = _models(datasets, name, encoder, seed=8)
    jrun, trun = JRunner(jmodel, LR, B, B), TRunner(tmodel, LR, B, B)
    opt_state, rng = jrun.init_opt_state(params), np.random.default_rng(0)
    for step in range(3):
        u, p, n = _batch(datasets[0], rng)
        params, opt_state, _, jterms = jrun.run_epoch(params, opt_state, {}, (), *_j32(u, p, n),
                                                      jax.random.PRNGKey(1), step)
        tterms = trun.run_epoch(*_t64(u, p, n), epoch=step).numpy()
        assert tterms.shape == (len(tmodel.loss_names),) and np.isfinite(tterms).all()
        np.testing.assert_allclose(tterms, np.asarray(jterms), rtol=LOSS_RTOL * 10 ** step)
        for k, v in jax.device_get(params).items():
            _close_in_lr(getattr(tmodel, k).detach().numpy(), np.asarray(v))
    return jmodel, tmodel, params, cfg


@pytest.mark.parametrize("name,encoder", CASES)
def test_three_adam_steps_evaluate_and_serve_like_jax(datasets, name, encoder):
    """Three steps in both packages, then the eval embeddings and the
    served ids from the JAX weights carried across."""
    jmodel, tmodel, params, cfg = _three_steps(datasets, name, encoder)
    convert.load_jax_params(tmodel, jax.device_get(params))
    ju, ji = jmodel.eval_embeddings(params, {}, (), jax.random.PRNGKey(0))
    tu, ti = tmodel.eval_embeddings()
    got, ref = torch.cat([tu, ti]).numpy(), np.concatenate([np.asarray(ju), np.asarray(ji)])
    if encoder == "MF":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **TIGHT)
    users = np.arange(0, datasets[0].num_users, 7)
    t_items, t_scores = TRecommender(tmodel, datasets[0]).recommend(users, k=10)
    j_items, j_scores = JRecommender(jmodel, params, {}, (), datasets[1]).recommend(users, k=10)
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-5)
    assert ((t_items == j_items) | (np.abs(t_scores - j_scores) <= 1e-5)).all()


def test_mf_eval_embeddings_do_not_move_with_training(datasets):
    _, tmodel, _, _ = _models(datasets, "MFBPR", "MF")
    before = [t_.clone() for t_ in tmodel.eval_embeddings()]
    rec = TRecommender(tmodel, datasets[0])
    TRunner(tmodel, LR, B, B).run_epoch(*_t64(*_batch(datasets[0], np.random.default_rng(1))))
    assert not torch.equal(tmodel.user_emb.detach(), before[0])
    assert all(torch.equal(a, b) for a, b in zip(rec._repr, before))


# ---------------------------------------------------------------------------
# checkpoints, resume, the command line


@pytest.fixture(scope="module")
def jax_mawu_run(datasets, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("jax_mawu"))
    cfg = JConfig(_cfg("MAWU", "LightGCN"))
    res = j_loop.train_model("MAWU", datasets[1], cfg, seed=1, log_dir=None, echo=False,
                             max_epochs=1, checkpoint_dir=ck)
    return ck, res


def test_jax_mawu_checkpoint_loads_into_the_port(datasets, jax_mawu_run):
    ck, res = jax_mawu_run
    cfg = TConfig(_cfg("MAWU", "LightGCN"))
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    model = t_get_model("MAWU")(cfg, datasets[0], device="cpu")
    assert len(leaves) == convert.jax_num_leaves(model) == 14
    runner = TRunner(model, LR, B, datasets[0].num_train)
    meta = convert.load_jax_checkpoint(model, runner.opt, ck)
    assert meta["epoch"] == 1
    jparams = jax.device_get(res.params)
    for k in convert.table_names(model):
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(jparams[k]))
    adam = convert.adam_state_to_numpy(runner.opt, model)
    assert adam["count"] == -(-datasets[0].num_train // B)
    assert set(adam["mu"]) == {"item_emb", "item_margin", "user_emb", "user_margin"}
    rec = TRecommender.from_checkpoint("MAWU", datasets[0], cfg, ck, device="cpu")
    assert torch.equal(rec.model.user_margin, model.user_margin)
    # a two-table model refuses the 14-leaf file: its layout has 8
    other = t_get_model("DirectAU")(TConfig(_cfg("DirectAU", "MF")), datasets[0], device="cpu")
    with pytest.raises(ValueError, match="has 14 leaves.*has 8"):
        convert.load_jax_checkpoint(other, None, ck)


def test_port_resume_equals_straight_run(datasets, tmp_path):
    tdata = datasets[0]
    cfg = TConfig(_cfg("LightCSCF", "LightGCN"))
    kw = dict(seed=3, log_dir=None, echo=False, device="cpu")
    straight = t_loop.train_model("LightCSCF", tdata, cfg, checkpoint_dir=str(tmp_path / "a"),
                                  **kw)
    t_loop.train_model("LightCSCF", tdata, cfg, checkpoint_dir=str(tmp_path / "b"),
                       max_epochs=1, **kw)
    resumed = t_loop.train_model("LightCSCF", tdata, cfg, checkpoint_dir=str(tmp_path / "b"),
                                 **kw)
    for k in ("user_emb", "item_emb"):
        assert torch.equal(straight.params[k], resumed.params[k])
    assert straight.history[-1]["loss"] == resumed.history[-1]["loss"]
    # two terms under LightGCN: "total = reg + cscf"
    assert straight.history[-1]["loss"].count("+") == 1
    np.testing.assert_array_equal(straight.best.recall, resumed.best.recall)


def test_model_flag_reaches_a_zoo_model(datasets, tmp_path):
    directory = tmp_path / "data" / "tiny"
    directory.mkdir(parents=True)
    data = datasets[0]
    for fname, users, items in (("train.txt", data.train_user, data.train_item),
                                ("test.txt", data.test_user, data.test_item)):
        with open(directory / fname, "w") as f:
            for u in np.unique(users):
                f.write(f"{u} " + " ".join(map(str, items[users == u])) + "\n")
    conf = tmp_path / "conf"
    conf.mkdir()
    cfg = {**_cfg("SCCF", "LightGCN"), "dataset_path": str(tmp_path / "data"),
           "training_epochs": "1"}
    (conf / "SCCF.txt").write_text("".join(f"{k} = {v}\n" for k, v in cfg.items()))
    code = t_main.main(["--model", "SCCF", "--configure_dir", str(conf), "--device", "cpu",
                        "--log_dir", str(tmp_path / "log")])
    assert code == 0
    lines = (tmp_path / "log" / "SCCF" / "tiny.log").read_text()
    assert "Run with SCCF on tiny" in lines and "Test recall" in lines
