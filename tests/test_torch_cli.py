"""The port's command lines (`idgrec_torch.main`, `idgrec_torch.serve`,
``scripts/torch_bench.py``) in process, on the CPU, on a dataset written
to a temporary directory; exit codes and messages as the JAX package's
CLIs give them."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from idgrec_torch import main as t_main
from idgrec_torch import serve as t_serve
from idgrec_torch.data.dataset import Dataset, make_synthetic_dataset
from idgrec_tpu import main as j_main
from idgrec_tpu import serve as j_serve

# The shapes are tiny and the test workers share the cores: intra-op
# threads would only contend with each other.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_CONFIG = """dataset_path = {root}
dataset = tiny
top_K = [5, 10]
training_epochs = 3
early_stopping = 10
interval = 2
embedding_size = 16
batch_size = 256
test_batch_size = 64
learn_rate = 0.01
reg_lambda = 0.0001
GCN_layer = 2
sparsity_test = 0
compute_dtype = {dtype}
"""


def _write_dataset(directory, data):
    os.makedirs(directory, exist_ok=True)
    for name, users, items in (("train.txt", data.train_user, data.train_item),
                               ("test.txt", data.test_user, data.test_item)):
        with open(os.path.join(directory, name), "w") as f:
            for u in np.unique(users):
                f.write(f"{u} " + " ".join(map(str, items[users == u])) + "\n")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A dataset, a configure directory, and one trained run with
    checkpoints (through `main.main`)."""
    tmp = tmp_path_factory.mktemp("cli")
    data = make_synthetic_dataset(200, 300, 3000, 400, seed=4, name="tiny")
    _write_dataset(str(tmp / "data" / "tiny"), data)
    for dtype in ("int8", "int4"):
        conf = tmp / f"conf_{dtype}"
        conf.mkdir()
        (conf / "LightGCN.txt").write_text(_CONFIG.format(root=tmp / "data", dtype=dtype))
    common = ["--model", "LightGCN", "--configure_dir", str(tmp / "conf_int4"), "--device", "cpu"]
    code = t_main.main(common + ["--log_dir", str(tmp / "log"), "--checkpoint_dir",
                                 str(tmp / "ck"), "--seed", "7"])
    return dict(tmp=tmp, data=data, common=common, code=code)


def test_dataset_written_is_the_dataset_loaded(workdir):
    loaded = Dataset.load(str(workdir["tmp"] / "data" / "tiny"), name="tiny")
    assert (loaded.num_users, loaded.num_items, loaded.num_train) == (200, 300, 3000)
    np.testing.assert_array_equal(loaded.col_idx, workdir["data"].col_idx)


def test_main_trains_logs_and_checkpoints(workdir, capsys):
    assert workdir["code"] == 0
    tmp = workdir["tmp"]
    assert sorted(os.listdir(tmp / "log" / "LightGCN")) == ["tiny.jsonl", "tiny.log"]
    assert sorted(os.listdir(tmp / "ck")) == ["ckpt_1.json", "ckpt_1.npz", "ckpt_3.json",
                                              "ckpt_3.npz"]
    text = (tmp / "log" / "LightGCN" / "tiny.log").read_text()
    assert "compute_dtype : int4" in text and "Epoch:    3 | Test recall" in text
    # a second call resumes from the latest checkpoint and has nothing left to train
    assert t_main.main(workdir["common"] + ["--log_dir", str(tmp / "log2"), "--checkpoint_dir",
                                            str(tmp / "ck")]) == 0
    out = capsys.readouterr().out
    assert "Resumed from checkpoint at epoch 3" in out and "Best epoch:" in out
    assert "Training time" not in out


def test_main_overrides(workdir, capsys):
    tmp = workdir["tmp"]
    code = t_main.main(["--model", "LightGCN", "--configure_dir", str(tmp / "conf_int8"),
                        "--device", "cpu", "--epochs", "1", "--log_dir", str(tmp / "log3"),
                        "--dataset", "tiny", "--dataset_path", str(tmp / "data"), "--mesh", "off"])
    out = capsys.readouterr().out
    assert code == 0 and "training_epochs : 1" in out and "compute_dtype : int8" in out
    assert out.count("Training time") == 1


def test_model_menu_without_a_terminal_exits_2(monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin.isatty", lambda: False, raising=False)
    assert t_main.main([]) == 2
    out = capsys.readouterr().out
    assert "Available models:" in out and "\t 1. BIGCF" in out and "\t 5. EGCF" in out
    assert "\t 2. CGCL" in out and "\t 8. HCCF" in out and "\t 9. IMPGCN" in out
    assert "\t 13. LightGCN" in out and "\t 14. LightGCN_pp" in out and "\t 19. NCL" in out
    assert "\t 22. SCCF" in out and "\t 24. XSimGCL" in out
    assert "\t 6. GCCF" in out and "\t 7. GCMC" in out and "\t 15. LightGODE" in out
    assert "\t 20. NGCF" in out and "\t 21. RecDCL" in out
    assert "\t 3. CVGA" in out and "\t 12. LightGCL" in out
    assert "error: pass --model=<NAME> (no interactive terminal)" in out


def test_flags_are_the_jax_clis_plus_device():
    def names(module, argv):
        return set(vars(module.parse_args(argv)))

    serve_argv = ["--model", "m", "--checkpoint_dir", "c", "--users", "1"]
    assert names(t_main, []) == names(j_main, []) | {"device"}
    assert names(t_serve, serve_argv) == names(j_serve, serve_argv) | {"device"}
    assert vars(t_main.parse_args([]))["device"] is None  # the card unless asked otherwise


def test_main_unknown_model_and_many_cards(workdir, monkeypatch):
    with pytest.raises(FileNotFoundError, match="NoSuchModel.txt"):
        t_main.main(["--model", "NoSuchModel", "--device", "cpu"])
    # --mesh auto with several visible cards is the sharded path: not ported
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    argv = ["--model", "LightGCN", "--configure_dir", str(workdir["tmp"] / "conf_int8")]
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        t_main.main(argv)


def _serve(workdir, *extra, users="1,17,42"):
    return t_serve.main(["--model", "LightGCN", "--configure_dir",
                         str(workdir["tmp"] / "conf_int4"), "--device", "cpu", "--checkpoint_dir",
                         str(workdir["tmp"] / "ck"), "--users", users, *extra])


def test_serve_prints_one_json_line_per_user(workdir, capsys):
    assert _serve(workdir, "-k", "5") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines]
    assert [r["user"] for r in rows] == [1, 17, 42]
    data = workdir["data"]
    for r in rows:
        assert len(r["items"]) == len(r["scores"]) == 5 and len(set(r["items"])) == 5
        assert r["scores"] == sorted(r["scores"], reverse=True)
        assert not set(r["items"]) & set(data.positive_items(r["user"]).tolist())
    # an earlier epoch and unfiltered serving are other answers
    assert _serve(workdir, "-k", "5", "--epoch", "1", "--include_seen") == 0
    other = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["scores"] for r in other] != [r["scores"] for r in rows]


@pytest.mark.parametrize("case,message", [
    ("empty_users", "error: --users is empty"),
    ("bad_users", "error: --users must be comma-separated integers"),
    ("missing_checkpoint", "error: no checkpoints under"),
    # the id keeps the name this case had while LightGCN was the only model
    pytest.param("unknown_model", "error: unknown model 'Nope'; available: BIGCF, CGCL, "
                 "CVGA, DirectAU, EGCF, GCCF, GCMC, HCCF, IMPGCN, LightCCF, LightCSCF, "
                 "LightGCL, LightGCN, LightGCN_pp, LightGODE, MAWU, MFBPR, MixRec, NCL, NGCF, "
                 "RecDCL, SCCF, SimGCL, XSimGCL",
                 id="unknown_model-error: unknown model 'Nope'; available: LightGCN"),
    ("user_out_of_range", "error: user id out of range"),
    ("k_too_large", "error: k must be in [1, num_items=300]"),
    ("approx", "error: topk_mode='approx'"),
])
def test_serve_error_exits(workdir, capsys, case, message):
    tmp = workdir["tmp"]
    if case == "empty_users":
        code = _serve(workdir, users=" , ")
    elif case == "bad_users":
        code = _serve(workdir, users="1,x")
    elif case == "missing_checkpoint":
        code = t_serve.main(["--model", "LightGCN", "--configure_dir", str(tmp / "conf_int4"),
                             "--device", "cpu", "--checkpoint_dir", str(tmp / "nothing"),
                             "--users", "1"])
    elif case == "unknown_model":
        code = t_serve.main(["--model", "Nope", "--checkpoint_dir", "x", "--users", "1"])
    elif case == "user_out_of_range":
        code = _serve(workdir, users="1,200")
    elif case == "k_too_large":
        code = _serve(workdir, "-k", "301")
    else:
        code = _serve(workdir, "--topk_mode", "approx")
    captured = capsys.readouterr()
    assert code == 2 and captured.out == ""
    assert message in captured.err


def _load_bench():
    spec = importlib.util.spec_from_file_location("torch_bench", ROOT / "scripts" / "torch_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_script_quick_on_the_cpu(capsys):
    """`--compute_dtype best`: both candidates' trial epochs, the chosen
    mode, one timed epoch, two eval sweeps, the one-line JSON last. A
    large batch, a narrow width and two layers keep the smoke run short
    (4 steps per epoch)."""
    bench = _load_bench()
    assert bench.main(["--quick", "--device", "cpu", "--epochs", "1", "--batch_size", "16384",
                       "--emb", "16", "--layers", "2"]) == 0
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    last = json.loads(out[-1])
    assert set(last) == {"metric", "value", "unit"}
    assert last["metric"] == "lightgcn_yelp2018scale_train_pairs_per_sec"
    assert last["unit"] == "pairs/s" and last["value"] > 0
    assert out[0] == out[-2] == "device: cpu"
    err = captured.err
    for mode in ("int8", "int4"):
        assert f"mode {mode}: warmup epoch" in err and f"mode {mode}: trial epoch" in err
    assert "chosen mode: int" in err and err.count("eval sweep") == 2
    # the two modes train the same model: equal loss terms after the warm-up epoch
    terms = [line.split("loss terms ")[1] for line in err.splitlines() if "loss terms" in line]
    assert len(terms) == 2 and terms[0] == terms[1]


@pytest.mark.parametrize("argv", [["--compute_dtype", "float16"], ["--scale", "ml-1m"]])
def test_bench_script_refuses_unknown_choices(argv):
    with pytest.raises(SystemExit) as err:
        _load_bench().main(argv)
    assert err.value.code == 2


@pytest.mark.parametrize("backend,dtype", [("dense", "bfloat16"), ("gather", "bfloat16"),
                                           ("fused", "float32")])
def test_main_trains_in_the_exact_modes(workdir, capsys, backend, dtype):
    tmp = workdir["tmp"]
    conf = tmp / f"conf_{backend}_{dtype}"
    conf.mkdir()
    (conf / "LightGCN.txt").write_text(_CONFIG.format(root=tmp / "data", dtype=dtype)
                                       + f"propagation_backend = {backend}\n")
    code = t_main.main(["--model", "LightGCN", "--configure_dir", str(conf), "--device", "cpu",
                        "--log_dir", str(tmp / f"log_{backend}"), "--checkpoint_dir",
                        str(tmp / f"ck_{backend}")])
    out = capsys.readouterr().out
    assert code == 0 and f"compute_dtype : {dtype}" in out
    assert f"propagation_backend : {backend}" in out and "Best epoch:" in out
    losses = [float(line.split("training loss: ")[1].split(" = ")[0])
              for line in out.splitlines() if "training loss" in line]
    assert len(losses) == 3 and losses[-1] < losses[0]
    # what was trained is served from its checkpoint
    assert t_serve.main(["--model", "LightGCN", "--configure_dir", str(conf), "--device", "cpu",
                         "--checkpoint_dir", str(tmp / f"ck_{backend}"), "--users", "1,17"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["user"] for r in rows] == [1, 17] and all(len(r["items"]) == 10 for r in rows)


@pytest.mark.parametrize("backend,dtype", [("fused", "bfloat16"), ("gather", "float32"),
                                           ("auto", "bfloat16")])
def test_bench_script_times_an_exact_mode(capsys, backend, dtype):
    bench = _load_bench()
    assert bench.main(["--quick", "--device", "cpu", "--epochs", "1", "--batch_size", "16384",
                       "--emb", "16", "--layers", "2", "--compute_dtype", dtype,
                       "--backend", backend]) == 0
    captured = capsys.readouterr()
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert last["metric"] == "lightgcn_yelp2018scale_train_pairs_per_sec" and last["value"] > 0
    assert f"mode {dtype}: warmup epoch" in captured.err and "trial epoch" not in captured.err
    assert captured.err.count("eval sweep") == 2


@pytest.mark.parametrize("name", ["NGCF", "RecDCL", "LightGCL", "CVGA"])
def test_main_trains_and_serve_serves_a_model_of_this_round(workdir, capsys, name):
    """NGCF (per-layer weight tables, message dropout drawn from the run's
    generator), RecDCL (target histories carried by its steps and
    checkpoints), LightGCL (its SVD taken when the model is built) and
    CVGA (user-row epochs, its dict representation served) through both
    command lines, from their config files at d = 16."""
    from idgrec_torch.config import load_model_config

    tmp = workdir["tmp"]
    conf = tmp / f"conf_{name}"
    conf.mkdir()
    cfg = {**load_model_config(name).as_dict(), "dataset_path": str(tmp / "data"),
           "dataset": "tiny", "top_K": "[5, 10]", "training_epochs": "2", "interval": "1",
           "embedding_size": "16", "layer_size": "[16, 16, 16]", "GCN_layer": "2",
           "batch_size": "256", "test_batch_size": "64"}
    (conf / f"{name}.txt").write_text("".join(f"{k} = {v}\n" for k, v in cfg.items()))
    ck = tmp / f"ck_{name}"
    code = t_main.main(["--model", name, "--configure_dir", str(conf), "--device", "cpu",
                        "--log_dir", str(tmp / f"log_{name}"), "--checkpoint_dir", str(ck)])
    out = capsys.readouterr().out
    assert code == 0 and f"Run with {name} on tiny" in out and "Best epoch:" in out
    assert out.count("training loss") == 2
    assert t_serve.main(["--model", name, "--configure_dir", str(conf), "--device", "cpu",
                         "--checkpoint_dir", str(ck), "--users", "1,17,42", "-k", "5"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["user"] for r in rows] == [1, 17, 42] and all(len(r["items"]) == 5 for r in rows)
