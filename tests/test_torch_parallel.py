"""The port's mesh layer (idgrec_torch/parallel/) against the JAX
package's on the CPU: the mesh shapes of `make_mesh` for 1-8 devices
with their warnings and errors, the padded-storage metas, the placement
rule, the process-group state machine, the indivisible batch, and
``main --mesh auto`` under a launch of 2 gloo ranks (this file's one
process group, joined with a 120 s timeout)."""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_mesh_worker import JOIN_TIMEOUT, ROOT
from idgrec_torch.config import Config as TConfig
from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.parallel import distributed as t_dist
from idgrec_torch.parallel import mesh as t_mesh
from idgrec_torch.parallel import padding as t_padding
from idgrec_tpu.parallel import padding as j_padding
from idgrec_tpu.parallel.mesh import make_mesh as j_make_mesh
from idgrec_tpu.parallel.mesh import param_shardings as j_param_shardings
from test_torch_cli import _CONFIG, _write_dataset

_GRID = [(n, dp) for n in range(1, 9) for dp in (None, 1, 2, 3, 4, 8)]


def _outcome(fn, caplog):
    caplog.clear()
    try:
        result = fn()
    except ValueError as e:
        result = ("ValueError", str(e))
    warnings = [r.getMessage() for r in caplog.records if r.levelno >= logging.WARNING]
    return result, warnings


@pytest.mark.parametrize("n,dp", _GRID)
def test_mesh_shape_is_jax_make_mesh(caplog, n, dp):
    """The same (data, model) shape, the same warnings and the same errors
    as the JAX package's `make_mesh` on n of the session's CPU devices."""
    caplog.set_level(logging.WARNING)

    def jax_shape():
        m = j_make_mesh(n, data_parallel=dp)
        return (m.shape["data"], m.shape["model"])

    assert _outcome(lambda: t_mesh.mesh_shape(n, dp), caplog) == _outcome(jax_shape, caplog)


def test_make_mesh_without_a_group_is_one_rank():
    assert not dist.is_initialized()
    mesh = t_mesh.make_mesh(device="cpu")
    assert (mesh.data, mesh.model, mesh.rank, mesh.size) == (1, 1, 0, 1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None
    with pytest.raises(ValueError, match="needs 4 ranks"):
        t_mesh.make_mesh(4, device="cpu")


def test_use_mesh_binds_and_restores():
    a, b = t_mesh.Mesh(1, 1), t_mesh.Mesh(2, 1)
    assert t_mesh.get_active_mesh() is None
    with t_mesh.use_mesh(a):
        with t_mesh.use_mesh(b):
            assert t_mesh.get_active_mesh() is b
        assert t_mesh.get_active_mesh() is a
    assert t_mesh.get_active_mesh() is None


def _tree(rng):
    return {"user_emb": rng.normal(size=(31668, 4)).astype(np.float32),
            "item_emb": rng.normal(size=(38048, 4)).astype(np.float32),
            "state": {"hist": rng.normal(size=(67, 4)).astype(np.float32),
                      "W": rng.normal(size=(16, 8)).astype(np.float32)},
            "small": np.zeros((7, 8), np.float32), "bias": np.zeros((4,), np.float32),
            "aligned": np.zeros((256, 4), np.float32)}


@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("node_rows", [None, {31668, 38048, 31668 + 38048}])
def test_padding_meta_is_jax(width, node_rows):
    tree = _tree(np.random.default_rng(5))
    jtree = jax.tree.map(jnp.asarray, tree)
    tmeta = t_padding.build_meta(tree, width, node_rows)
    jmeta = j_padding.build_meta(jtree, width, node_rows)
    assert tmeta == jax.tree.map(int, jmeta)
    padded = t_padding.pad_tree(tree, tmeta)
    jpadded = j_padding.pad_tree(jtree, jmeta)
    for t, j in zip(jax.tree.leaves(padded), jax.tree.leaves(jpadded)):
        np.testing.assert_array_equal(t, np.asarray(j))
    back = t_padding.unpad_tree(padded, tmeta)
    for t, j in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(t, j)
    # tensors pad as arrays do
    tpad = t_padding.pad_tree({k: torch.from_numpy(v) for k, v in tree.items()
                               if k != "state"}, {k: v for k, v in tmeta.items() if k != "state"})
    assert tpad["user_emb"].shape == (31744 if tmeta["user_emb"] != -1 else 31668, 4)


def test_padded_yelp_tables_shard_on_eight():
    meta = t_padding.build_meta({"u": np.zeros((31668, 4)), "i": np.zeros((38048, 4))}, 8)
    padded = t_padding.pad_tree({"u": np.zeros((31668, 4)), "i": np.zeros((38048, 4))}, meta)
    assert padded["u"].shape == (31744, 4) and padded["i"].shape == (38144, 4)
    assert t_mesh.placement(padded["u"], 8) == t_mesh.placement(padded["i"], 8) == t_mesh.ROWS


@pytest.mark.parametrize("width,dp", [(4, 2), (2, 4), (8, 1)])
def test_placement_is_jax_param_shardings(width, dp):
    jmesh = j_make_mesh(8, data_parallel=dp)
    assert jmesh.shape["model"] == width
    leaves = {"divisible": (16, 8), "indivisible": (17, 8), "too_small": (7, 8),
              "vector": (16,), "edges": (1 << 20,), "odd_edges": ((1 << 20) + 1,),
              "table": (31744, 4)}
    shard = j_param_shardings({k: jax.ShapeDtypeStruct(v, jnp.float32)
                               for k, v in leaves.items()}, jmesh)
    for k, shape in leaves.items():
        spec = tuple(shard[k].spec)
        jax_place = (t_mesh.ROWS if spec == ("model", None) else
                     t_mesh.EDGES if spec == ("model",) else t_mesh.REPLICATED)
        assert t_mesh.placement(torch.empty(shape, device="meta"), width) == jax_place, k


def test_initialize_state_machine(monkeypatch):
    """tests/test_parallel.py's state machine: a bare call without a cluster
    environment stays single-process once (no join attempted), an
    explicit join after that is still attempted, a failed join raises,
    and a joined group makes every later call a no-op."""
    calls = []

    def fake_init(backend, init_method=None, world_size=None, rank=None, timeout=None):
        calls.append((backend, init_method, world_size, rank))
        if init_method == "tcp://bad:1":
            raise RuntimeError("Barrier timed out")

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(t_dist, "_initialized", None)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)

    t_dist.initialize(device="cpu")  # no cluster environment -> local
    t_dist.initialize(device="cpu")  # local + autodetect -> cached no-op
    assert calls == [] and t_dist._initialized == "local"
    assert t_dist.process_count() == 1 and t_dist.is_primary()

    with pytest.raises(RuntimeError, match="Barrier"):
        t_dist.initialize("bad:1", 2, 0, device="cpu")  # explicit failure raises
    assert calls == [("gloo", "tcp://bad:1", 2, 0)]

    t_dist.initialize("good:1", 2, 0, device="cpu")  # explicit join after local
    t_dist.initialize("good:1", 2, 0, device="cpu")  # cluster -> no-op
    t_dist.initialize(device="cpu")  # cluster -> no-op
    assert calls == [("gloo", "tcp://bad:1", 2, 0), ("gloo", "tcp://good:1", 2, 0)]

    # a launcher's environment found, and its join failing, raises
    monkeypatch.setattr(t_dist, "_initialized", None)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "bad")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="Barrier"):
        t_dist.initialize(device="cpu")
    assert calls[-1] == ("gloo", "tcp://bad:1", 2, 1)
    # an explicit call that names too little raises
    monkeypatch.setattr(t_dist, "_initialized", None)
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="coordinator"):
        t_dist.initialize(num_processes=2, device="cpu")
    monkeypatch.setattr(t_dist, "_initialized", None)


def test_epoch_runner_rejects_an_indivisible_batch():
    data = t_make(64, 64, 512, 64, seed=3, name="tiny")
    cfg = TConfig({"dataset": "tiny", "embedding_size": "16", "GCN_layer": "2",
                   "reg_lambda": "0.0001", "top_K": "[5]"})
    model = t_get_model("LightGCN")(cfg, data, device="cpu")
    with pytest.raises(ValueError, match="data axis"):
        TRunner(model, 0.01, 65, data.num_train, mesh=t_mesh.Mesh(2, 2))
    assert dict(model.named_parameters())  # nothing was sharded


def test_main_mesh_auto_under_a_two_rank_launch(tmp_path):
    """``python -m idgrec_torch.main --mesh auto --device cpu`` as two ranks
    of a launcher's environment: both join one gloo group, train on a 1x2
    mesh and exit 0; rank 0 alone logs and checkpoints."""
    data = t_make(67, 83, 1024, 128, seed=21, name="tiny")
    _write_dataset(str(tmp_path / "data" / "tiny"), data)
    conf = tmp_path / "conf"
    conf.mkdir()
    (conf / "LightGCN.txt").write_text(_CONFIG.format(root=tmp_path / "data", dtype="int8")
                                       .replace("batch_size = 256", "batch_size = 64"))
    port = str(t_dist.free_port())
    argv = [sys.executable, "-m", "idgrec_torch.main", "--model", "LightGCN", "--configure_dir",
            str(conf), "--device", "cpu", "--mesh", "auto", "--epochs", "2", "--log_dir",
            str(tmp_path / "log"), "--checkpoint_dir", str(tmp_path / "ck")]
    procs, logs = [], []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1", "RANK": str(rank),
               "LOCAL_RANK": str(rank), "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
               "MASTER_PORT": port}
        logs.append(open(tmp_path / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(argv, stdout=logs[rank], stderr=subprocess.STDOUT,
                                      env=env, cwd=str(ROOT)))
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        codes = [p.wait(timeout=max(deadline - time.monotonic(), 0.1)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    out = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    assert codes == [0, 0], out
    assert "mesh 1x2 (data x model), rank 0" in out[0] and "Best epoch:" in out[0]
    assert "rank 1" in out[1] and "Best epoch:" not in out[1]
    assert sorted(os.listdir(tmp_path / "log" / "LightGCN")) == ["tiny.jsonl", "tiny.log"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_1.json", "ckpt_1.npz"]
