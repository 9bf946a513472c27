"""One rank of a gloo process group for the port's mesh tests.

    python tests/_torch_mesh_worker.py SUITE RANK WORLD PORT OUTDIR

joins a CPU group of WORLD ranks at localhost:PORT, runs every case of
SUITE (``suite_<SUITE>`` below: a rank imports the port and no JAX) on
the meshes the suite names, and pickles its results to
OUTDIR/rank<RANK>.pkl. Inputs the parent prepared are in
OUTDIR/inputs.pkl. `run_group` starts the ranks and joins them with a
timeout; a rank that fails or a join past the timeout fails the group.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from idgrec_torch.parallel.distributed import free_port  # noqa: E402
JOIN_TIMEOUT = 120.0


class Group:
    """A started group of ranks; `join` waits for all of them."""

    def __init__(self, suite: str, outdir: Path, world: int = 4, inputs=None):
        self.outdir, self.world = Path(outdir), world
        self.outdir.mkdir(parents=True, exist_ok=True)
        with open(self.outdir / "inputs.pkl", "wb") as f:
            pickle.dump(inputs or {}, f)
        port = free_port()
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        self.logs = [open(self.outdir / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, suite, str(r), str(world), str(port), str(self.outdir)],
            stdout=self.logs[r], stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
            for r in range(world)]
        self.started = time.monotonic()

    def join(self, timeout: float = JOIN_TIMEOUT) -> list[dict]:
        """Each rank's results, or AssertionError with the failing rank's
        log when a rank fails or the group outlasts ``timeout`` seconds."""
        deadline = self.started + timeout
        try:
            for r, p in enumerate(self.procs):
                try:
                    code = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"rank {r} did not finish within {timeout} s:\n"
                                         + self._log(r))
                if code != 0:
                    raise AssertionError(f"rank {r} exited with {code}:\n" + self._log(r))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in self.logs:
                f.close()
        out = []
        for r in range(self.world):
            with open(self.outdir / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    def _log(self, r: int) -> str:
        self.logs[r].flush()
        return (self.outdir / f"rank{r}.log").read_text()[-6000:]


def run_group(suite: str, outdir: Path, world: int = 4, inputs=None) -> list[dict]:
    return Group(suite, outdir, world, inputs).join()


# ---------------------------------------------------------------------------
# the suites (run inside a rank; the port only)


def _setup(rank: int, world: int, port: int):
    import torch

    torch.set_num_threads(1)
    from idgrec_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", world, rank, device="cpu")


def suite_spmm_shard(rank: int, inputs: dict) -> dict:
    """The sharded duals and the sharded gather at model widths 2 and 4."""
    import torch

    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.ops import propagate as prop
    from idgrec_torch.parallel import spmm_shard
    from idgrec_torch.parallel.mesh import make_mesh, use_mesh

    data = make_synthetic_dataset(*inputs["shape"], seed=inputs["seed"], name="shardtest")
    x, ct, gate = (torch.from_numpy(inputs[k]) for k in ("x", "ct", "gate"))
    out = {}
    for width, dp in ((2, 2), (4, 1)):
        mesh = make_mesh(data_parallel=dp, device="cpu")
        assert mesh.model == width
        with use_mesh(mesh):
            for name, (variant, backend, dtype, gated) in inputs["cases"].items():
                adj = prop.build_adjacency(data, variant, backend, compute_dtype=dtype,
                                           device="cpu")
                xt = x.clone().requires_grad_(True)
                y = adj.matmul(xt, gate if gated else None)
                (y * ct).sum().backward()
                m = adj.m8 if isinstance(adj, prop.FusedSquareAdj) else adj.m
                out[width, name] = dict(
                    y=y.detach().numpy(), grad=xt.grad.numpy(),
                    m_rows=m.shape[0], m_bytes=m.numel() * m.element_size(),
                    padded=adj.padded_shape, sharded=adj.shard is mesh,
                    chain=prop.supports_chain_t(adj), route=spmm_shard.shard_route(adj, 32))
            for quant in ("int8", "int4"):
                adj = prop.build_adjacency(data, "sym", "fused", compute_dtype=quant,
                                           device="cpu")
                u_pad, i_pad = adj.padded_shape
                qu = torch.from_numpy(inputs["qu"][:u_pad])
                qi = torch.from_numpy(inputs["qi"][:i_pad])
                route = spmm_shard.shard_route(adj, qu.shape[1])
                yu, yi = spmm_shard._sharded(route, torch.float32, mesh, adj.m8, qu, qi)
                r = adj.m8.shape[0]
                k_yu, k_yi = spmm_shard.shard_dual(route, adj.m8,
                                                   qu[mesh.model_index * r:][:r], qi)
                out[width, f"raw_{quant}"] = dict(yu=yu.numpy(), yi=yi.numpy(),
                                                  shard_yu=k_yu.numpy(), shard_yi=k_yi.numpy(),
                                                  rows=r, index=mesh.model_index)
            sq = prop.build_adjacency(data, "sym", "gather", compute_dtype="float32",
                                      device="cpu")
            rect = prop.build_rect_adjacency(data, "gather", compute_dtype="float32",
                                             device="cpu")
            nu = data.num_users
            for name, fn, xin, ctin in (
                    ("gather_square", sq.matmul, x, ct),
                    ("gather_rect", rect.matmul, x[nu:], ct[:nu]),
                    ("gather_rect_t", rect.t_matmul, x[:nu], ct[nu:])):
                xt = xin.clone().requires_grad_(True)
                y = fn(xt)
                (y * ctin).sum().backward()
                out[width, name] = dict(y=y.detach().numpy(), grad=xt.grad.numpy())
    return out


def _t64(*arrays):
    import numpy as np
    import torch

    return tuple(torch.from_numpy(np.asarray(a, np.int64)) for a in arrays)


def _run_summary(res) -> dict:
    return dict(loss=[h["loss"] for h in res.history],
                recall=None if res.best.recall is None else res.best.recall.copy(),
                params={k: v.detach().numpy().copy() for k, v in res.params.items()})


def suite_mesh_training(rank: int, inputs: dict) -> dict:
    """Training, evaluation, serving and checkpoints on a 2x2 mesh."""
    import numpy as np
    import torch

    from idgrec_torch import convert
    from idgrec_torch.config import Config
    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.engine.evaluator import Evaluator
    from idgrec_torch.engine.loop import train_model
    from idgrec_torch.engine.trainer import EpochRunner
    from idgrec_torch.models import get_model
    from idgrec_torch.parallel.mesh import make_mesh, use_mesh
    from idgrec_torch.parallel.topk import item_slice, sharded_topk
    from idgrec_torch.serving import Recommender

    data = make_synthetic_dataset(*inputs["shape"], seed=inputs["seed"], name="tiny")
    mesh = make_mesh(data_parallel=2, device="cpu")
    assert (mesh.data, mesh.model) == (2, 2)
    out = {"rank": rank, "index": (mesh.data_index, mesh.model_index)}

    # a few steps from carried JAX weights on the parent's triples
    for mode, cfg in inputs["step_cfgs"].items():
        with use_mesh(mesh):
            model = get_model("LightGCN")(Config(cfg), data, device="cpu")
        convert.load_jax_params(model, inputs["start"])
        runner = EpochRunner(model, float(cfg["learn_rate"]), int(cfg["batch_size"]),
                             int(cfg["batch_size"]), mesh=mesh)
        steps = []
        for i, (u, p, n) in enumerate(inputs["triples"]):
            terms = runner.run_epoch(*_t64(u, p, n), epoch=i)
            steps.append((terms.numpy().copy(), runner.tables.params_numpy()))
        out["steps", mode] = steps
        adam = runner.opt.state
        out["storage", mode] = {k: (tuple(p.shape), tuple(adam[p]["exp_avg"].shape))
                                for k, p in runner.tables.shards.items()}
        out["sharded", mode] = model.graph.shard is mesh
        out["m_numel", mode] = (model.graph.m8 if hasattr(model.graph, "m8")
                                else model.graph.m).numel()

    # SGL's routes: one step's terms and gradients, and the bytes a rank
    # holds of M and of the views' binary matrix
    u, p, n = _t64(*inputs["triples"][0])
    batch = {"user": u, "pos": p, "neg": n}
    for mode, cfg in inputs["sgl_cfgs"].items():
        with use_mesh(mesh):
            model = get_model("SGL")(Config(cfg), data, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
            model.epoch_context(0, np.random.default_rng(5))
            terms = model.loss_terms(batch)
            sum(terms).backward()
        g = model.graph
        m = g.m8 if hasattr(g, "m8") else g.m
        out["sgl", mode] = dict(
            terms=[float(t.detach()) for t in terms],
            grads={k: getattr(model, k).grad.numpy().copy() for k in ("user_emb", "item_emb")},
            m_bytes=m.numel() * m.element_size(),
            shared_bytes=model._shared.numel() * model._shared.element_size(),
            shared_is_own=model._shared is m,
            views_sharded=all(v.shard is mesh for vs in model.views for v in vs))

    # whole runs on the mesh
    for key, (name, cfg, seed) in inputs["runs"].items():
        out["run", key] = _run_summary(train_model(name, data, config=Config(cfg), seed=seed,
                                                   log_dir=None, echo=False, mesh=mesh,
                                                   device="cpu"))

    # the top-k over sharded items, at model widths 2 and 4
    ratings = torch.from_numpy(inputs["ratings"])
    for dp in (2, 1):
        m = mesh if dp == 2 else make_mesh(data_parallel=1, device="cpu")
        items, width = item_slice(ratings.shape[1], m)  # the rank's slice alone
        vals, idx = sharded_topk(ratings[:, items], items, width, m, inputs["k"])
        out["topk", m.model] = (vals.numpy(), idx.numpy())

    # evaluation and serving from carried weights
    cfg = Config(inputs["eval_cfg"])
    with use_mesh(mesh):
        model = get_model("LightGCN")(cfg, data, device="cpu")
    convert.load_jax_params(model, inputs["start"])
    out["eval"] = Evaluator(model, data, cfg, mesh=mesh).evaluate()
    users = inputs["users"]
    out["serve"] = Recommender(model, data, mesh=mesh).recommend(users, k=10)

    # a checkpoint written on the mesh, then served from it on the mesh
    ck = os.path.join(inputs["dir"], "ck_mesh")
    res = train_model("LightGCN", data, config=cfg.updated(training_epochs=2), seed=3,
                      log_dir=None, echo=False, mesh=mesh, device="cpu", checkpoint_dir=ck)
    out["ck_mesh"] = _run_summary(res)
    out["ck_mesh_serve"] = Recommender.from_checkpoint("LightGCN", data, cfg, ck, device="cpu",
                                                       mesh=mesh).recommend(users, k=10)
    # a checkpoint written on one process, resumed on the mesh
    res = train_model("LightGCN", data, config=cfg.updated(training_epochs=3), seed=3,
                      log_dir=None, echo=False, mesh=mesh, device="cpu",
                      checkpoint_dir=inputs["ck_single"])
    out["ck_resume"] = _run_summary(res)

    # from carried JAX weights, steps of models whose loss couples the
    # batch's rows
    for name, (cfg, start) in inputs["jax_parity"].items():
        with use_mesh(mesh):
            model = get_model(name)(Config(cfg), data, device="cpu")
        convert.load_jax_params(model, start)
        runner = EpochRunner(model, float(cfg["learn_rate"]), int(cfg["batch_size"]),
                             int(cfg["batch_size"]), mesh=mesh)
        out["jax_parity", name] = [
            (runner.run_epoch(*_t64(u, p, n), epoch=i).numpy().copy(),
             runner.tables.params_numpy()) for i, (u, p, n) in enumerate(inputs["triples"])]

    # one step of every zoo model, and the rows each loss function receives
    rows = []
    record_loss_rows(rows)
    for name, cfg in inputs["zoo_steps"].items():
        with use_mesh(mesh):
            model = get_model(name)(Config(cfg), data, device="cpu")
        runner = EpochRunner(model, float(cfg["learn_rate"]), int(cfg["batch_size"]),
                             int(cfg["batch_size"]), mesh=mesh)
        (u, p, n), epoch, gen = step_inputs(name, model, inputs["triples"][0])
        del rows[:]
        terms = runner.run_epoch(u, p, n, generator=gen, epoch=epoch)
        out["zoo_step", name] = dict(terms=terms.numpy().copy(), grads=_whole_grads(runner),
                                     rows=list(rows))
    return out


def _whole_grads(runner) -> dict:
    """The step's gradient of every table at its true shape (a collective
    over the model axis), None for a table without one."""
    tables, out = runner.tables, {}
    for k, p in zip(tables.names, tables.parameters()):
        if p.grad is None:
            out[k] = None
        elif k in tables.shards:
            out[k] = tables._whole(k, p.grad)
        else:
            out[k] = p.grad.detach().numpy().copy()
    return out


# the loss functions whose first argument holds a batch's rows, by module
LOSS_FUNCTIONS = {
    "idgrec_torch.ops.losses": (
        "bpr_loss", "align_loss", "uniform_loss", "neighbor_aggregate_loss", "lightcscf_loss",
        "margin_alignment_loss", "dot_uniformity_loss", "infonce_loss", "infonce_loss_all",
        "infonce_loss_sum", "lightgcl_ssl_loss", "elbo_loss", "batch_mean"),
    "idgrec_torch.models.simgcl": ("masked_infonce_loss",),
    "idgrec_torch.models.xsimgcl": ("masked_infonce_loss",),
    "idgrec_torch.models.sccf": ("batch_mean",),
    "idgrec_torch.models.recdcl": ("batch_mean", "batch_norm"),
}
# the L2 terms, by the position of their first index argument
REG_FUNCTIONS = {"reg_loss_indexed": 2, "reg_loss_counted": 1}


def record_loss_rows(log: list) -> None:
    """Wrap every loss function of `LOSS_FUNCTIONS` and `REG_FUNCTIONS`
    where the models look it up, so that each call appends (name, the
    rows of its batch argument) to ``log``."""
    import importlib

    def wrap(fn, name, arg):
        def recorded(*a, **k):
            log.append((name, int(a[arg].shape[0])))
            return fn(*a, **k)
        return recorded

    for module, names in LOSS_FUNCTIONS.items():
        mod = importlib.import_module(module)
        for name in names:
            setattr(mod, name, wrap(getattr(mod, name), name, 0))
    losses = importlib.import_module("idgrec_torch.ops.losses")
    for name, arg in REG_FUNCTIONS.items():
        setattr(losses, name, wrap(getattr(losses, name), name, arg))


def saved_shapes(fn):
    """``fn()``'s result and the shapes of the float tensors autograd
    saved for the backward while it ran."""
    import torch

    shapes = []

    def pack(t):
        if t.is_floating_point():
            shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes


def propagation_cotangents(model) -> dict:
    """Hook LightGCN's ``propagate``: the returned dict receives the
    cotangents of the propagated user and item tables in the backward."""
    cot, prop = {}, model.propagate

    def hooked():
        ua, ia = prop()
        ua.register_hook(lambda g: cot.__setitem__("user_emb", g.detach().clone()))
        ia.register_hook(lambda g: cot.__setitem__("item_emb", g.detach().clone()))
        return ua, ia

    model.propagate = hooked
    return cot


def step_inputs(name: str, model, triple, epoch_seed: int = 3):
    """One step's inputs for a zoo model: the epoch context it needs (NCL
    past its warm-up, SGL's views), the triple as int64 tensors, the
    epoch and the step's generator."""
    import numpy as np
    import torch

    epoch = model.warmup_epochs if name == "NCL" else 0
    model.epoch_context(epoch, np.random.default_rng(epoch_seed))
    return _t64(*triple), epoch, torch.Generator().manual_seed(11)


def suite_data_axis(rank: int, inputs: dict) -> dict:
    """A (2, 1) mesh: LightGCN's step in int8, int4 and dense bfloat16, the
    cotangent entering its propagation, the rows each loss function
    receives, and CGCL's kept scores."""
    import torch

    from idgrec_torch.config import Config
    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.engine.trainer import EpochRunner
    from idgrec_torch.models import get_model
    from idgrec_torch.parallel.mesh import make_mesh, use_mesh

    data = make_synthetic_dataset(*inputs["shape"], seed=inputs["seed"], name="tiny")
    mesh = make_mesh(data_parallel=2, device="cpu")
    assert (mesh.data, mesh.model) == (2, 1)
    rows = []
    record_loss_rows(rows)
    out = {"index": mesh.data_index}
    for key, (name, cfg) in inputs["cases"].items():
        with use_mesh(mesh):
            model = get_model(name)(Config(cfg), data, device="cpu")
        cot = propagation_cotangents(model) if name == "LightGCN" else {}
        runner = EpochRunner(model, float(cfg["learn_rate"]), int(cfg["batch_size"]),
                             int(cfg["batch_size"]), mesh=mesh)
        (u, p, n), epoch, gen = step_inputs(name, model, inputs["triple"])
        del rows[:]
        terms, shapes = saved_shapes(lambda: runner.run_epoch(u, p, n, generator=gen,
                                                              epoch=epoch))
        out[key] = dict(terms=terms.numpy().copy(), grads=_whole_grads(runner),
                        params=runner.tables.params_numpy(), rows=list(rows), saved=shapes,
                        cot={k: v.numpy() for k, v in cot.items()})
    return out


def main(argv) -> int:
    suite, rank, world, port, outdir = argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5]
    sys.path.insert(0, str(ROOT))
    _setup(rank, world, port)
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    result = globals()[f"suite_{suite}"](rank, inputs)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    from idgrec_torch.parallel import distributed

    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
