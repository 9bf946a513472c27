"""The universal training loop (counterpart of idgrec_tpu/engine/loop.py).

Orchestrates: per-epoch sampling on the device -> the epoch's steps ->
interval evaluation -> early stopping -> logging and checkpoints, with
the observable behaviour of the JAX package's ``train_model``: the same
config echo, log lines and JSONL events, the same normalization of the
logged losses, the same checkpoint cadence, and resume equal to a
straight run.

A model's state (`RecModel.init_state`, drawn after the tables) lives
in the model, changes with its steps, goes into every checkpoint and is
restored on resume, and comes back in `TrainResult.state`.

An epoch is the negative sampler's (user, pos, neg) triples, or, for a
model whose ``batching`` is ``"user_rows"`` (CVGA), a shuffled
permutation of the user ids fed as all three (`noise.permutation`), with
no sampler.

Random state is explicit: a host `torch.Generator` (the initial tables
and state) and one on the run's device (sampling or the user
permutation, whatever a model's loss draws, and whatever its evaluation
draws: the JAX loop's ``eval_key``), both seeded from ``seed``, plus a
numpy generator handed to `RecModel.epoch_context`. The global
generators are never used. The streams are PyTorch's, so the two
packages draw different triples from the same seed: runs are compared
by behaviour, not by value.

On a mesh (``mesh=``, parallel/mesh.py; one process a card, every rank
calling `train_model` alike) the model is built under the mesh, so its
square adjacency holds this rank's rows of M; the runner stores the
tables row-sharded (`trainer.ShardedTables`); every rank draws the same
triples and views, takes the same early-stopping decision from the same
metrics, and joins the gathers of each checkpoint, which the primary
rank alone writes, as it alone writes the logs. A checkpoint holds the
tables at their true shapes, so one written on a mesh loads on one card
and the reverse.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config, load_model_config
from idgrec_torch.data.dataset import Dataset
from idgrec_torch.device import resolve_device
from idgrec_torch.engine import checkpoint as ckpt
from idgrec_torch.engine.evaluator import BestResults, Evaluator
from idgrec_torch.engine.logging_utils import RunLogger, loss_string
from idgrec_torch.engine.profiling import ThroughputMeter, debug_options, maybe_trace
from idgrec_torch.engine.sampler import NegativeSampler
from idgrec_torch.engine.trainer import EpochRunner
from idgrec_torch.models import get_model
from idgrec_torch.models.base import RecModel
from idgrec_torch.ops import noise
from idgrec_torch.parallel import distributed
from idgrec_torch.parallel.mesh import barrier, use_mesh


@dataclass
class TrainResult:
    params: dict[str, torch.Tensor]  # the model's trained tables by name, on the run's device
    state: dict[str, torch.Tensor]   # the model's state by name (RecDCL's histories), or {}
    best: BestResults
    history: list[dict] = field(default_factory=list)
    last_result: dict | None = None
    # mesh runs only: the as-trained storage, this rank's padded rows of
    # each sharded table (trainer.ShardedTables); ``params`` above are
    # the tables at their true shapes
    sharded_params: dict[str, torch.Tensor] | None = None


def training_state_tree(model: RecModel, optimizer: torch.optim.Adam,
                        host_gen: torch.Generator, dev_gen: torch.Generator,
                        tables=None) -> dict:
    """The checkpoint tree of a run (layout in engine/checkpoint.py), as
    numpy arrays on the host. With ``tables`` (a mesh run's
    `trainer.ShardedTables`) the sharded leaves are gathered: a
    collective every rank joins."""
    if tables is None:
        adam, params = convert.adam_state_to_numpy(optimizer, model), \
            convert.jax_params_from_model(model)
    else:
        adam, params = tables.adam_numpy(optimizer), tables.params_numpy()
    return {
        "opt_state": {"count": np.asarray(adam["count"], np.int32),
                      "mu": adam["mu"], "nu": adam["nu"]},
        "params": params,
        "rng": {"device": dev_gen.get_state().numpy().copy(),
                "host": host_gen.get_state().numpy().copy()},
        "state": convert.state_to_numpy(model),
    }


def train_model(
    model_name: str,
    data: Dataset,
    config: Config | None = None,
    seed: int | None = None,
    log_dir: str | None = "log",
    echo: bool = True,
    max_epochs: int | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int | None = None,
    mesh=None,
    profile_dir: str | None = None,
    device=None,
) -> TrainResult:
    """Train ``model_name`` on ``data`` on ``device`` (default the card),
    or on every rank of ``mesh`` (`parallel.mesh.make_mesh`; ``device``
    is then the rank's own)."""
    config = config or load_model_config(model_name)
    seed = seed if seed is not None else config.int("seed")
    debug_options(config)
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)

    host_gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    np_rng = np.random.default_rng(seed)
    with use_mesh(mesh):
        model: RecModel = get_model(model_name)(config, data, device=dev, generator=host_gen)
    user_rows = model.batching == "user_rows"

    primary = distributed.is_primary()
    logger = RunLogger(model_name, data.name, log_dir if primary else None,
                       echo=echo and primary)
    logger.info(f"Run with {model_name} on {data.name}")
    logger.info(data.get_statistics())
    for key, value in config.items():
        logger.info(f"{key} : {value}")

    runner = EpochRunner(model, learn_rate=config.float("learn_rate"),
                         batch_size=config.int("batch_size"),
                         num_train=data.num_users if user_rows else data.num_train,
                         mesh=mesh)
    tables = runner.tables
    sampler = None if user_rows else NegativeSampler(data, device=dev)
    sparsity_mode = config.int("sparsity_test") == 1
    if sparsity_mode:
        split_uids, split_state = data.create_sparsity_split()
        for line in split_state:
            logger.info(line)
        evaluators = [Evaluator(model, data, config, users=grp, mesh=mesh)
                      for grp in split_uids if grp]
        evaluator = evaluators[0]
    else:
        evaluator = Evaluator(model, data, config, mesh=mesh)
    best = BestResults(patience=config.int("early_stopping"))

    epochs = max_epochs if max_epochs is not None else config.int("training_epochs")
    interval = config.int("interval")
    num_batch_norm = runner.num_train // runner.batch_size + 1  # the reference's divisor
    meter = ThroughputMeter(
        num_train=runner.num_train,
        nnz=data.nnz,
        emb_size=config.int("embedding_size"),
        num_layers=getattr(model, "num_layers", 0) or 0,
        steps_per_epoch=runner.num_batches,
        aggregates_per_step=model.aggregates_per_step,
    )

    history: list[dict] = []
    last_result: dict | None = None

    def best_fields() -> dict:
        return {"count": best.count, "epoch": best.epoch, "recall": best.recall,
                "ndcg": best.ndcg}

    start_epoch = 0
    if checkpoint_dir:
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            template = training_state_tree(model, runner.opt, host_gen, dev_gen, tables)
            tree, meta = ckpt.load_checkpoint(checkpoint_dir, latest, template)
            adam = tree["opt_state"]
            if tables is None:
                convert.load_jax_params(model, tree["params"])
                convert.load_adam_state(runner.opt, model, int(adam["count"]), adam["mu"],
                                        adam["nu"])
            else:
                tables.load(tree["params"], runner.opt, int(adam["count"]), adam["mu"],
                            adam["nu"])
            model.load_model_state(tree["state"])
            host_gen.set_state(torch.from_numpy(tree["rng"]["host"]))
            dev_gen.set_state(torch.from_numpy(tree["rng"]["device"]))
            if "np_rng_state" in meta:
                np_rng.bit_generator.state = meta["np_rng_state"]
            if "best" in meta:
                b = meta["best"]
                best.count, best.epoch = b["count"], b["epoch"]
                for name in ("recall", "ndcg"):
                    setattr(best, name, None if b[name] is None else np.asarray(b[name], np.float32))
            start_epoch = meta["epoch"]
            logger.info(f"Resumed from checkpoint at epoch {start_epoch}")

    for epoch in range(start_epoch, epochs):
        start = time.time()
        with use_mesh(mesh):
            model.epoch_context(epoch, np_rng)
        with maybe_trace(profile_dir if epoch == start_epoch + 1 else None):
            if user_rows:  # shuffled user ids; the model builds their rows itself
                users = pos = neg = noise.permutation(data.num_users, dev_gen)
            else:
                users, pos, neg = sampler.sample_epoch(dev_gen)
            term_sums = runner.run_epoch(users, pos, neg, generator=dev_gen, epoch=epoch)
            term_sums = term_sums.cpu().numpy()  # the epoch's one transfer; waits for the device
        elapsed = time.time() - start

        loss_strs = loss_string(term_sums, num_batch_norm)
        logger.info("Epoch: %4d | Training time: %.3f | training loss: %s"
                    % (epoch + 1, elapsed, loss_strs))
        logger.event(kind="train_epoch", epoch=epoch + 1, seconds=elapsed,
                     loss_terms=[float(t) / num_batch_norm for t in term_sums],
                     **meter.rates(elapsed))
        history.append({"epoch": epoch + 1, "train_time": elapsed, "loss": loss_strs})

        if epoch % interval == 0:
            if sparsity_mode:
                # log every quartile level, track the best on level 1;
                # one propagation shared by the quartile evaluators
                rep = evaluators[0].compute_repr(dev_gen)
                results = [ev.evaluate(eval_repr=rep) for ev in evaluators]
                for level, res in enumerate(results, start=1):
                    logger.info("\t level_%d: recall: %s ,ndcg: %s"
                                % (level, res["recall"], res["ndcg"]))
                result = last_result = results[0]
            else:
                result = last_result = evaluator.evaluate(generator=dev_gen)
            best.update(result, epoch)
            logger.info("Epoch: %4d | Test recall: %s | Test NDCG: %s"
                        % (epoch + 1, result["recall"], result["ndcg"]))
            logger.event(kind="eval", epoch=epoch + 1, recall=result["recall"],
                         ndcg=result["ndcg"], precision=result["precision"])
        # The checkpoint cadence is independent of the eval interval:
        # checkpoint_every=None saves at eval epochs, an explicit value
        # every N epochs. Saved after the eval block, so the snapshot
        # holds the best-results bookkeeping (resume == straight run).
        if checkpoint_dir and (
            (checkpoint_every is None and epoch % interval == 0)
            or (checkpoint_every is not None and (epoch + 1) % checkpoint_every == 0)
        ):
            tree = training_state_tree(model, runner.opt, host_gen, dev_gen, tables)
            if primary:
                ckpt.save_checkpoint(checkpoint_dir, epoch + 1, tree,
                                     np_rng_state=np_rng.bit_generator.state,
                                     best=best_fields())
            barrier(mesh)  # every rank returns with the checkpoint on disk
        if best.stop and model.respects_early_stop:
            logger.info("Early stop......")
            break

    if not model.respects_early_stop:
        # a final evaluation after the last epoch for models that never stop early
        with use_mesh(mesh):
            model.epoch_context(epochs, np_rng)
        result = last_result = evaluator.evaluate(generator=dev_gen)
        best.update(result, epochs - 1)

    logger.info("Model training process completed.")
    logger.info("Best epoch: %4d | Best recall: %s | Best NDCG: %s"
                % (best.epoch, best.recall, best.ndcg))
    logger.event(kind="best", epoch=best.epoch, recall=best.recall, ndcg=best.ndcg)
    logger.close()
    names = convert.table_names(model) if tables is None else tables.names
    params = {k: getattr(model, k).detach() for k in names}
    return TrainResult(params=params, state=model.model_state(), best=best, history=history,
                       last_result=last_result,
                       sharded_params=None if tables is None else dict(tables.shards))
