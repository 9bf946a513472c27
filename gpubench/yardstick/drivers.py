"""The general traffic generator: one loop a kind of mix, driven by the
mix's data file (``mixes/<traffic>.json``, key ``loop``), the cell's
configuration and ``--seed``.

* ``train_epochs``: whole epochs as the port's ``engine.loop.train_model``
  runs them, without its evaluation, logs and checkpoints:
  ``model.epoch_context``, ``NegativeSampler.sample_epoch``,
  ``EpochRunner.run_epoch`` at the configuration's batch, the epoch's
  one read-back of the loss sums. Set-up builds the one model, sampler,
  runner and Adam state that the window then drives, and first runs the
  mix's ``check_steps`` steps through ``run_epoch`` on the first rows of
  a sampled epoch: the steps the reference follows.
* ``eval_sweeps``: ``Evaluator.evaluate()`` back to back with no
  representation given, so each sweep runs ``eval_embeddings``, the
  scores, the mask, the top-k and the metric sums.

A window holds the epochs or sweeps that start within ``seconds``.
Once it has closed, the peak memory is read, the program's state freed,
and the reference works out the same answers from the same inputs.

The program is entered only through its public objects (`Config`,
`Dataset.from_pairs`, `get_model`, `NegativeSampler`, `EpochRunner`,
`Evaluator`); in a traced run the driver also wraps two bound methods
of those objects to mark spans and profiler steps.
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from yardstick import data as inputs
from yardstick import reference, tracing
from yardstick.manifest import Cell
from yardstick.reference import adam as ref_adam
from yardstick.reference import evaluate as ref_eval
from yardstick.reference.graph import Adjacency

BETA1 = 0.9  # Adam's first-moment decay: the step-1 moment is (1 - BETA1) · gradient
# the precision of a product's operands that a configuration's compute
# dtype states: the reference's propagation holds them in it (float32:
# none held lower); see `reference_repr`
OPERANDS = {"bfloat16": torch.bfloat16, "float32": None}


@dataclass
class Record:
    """What the per-layer metrics read from one run."""

    cell: Cell
    graph: dict                                   # num_users, num_items, nnz, test_users
    units: int = 0                                # steps (train) or sweeps (eval) in the window
    spans: dict[str, list[float]] = field(default_factory=dict)   # host seconds by name
    untraced: tuple[int, float] = (0, 0.0)        # (units, seconds) after the traced ones
    trace: tracing.Trace | None = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


@dataclass
class Outcome:
    setup_s: float
    window_s: float
    rate: float                                   # the cell's throughput metric
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict[str, tuple[float, float]]        # name -> (value, limit)
    record: Record
    setup_phases: dict[str, float] = field(default_factory=dict)  # host seconds by phase

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Laps:
    """Host seconds of the set-up's phases, each ending in a synchronize."""

    def __init__(self, device: torch.device):
        self.device, self.t, self.phases = device, time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def make_inputs(cell: Cell, seed: int, device: torch.device) -> dict:
    """The pairs (numpy) and the tables (on ``device``) of ``seed``, and
    the seeds of the run's streams."""
    ds = cell.config["dataset"]
    s_data, s_tables, s_stream, s_host = inputs.seeds(seed, 4)
    pairs = inputs.synthetic_pairs(ds["num_users"], ds["num_items"], ds["num_train"],
                                   ds["num_test"], s_data, ds.get("zipf", 0.8))
    sizes = {**{k: v for k, v in ds.items() if isinstance(v, int)},
             "embedding_size": cell.keys.int("embedding_size")}
    drawn = inputs.draw_tables({**cell.config["tables"], **cell.config.get("state", {})},
                               sizes, s_tables, device)
    return {"pairs": pairs, "tables": {k: drawn[k] for k in cell.config["tables"]},
            "state": {k: drawn[k] for k in cell.config.get("state", {})},
            "stream": s_stream, "host": s_host}


def build_program(cell: Cell, ins: dict, device: torch.device, overrides: dict | None = None):
    """(config, dataset, model) of the port, the model's tables set to
    the benchmark's."""
    from idgrec_torch.config import Config
    from idgrec_torch.data.dataset import Dataset
    from idgrec_torch.models import get_model

    keys = {**cell.keys, **(overrides or {})}
    cfg = Config({k: str(v) for k, v in keys.items()}, name=cell.config["name"])
    ds = cell.config["dataset"]
    data = Dataset.from_pairs(*ins["pairs"], num_users=ds["num_users"],
                              num_items=ds["num_items"], name=ds["name"])
    # the model draws its own tables from a host generator (its contract);
    # the benchmark's drawn tables and state then replace them
    model = get_model(cell.config["model"])(cfg, data, device=device,
                                            generator=torch.Generator())
    params = dict(model.named_parameters())
    if set(params) != set(ins["tables"]):
        raise ValueError(f"model tables {sorted(params)} != configured {sorted(ins['tables'])}")
    with torch.no_grad():
        for name, table in ins["tables"].items():
            params[name].copy_(table)
    if set(model.state_names) != set(ins["state"]):
        raise ValueError(f"model state {model.state_names} != configured {sorted(ins['state'])}")
    model.load_model_state(ins["state"])
    return cfg, data, model


def free_program(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Profiler:
    """`torch.profiler` over the mix's traced units (``trace_skip``
    skipped, ``trace_warmup`` warmed, ``trace_units`` kept), started
    once in set-up so that the tracer's own start-up is paid there; the
    trace is reduced after the window (`finish`), not inside it."""

    def __init__(self, mix: dict, device: torch.device):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.zeros(1, device=device).add_(1)
            sync(device)
        self.ready = False
        self.prof = profile(activities=acts, on_trace_ready=self._ready, schedule=schedule(
            wait=mix["trace_skip"], warmup=mix["trace_warmup"], active=mix["trace_units"],
            repeat=1))
        self.units = mix["trace_skip"] + mix["trace_warmup"] + mix["trace_units"]

    def _ready(self, prof) -> None:
        self.ready = True

    def start(self) -> None:
        self.prof.start()

    def step(self) -> None:
        self.prof.step()

    def finish(self) -> tracing.Trace | None:
        self.prof.stop()
        return tracing.collect(self.prof) if self.ready else None


def _graph_facts(cell: Cell, pairs) -> dict:
    train_user, train_item, test_user, _ = pairs
    nnz = np.unique(train_user * cell.config["dataset"]["num_items"] + train_item).size
    return {"num_users": cell.config["dataset"]["num_users"],
            "num_items": cell.config["dataset"]["num_items"],
            "nnz": int(nnz), "test_users": int(np.unique(test_user).size)}


def _peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


# ---------------------------------------------------------------------------
# training


def _norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def _worst_leaf_gap(prog: dict[str, float], ref: dict[str, float], kept) -> float:
    """max over the kept leaves of |‖prog‖ − ‖ref‖| over the larger of
    the leaf's reference norm and the median leaf's."""
    med = statistics.median(ref[k] for k in kept)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept)


def check_feed(feed, pairs, num_items: int) -> int:
    """The triples of the checked steps that break the sampler's
    guarantees: a (user, positive) that is no train pair or repeats one
    before it, a negative that is a train positive of the user."""
    users, pos, neg = (np.asarray(t.cpu()) for t in feed)
    train = np.unique(pairs[0] * num_items + pairs[1])

    def member(keys):
        at = np.minimum(np.searchsorted(train, keys), train.size - 1)
        return train[at] == keys

    up = users * num_items + pos
    repeats = up.size - np.unique(up).size
    return int((~member(up)).sum() + member(users * num_items + neg).sum() + repeats)


def follow(cell: Cell, ins: dict, feed, states, device: torch.device, plant=None) -> dict:
    """The reference's readings of the checked steps: each step's loss,
    the first gradient's norm by leaf, the parameters' change by leaf
    after the last. ``plant(batch) -> batch`` alters each step's batch
    (a planted fault, for reading a fault's numbers)."""
    reference.exact_float32()
    ref = reference.model(cell.config["model"])
    pairs = ins["pairs"]
    ds = cell.config["dataset"]
    adj = Adjacency(pairs[0], pairs[1], ds["num_users"], ds["num_items"], device,
                    operand=OPERANDS[cell.keys.str("compute_dtype")])
    params = {k: t.clone().requires_grad_(True) for k, t in ins["tables"].items()}
    state = {k: t.clone() for k, t in ins["state"].items()}
    opt = ref_adam.Adam(params, cell.keys.float("learn_rate"))
    b = cell.keys.int("batch_size")
    losses, grad_norms = [], None
    for s, gen_state in enumerate(states):
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        batch = tuple(t[s * b: (s + 1) * b].to(device) for t in feed)
        if plant is not None:
            batch = plant(batch)
        terms = ref.loss_terms(adj, params, batch, cell.keys, gen, state)
        total = sum(terms)
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        if grad_norms is None:
            grad_norms = _norms(grads)
        opt.step(params, grads)
        losses.append([float(t.detach()) for t in terms])
    change = _norms({k: params[k] - ins["tables"][k] for k in params})
    return {"terms": losses, "grad": grad_norms, "change": change}


# leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone, and are not compared
NOUGHT = 1e-3


def compare_train(prog: dict, ref: dict) -> dict[str, float]:
    """The compared numbers: the widest relative gap of a step's loss
    (the sum of its terms), and the worst leaf's gap of the first
    gradient's norm and of the parameters' change, over the leaves whose
    reference gradient is not nought to rounding."""
    loss = max(abs(sum(p) - sum(r)) / abs(sum(r)) for p, r in zip(prog["terms"], ref["terms"]))
    med = statistics.median(ref["grad"].values())
    kept = [k for k, g in ref["grad"].items() if g >= NOUGHT * med]
    return {"loss": loss, "grad": _worst_leaf_gap(prog["grad"], ref["grad"], kept),
            "change": _worst_leaf_gap(prog["change"], ref["change"], kept)}


def train_setup(cell: Cell, ins: dict, device: torch.device, overrides: dict | None = None):
    """Build the step (model, sampler, runner, Adam), run the checked
    steps through ``run_epoch``, and return the objects with the
    program's readings of those steps."""
    from idgrec_torch.engine.sampler import NegativeSampler
    from idgrec_torch.engine.trainer import EpochRunner

    laps = Laps(device)
    cfg, data, model = build_program(cell, ins, device, overrides)
    laps("program")
    sampler = NegativeSampler(data, device=device)
    laps("sampler")
    gen = torch.Generator(device=device).manual_seed(ins["stream"])
    np_rng = np.random.default_rng(ins["host"])
    b = cfg.int("batch_size")
    runner = EpochRunner(model, cfg.float("learn_rate"), b, data.num_train)
    steps = cell.mix["check_steps"]
    model.epoch_context(0, np_rng)
    laps("runner")
    users, pos, neg = sampler.sample_epoch(gen)
    feed = tuple(t[: steps * b].clone() for t in (users, pos, neg))
    laps("first_sample")
    params = dict(model.named_parameters())
    states, losses, grad_norms = [], [], None
    epoch_batches, runner.num_batches = runner.num_batches, 1
    for s in range(steps):
        states.append(gen.get_state())
        sl = slice(s * b, (s + 1) * b)
        terms = runner.run_epoch(users[sl], pos[sl], neg[sl], generator=gen, epoch=0)
        losses.append([float(t) for t in terms.double()])
        if s == 0:
            # a step whose optimizer kept no moment gave it no gradient
            grad_norms = _norms({k: runner.opt.state.get(p, {}).get("exp_avg", torch.zeros(()))
                                 / (1 - BETA1) for k, p in params.items()})
            laps("first_step")
    runner.num_batches = epoch_batches
    change = _norms({k: p - ins["tables"][k] for k, p in params.items()})
    laps("checked_steps")
    readings = {"terms": losses, "grad": grad_norms, "change": change}
    return {"cfg": cfg, "data": data, "model": model, "sampler": sampler, "runner": runner,
            "gen": gen, "np_rng": np_rng, "feed": feed, "states": states,
            "readings": readings, "phases": laps.phases}


def train_epochs(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
                 t0: float, overrides: dict | None = None) -> Outcome:
    laps = Laps(device)
    laps.phases["start"] = laps.t - t0
    ins = make_inputs(cell, seed, device)
    laps("inputs")
    st = train_setup(cell, ins, device, overrides)
    laps.phases.update(st["phases"])
    model, sampler, runner, gen = st["model"], st["sampler"], st["runner"], st["gen"]
    rec = Record(cell=cell, graph=_graph_facts(cell, ins["pairs"]))
    prof = Profiler(cell.mix, device) if trace else None
    traced_end = []  # when the profiler's last kept step ended (synchronized)
    if prof is not None:
        step = runner.opt.step
        done = [0]

        def stepped(*args, **kwargs):
            out = step(*args, **kwargs)
            prof.step()
            done[0] += 1
            if done[0] == prof.units:
                sync(device)
                traced_end.append(time.perf_counter())
            return out

        runner.opt.step = stepped
    sync(device)
    setup_s = time.perf_counter() - t0
    epoch_steps = runner.num_batches
    epochs = failed = traced_until = 0
    if prof is not None:
        prof.start()
        traced_until = prof.units
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        e0 = time.perf_counter()
        epochs += 1
        model.epoch_context(epochs, st["np_rng"])
        if prof is not None:
            sync(device)
            s0 = time.perf_counter()
        users, pos, neg = sampler.sample_epoch(gen)
        if prof is not None:
            sync(device)
            rec.span("sample_epoch", time.perf_counter() - s0)
        sums = runner.run_epoch(users, pos, neg, generator=gen, epoch=epochs).cpu().numpy()
        failed += 0 if np.all(np.isfinite(sums)) else epoch_steps
        rec.span("epoch", time.perf_counter() - e0)
        first = (epochs - 1) * epoch_steps
        if first >= traced_until:
            rec.untraced = (rec.untraced[0] + epoch_steps,
                            rec.untraced[1] + time.perf_counter() - e0)
        elif traced_end and first + epoch_steps > traced_until:
            # the rest of the epoch the trace ended in
            rec.untraced = (rec.untraced[0] + first + epoch_steps - traced_until,
                            rec.untraced[1] + time.perf_counter() - traced_end[0])
    window_s = time.perf_counter() - start
    rec.units = epochs * epoch_steps
    if prof is not None:
        rec.trace = prof.finish()
        runner.opt.step = step
        del step
    peak = _peak(device)
    b = runner.batch_size
    feed, states, readings = st["feed"], st["states"], st["readings"]
    del st, model, sampler, runner, gen, prof
    free_program(device)
    ref = follow(cell, ins, feed, states, device)
    numbers = compare_train(readings, ref)
    numbers["sampler"] = check_feed(feed, ins["pairs"], cell.config["dataset"]["num_items"])
    checks = {k: (v, float(cell.limits[k])) for k, v in numbers.items()}
    return Outcome(setup_s=setup_s, window_s=window_s, rate=rec.units * b / window_s,
                   attempted=rec.units, failed=failed, memory_peak_bytes=peak, checks=checks,
                   record=rec, setup_phases=laps.phases)


# ---------------------------------------------------------------------------
# evaluation


def reference_repr(cell: Cell, ins: dict, device: torch.device):
    """The reference's representation, its products in the stated
    precision: with random tables the scores near each user's k-th lie
    closer than a bfloat16 rounding moves them, so only the stated
    precision decides which of them a sound program ranks first."""
    reference.exact_float32()
    ds = cell.config["dataset"]
    pairs = ins["pairs"]
    adj = Adjacency(pairs[0], pairs[1], ds["num_users"], ds["num_items"], device,
                    operand=OPERANDS[cell.keys.str("compute_dtype")])
    return reference.model(cell.config["model"]).eval_repr(adj, ins["tables"], cell.keys)


def reference_metrics(cell: Cell, ins: dict, device: torch.device) -> dict[str, np.ndarray]:
    return ref_eval.metrics(*reference_repr(cell, ins, device), *ins["pairs"],
                            cell.keys.int_list("top_K"))


def answer_gap(answer: dict, ref: dict) -> float:
    """The widest relative gap of a sweep's metrics to the reference's."""
    return max(float(np.max(np.abs(np.asarray(answer[m], np.float64) - ref[m])
                            / np.maximum(np.abs(ref[m]), 1e-12)))
               for m in ("recall", "precision", "ndcg"))


def eval_sweeps(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
                t0: float, overrides: dict | None = None) -> Outcome:
    from idgrec_torch.engine.evaluator import Evaluator

    laps = Laps(device)
    laps.phases["start"] = laps.t - t0
    ins = make_inputs(cell, seed, device)
    laps("inputs")
    cfg, data, model = build_program(cell, ins, device, overrides)
    laps("program")
    evaluator = Evaluator(model, data, cfg)
    laps("evaluator")
    gen = torch.Generator(device=device).manual_seed(ins["stream"])
    rec = Record(cell=cell, graph=_graph_facts(cell, ins["pairs"]))
    answers = [evaluator.evaluate(generator=gen)]
    laps("first_sweep")
    prof = Profiler(cell.mix, device) if trace else None
    if prof is not None:
        represent = model.eval_embeddings

        def spanned(*args, **kwargs):
            sync(device)
            s0 = time.perf_counter()
            out = represent(*args, **kwargs)
            sync(device)
            rec.span("eval_embeddings", time.perf_counter() - s0)
            return out

        model.eval_embeddings = spanned
    sync(device)
    setup_s = time.perf_counter() - t0
    traced_until = 0
    if prof is not None:
        prof.start()
        traced_until = prof.units
    sweeps = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        s0 = time.perf_counter()
        answers.append(evaluator.evaluate(generator=gen))
        sweeps += 1
        rec.span("sweep", time.perf_counter() - s0)
        if prof is not None:
            prof.step()
        if sweeps > traced_until:
            rec.untraced = (rec.untraced[0] + 1, rec.untraced[1] + time.perf_counter() - s0)
    window_s = time.perf_counter() - start
    rec.units = sweeps
    if prof is not None:
        rec.trace = prof.finish()
    peak = _peak(device)
    users = evaluator.plan.num_test_users
    del model, evaluator, data, prof
    free_program(device)
    ref = reference_metrics(cell, ins, device)
    gaps = [answer_gap(a, ref) for a in answers]
    limit = float(cell.limits["answer"])
    checks = {"answer": (max(gaps), limit)}
    return Outcome(setup_s=setup_s, window_s=window_s, rate=sweeps * users / window_s,
                   attempted=sweeps, failed=sum(g > limit for g in gaps[1:]),
                   memory_peak_bytes=peak, checks=checks, record=rec, setup_phases=laps.phases)


LOOPS = {"train_epochs": train_epochs, "eval_sweeps": eval_sweeps}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
        overrides: dict | None = None) -> Outcome:
    return LOOPS[cell.mix["loop"]](cell, seed, seconds, trace, device, t0, overrides)

