"""DirectAU's training curve in the port against the JAX package's, on
the CPU: the same carried initial tables, the same sampled triples each
epoch (drawn once by the JAX sampler and fed to both `EpochRunner`s),
recall@20 after every epoch. The published config (LightGCN encoder,
gamma 2.0, learn_rate 0.001, batch 2,048) at d = 32 and 2 layers on a
reduced learnable latent set (`make_latent_synthetic_dataset`, pair for
pair the same in both packages). The port's default route (dense, K6's
plain version on the CPU) against JAX's fused backend, K6's function.

Tolerances, with their reasons: recall@20 per epoch within CURVE_TOL =
0.005 absolute, the epoch's loss sums within rtol 1e-4. The two runs
take the same steps on the same tables; the per-step gradients differ
only where a cotangent entry within a float32 ulp of a bfloat16 rounding
boundary rounds the other way (2**-8 of the largest entry,
tests/test_torch_zoo.py), so the tables drift apart by a few ulps an
epoch, and a recall moves when a test item's rank crosses 20. Measured:
here (3 epochs) the recalls within 1.9e-9; over 30 epochs on a
2,000 x 3,000 set (the command below) within 1.7e-4 and the loss sums
within 3.4e-6 relative, while recall@20 rose 0.0167 -> 0.2528
(docs/torch_evidence/zoo_curve_directau.json).

Longer runs, from the root of the repo: ``PYTHONPATH=. python
tests/test_torch_zoo_curve.py --epochs 30 --scale 2000,3000,60000,15000
--out curve.json`` prints both curves (~2 min). It
imports JAX, so it lives beside the tests: the port's scripts
(scripts/torch_*.py) import no JAX.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.config import load_model_config as t_load_config
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.engine.evaluator import Evaluator as JEvaluator
from idgrec_tpu.engine.sampler import NegativeSampler as JSampler
from idgrec_tpu.engine.trainer import EpochRunner as JRunner
from idgrec_tpu.models import get_model as j_get_model

CURVE_TOL = 0.005
_SHAPE = (600, 900, 18_000, 4_500)
_EPOCHS = 3


def curves(model: str = "DirectAU", shape=_SHAPE, epochs: int = _EPOCHS, d: int = 32,
           layers: int = 2, seed: int = 0) -> dict:
    """Train the JAX and the port's ``model`` side by side from the same
    tables on the same triples; recall@20 and the loss sums per epoch."""
    tdata = t_dataset.make_latent_synthetic_dataset(*shape, seed=seed, name="latent")
    jdata = j_dataset.make_latent_synthetic_dataset(*shape, seed=seed, name="latent")
    cfg = {**t_load_config(model).as_dict(), "dataset": "latent", "embedding_size": str(d),
           "GCN_layer": str(layers), "top_K": "[20]", "test_batch_size": "256"}
    jmodel = j_get_model(model)(JConfig({**cfg, "propagation_backend": "fused"}), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    tmodel = t_get_model(model)(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    lr, bs = float(cfg["learn_rate"]), int(cfg["batch_size"])
    jrun, trun = JRunner(jmodel, lr, bs, jdata.num_train), TRunner(tmodel, lr, bs, tdata.num_train)
    opt_state = jrun.init_opt_state(params)
    jev, tev = JEvaluator(jmodel, jdata, JConfig(cfg)), TEvaluator(tmodel, tdata, TConfig(cfg))
    sampler = JSampler(jdata)
    key = jax.random.PRNGKey(seed + 1)
    out = {"model": model, "shape": list(shape), "d": d, "layers": layers, "seed": seed,
           "route": {"jax": "fused", "port": type(tmodel.graph).__name__},
           "jax_recall": [], "port_recall": [], "jax_loss": [], "port_loss": []}
    t0 = time.perf_counter()
    for epoch in range(epochs):
        key, k_sample, k_epoch, k_eval = jax.random.split(key, 4)
        triples = [np.asarray(t) for t in sampler.sample_epoch(k_sample)]
        params, opt_state, _, jterms = jrun.run_epoch(params, opt_state, {}, (), *triples,
                                                      k_epoch, epoch)
        tterms = trun.run_epoch(*(torch.from_numpy(t.astype(np.int64)) for t in triples),
                                epoch=epoch)
        out["jax_loss"].append(np.asarray(jterms).tolist())
        out["port_loss"].append(tterms.numpy().tolist())
        out["jax_recall"].append(float(jev.evaluate(params, {}, (), k_eval)["recall"][0]))
        out["port_recall"].append(float(tev.evaluate()["recall"][0]))
    out["seconds"] = time.perf_counter() - t0
    gap = np.abs(np.subtract(out["jax_recall"], out["port_recall"]))
    out["max_gap"] = float(gap.max())
    return out


def test_directau_curve_follows_jax():
    res = curves()
    assert res["route"]["port"] == t_prop.DenseSquareAdj.__name__
    assert np.isfinite(res["port_loss"]).all() and np.isfinite(res["jax_loss"]).all()
    np.testing.assert_allclose(res["port_loss"], res["jax_loss"], rtol=1e-4)
    assert res["max_gap"] <= CURVE_TOL, res
    # it learns on this set: recall rises over the epochs in both
    assert res["jax_recall"][-1] > res["jax_recall"][0]
    assert res["port_recall"][-1] > res["port_recall"][0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="DirectAU")
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--scale", default=",".join(map(str, _SHAPE)),
                        help="users,items,train,test of the latent set")
    parser.add_argument("--embedding_size", type=int, default=32)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    res = curves(args.model, tuple(int(x) for x in args.scale.split(",")), args.epochs,
                 args.embedding_size, args.layers, args.seed)
    for e, (a, b) in enumerate(zip(res["jax_recall"], res["port_recall"]), start=1):
        print(f"epoch {e:3d}  recall@20 JAX {a:.5f}  port {b:.5f}  gap {b - a:+.5f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if not k.endswith("loss")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
