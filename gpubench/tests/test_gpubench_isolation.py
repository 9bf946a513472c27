"""What the benchmark runs loads neither JAX nor the JAX package, opens
no file of the JAX package, and its reference loads nothing of the
port. Checked in fresh processes, so that nothing this test session
imported counts."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from yardstick import manifest

ROOT = pathlib.Path(manifest.ROOT)
BENCH = pathlib.Path(manifest.BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "idgrec_tpu", "bench", "scripts"}

# imports every file of the harness, every configuration, mix and
# metric, runs each loop at a tiny size on the CPU, and reports the
# top-level modules loaded and the files opened
_PROBE = r"""
import glob, json, os, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(os.path.abspath(args[0]))
                 if ev == "open" and isinstance(args[0], str) else None)
sys.path[:0] = [{bench!r}, {root!r}, os.path.join({bench!r}, "tests")]
import time, torch
from yardstick import drivers, manifest, tracing, peaks, data, reference
from yardstick.reference import adam, evaluate, graph
from conftest import tiny
man = manifest.load_manifest()
for c in man["configs"]:
    json.load(open(os.path.join({root!r}, c["file"])))
for path in glob.glob(os.path.join({bench!r}, "mixes", "*")):
    json.load(open(path))
for m in man["per_layer"]:
    manifest.metric_reader(m["name"])
for w in man["workloads"]:
    reference.model(manifest.cell(w["name"], man).config["model"])
for name in {cells!r}:
    drivers.run(tiny(name), 3, 0.2, True, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "opened": sorted(set(opened))}}))
"""

_REFERENCE_PROBE = r"""
import json, sys, torch
sys.path[:0] = [{bench!r}]
from yardstick import data, reference
from yardstick.manifest import Keys
from yardstick.reference import adam, evaluate
from yardstick.reference.graph import Adjacency
keys = Keys(GCN_layer=2, reg_lambda=1e-4, epsilon=0.1, temperature=0.2, ssl_lambda=0.5,
            a=1, polyc=1e-7, degree=4, bt_coeff=0.01, all_bt_coeff=1, poly_coeff=5,
            mom_coeff=1, momentum=0.1)
pairs = data.synthetic_pairs(20, 30, 100, 30, seed=1)
specs = {{"user_emb": ["xavier", "u", "d"], "item_emb": ["xavier", "i", "d"],
          "pred_b": ["linear_b", "d", "d"], "u_target_his": ["normal", "u", "d"],
          "i_target_his": ["normal", "i", "d"]}}
specs.update({{k: ["linear_w", "d", "d"] for k in ("proj_w1", "proj_w2", "proj_w3", "pred_w")}})
specs.update({{f"proj_bn{{k}}_{{p}}": ["ones" if p == "gamma" else "zeros", "d"]
               for k in (1, 2) for p in ("gamma", "beta")}})
tables = data.draw_tables(specs, {{"u": 20, "i": 30, "d": 8}}, 1, torch.device("cpu"))
state = {{k: tables.pop(k) for k in ("u_target_his", "i_target_his")}}
adj = Adjacency(pairs[0], pairs[1], 20, 30, torch.device("cpu"))
batch = tuple(torch.as_tensor(p[:8]) for p in (pairs[0], pairs[1], pairs[1]))
for name in ("LightGCN", "SimGCL", "RecDCL"):
    ref = reference.model(name)
    ref.loss_terms(adj, tables, batch, keys, torch.Generator(), state)
    evaluate.metrics(*ref.eval_repr(adj, tables, keys), *pairs, [5])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_opens_nothing_of_the_jax_package():
    from conftest import CANDIDATES

    cells = [w["name"] for w in manifest.load_manifest()["workloads"]] + list(CANDIDATES)
    out = json.loads(_run(_PROBE.format(bench=str(BENCH), root=str(ROOT), cells=cells)))
    assert not FORBIDDEN & set(out["modules"]), FORBIDDEN & set(out["modules"])
    assert "idgrec_torch" in out["modules"]  # the probe did run the port
    jax_pkg = str(ROOT / "idgrec_tpu")
    assert not [p for p in out["opened"] if p.startswith(jax_pkg + "/")]


def test_the_reference_loads_nothing_of_the_port():
    modules = set(json.loads(_run(_REFERENCE_PROBE.format(bench=str(BENCH)))))
    assert "idgrec_torch" not in modules and not FORBIDDEN & modules


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_no_port():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not FORBIDDEN & tops, (path, FORBIDDEN & tops)
        if "reference" in path.parts:
            assert "idgrec_torch" not in tops, path


def test_the_run_names_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location("gpubench_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    base = set(run.forbidden_modules())  # empty unless this session loaded JAX itself
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "idgrec_tpu_extra", sys)
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "idgrec_tpu.ops", sys)
    assert set(run.forbidden_modules()) == base | {"idgrec_tpu", "jax"}
