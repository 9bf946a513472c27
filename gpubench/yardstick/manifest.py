"""The benchmark's data, found by name: ``BENCHMARK.json`` at the
checkout's root; ``configs/<config>.json``, ``mixes/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py`` under ``gpubench/``.
A cell is added by adding files and entries, never by editing one."""

from __future__ import annotations

import ast
import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Keys(dict):
    """A configuration's ``keys``: the model's settings by name, read
    typed (the reference takes these, never the program's config)."""

    def int(self, key: str) -> int:
        return int(self[key])

    def float(self, key: str) -> float:
        return float(self[key])

    def str(self, key: str) -> str:
        return str(self[key])

    def int_list(self, key: str) -> list[int]:
        value = self[key]
        return [int(v) for v in (ast.literal_eval(value) if isinstance(value, str) else value)]


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int
    keys: Keys = field(default_factory=Keys)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict | None = None, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    mix, limits and the metrics it reports."""
    manifest = manifest or load_manifest(os.path.dirname(bench_dir))
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return cell_of(name, config["file"], entry["traffic"], int(entry["chips"]), manifest,
                   bench_dir)


def cell_of(name: str, config_file: str, traffic: str, chips: int, manifest: dict,
            bench_dir: str = BENCH_DIR) -> Cell:
    """A cell from its files: the configuration at ``config_file`` (from
    the checkout's root), ``mixes/<traffic>.json``, ``limits/<name>.json``."""
    cfg = _json(os.path.join(os.path.dirname(bench_dir), config_file))
    mix = _json(os.path.join(bench_dir, "mixes", f"{traffic}.json"))
    limits = _json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(name=name, config=cfg, mix=mix, limits=limits,
                end_to_end=[m for m in manifest["end_to_end"] if _reported(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _reported(m, name)],
                chips=chips, keys=Keys(cfg["keys"]))


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The module of per-layer metric ``name`` (``metrics/<name>.py``),
    whose ``read(record)`` gives its value or None."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
