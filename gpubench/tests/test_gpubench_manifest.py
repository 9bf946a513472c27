"""BENCHMARK.json against the benchmark's rules, and a cell added by
adding files and entries alone."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import pytest

from yardstick import manifest

M = manifest.load_manifest()
# the characters BENCHMARK.json allows in a name and in a unit
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in M[group]:
            yield entry["name"]


def test_top_level_keys_and_sizes():
    assert set(M) == TOP
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    seen = list(names())
    assert len(seen) == len(set(seen))
    for name in seen:
        assert NAME.match(name), name
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in M["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in M["configs"]] + [w["why"] for w in M["workloads"]]
                 + [m["layer"] for m in M["per_layer"]] + M["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for w in M["workloads"]:
        cell = manifest.cell(w["name"], M)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
        assert cell.mix["rate"] in reported


def test_files_are_found_by_name_under_paths():
    assert M["paths"] == ["gpubench"]
    for c in M["configs"]:
        assert c["file"].startswith("gpubench/") and os.path.exists(
            os.path.join(manifest.ROOT, c["file"]))
        assert json.load(open(os.path.join(manifest.ROOT, c["file"])))["name"] == c["name"]
    for w in M["workloads"]:
        manifest.cell(w["name"], M)
    for m in M["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            if "__pycache__" not in path:
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_is_added_by_adding_files_alone(tmp_path):
    bench = tmp_path / "gpubench"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _digests(bench)
    # a new configuration, mix, limits and metric: files of their own
    cfg = json.load(open(bench / "configs" / "lightgcn-amazon-book.json"))
    cfg.update(name="lightgcn-tiny", dataset={**cfg["dataset"], "num_users": 30})
    (bench / "configs" / "lightgcn-tiny.json").write_text(json.dumps(cfg))
    mix = json.load(open(bench / "mixes" / "train.json"))
    (bench / "mixes" / "train-short.json").write_text(json.dumps({**mix, "check_steps": 2}))
    (bench / "limits" / "lightgcn-tiny.train-short.json").write_text(
        (bench / "limits" / "lightgcn-amazon-book.train.json").read_text())
    (bench / "metrics" / "steps_seen.py").write_text("def read(rec):\n    return rec.units\n")
    # and entries in BENCHMARK.json
    man = json.load(open(tmp_path / "BENCHMARK.json"))
    man["configs"].append({"name": "lightgcn-tiny", "source": "https://example.org",
                           "file": "gpubench/configs/lightgcn-tiny.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "lightgcn-tiny.train-short", "config": "lightgcn-tiny",
                             "traffic": "train-short", "chips": 1, "why": "a test"})
    man["end_to_end"][0]["workloads"].append("lightgcn-tiny.train-short")
    man["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "engine.trainer",
                             "moves": "train_pairs_per_s",
                             "workloads": ["lightgcn-tiny.train-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    cell = manifest.cell("lightgcn-tiny.train-short", man, str(bench))
    assert cell.config["dataset"]["num_users"] == 30 and cell.mix["check_steps"] == 2
    assert [m["name"] for m in cell.per_layer if m["name"] == "steps_seen"]
    from yardstick.drivers import Record

    reader = manifest.metric_reader("steps_seen", str(bench))
    assert reader.read(Record(cell=cell, graph={}, units=7)) == 7


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_each_cell_has_its_limits_file(name):
    limits = manifest.cell(name, M).limits
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
