"""BENCHMARK.json against the benchmark's contract, and the harness's
promise that a cell, configuration, traffic mix or per-layer metric is
added by files and entries alone."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from breathbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench() -> dict:
    return harness.benchmark(ROOT)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_parses_with_the_contract_keys(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(bench["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_texts_use_only_the_allowed_characters(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_cell_finds_its_files_and_reports_enough(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        # every metric but setup_s names its cells
        assert ("workloads" in m) != (m["name"] == "setup_s"), m["name"]
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:  # the metric it moves is reported there
            moved = next(x for x in bench["end_to_end"]
                         if x["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
        assert callable(harness.reader(m["name"]))
    used = set()
    for w in bench["workloads"]:
        cell = harness.cell(w["name"])
        used.add(w["config"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert harness.kind(cell.traffic["kind"]).run
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("breathbench/configs/") for f in files)


def test_four_chip_cells_and_the_check_fit_the_budget(bench):
    n4 = sum(w["chips"] == 4 for w in bench["workloads"])
    assert n4 <= max(1, len(bench["workloads"]) // 4)
    cells = 24  # later PRs may fill the benchmark up
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def _copy(tmp_path) -> str:
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "breathbench"),
                    os.path.join(root, "breathbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_files_dropped_into_a_copy_make_a_cell_with_no_code_edit(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric's reader added as files and entries only."""
    root = _copy(tmp_path)
    b = harness.benchmark(root)
    here = os.path.join(root, "breathbench")
    conf = harness.load_json(os.path.join(here, "configs", "vgg.json"))
    conf["members"][0]["weight"] = 1.0
    with open(os.path.join(here, "configs", "vgg_copy.json"), "w") as f:
        json.dump(conf, f)
    traffic = harness.load_json(os.path.join(here, "traffic",
                                             "serve_open.json"))
    traffic["burst"] = 4
    with open(os.path.join(here, "traffic", "serve_burst.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(here, "limits", "vgg_copy.serve_burst.json"),
              "w") as f:
        json.dump({"prob_gap": 0.5, "prob_gap_mean": 0.1}, f)
    with open(os.path.join(here, "metrics", "calls.serve.py"), "w") as f:
        f.write("def read(run):\n    return len(run.spans.get("
                "'server_call', [])) or None\n")
    b["configs"].append({"name": "vgg_copy", "source": "https://example.org",
                         "file": "breathbench/configs/vgg_copy.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "vgg_copy.serve_burst",
                           "config": "vgg_copy", "traffic": "serve_burst",
                           "chips": 1, "why": "a test"})
    b["end_to_end"][1]["workloads"].append("vgg_copy.serve_burst")
    b["per_layer"].append({"name": "calls.serve", "unit": "calls",
                           "better": "lower", "source": "host_clock",
                           "layer": "ensemble.Server", "moves": "serve_p50_ms",
                           "workloads": ["vgg_copy.serve_burst"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = harness.cell("vgg_copy.serve_burst", root)
    assert cell.config["members"][0]["model"]["arch"] == "vgg"
    assert cell.traffic["burst"] == 4
    assert [m["name"] for m in cell.per_layer] == ["calls.serve"]
    assert "serve_p50_ms" in [m["name"] for m in cell.end_to_end]
    run = harness.Run(cell=cell, seed=1, seconds=1.0, trace=True,
                      device=None, process_start=0.0,
                      spans={"server_call": [0.1, 0.2]})
    assert harness.reader("calls.serve", root)(run) == 2
    assert harness.kind(cell.traffic["kind"]).arrivals(1, 40.0, 1.0, 4
                                                       ).size % 4 == 0


def test_a_checkout_of_the_benchmark_alone_exits_without_a_result(tmp_path):
    root = _copy(tmp_path)
    res = subprocess.run([sys.executable, "-m", "breathbench.run",
                          "--workload", "cnn8.serve_open", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


BLOCK_JAX = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_breath"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import pkgutil, importlib, breathbench
names = [m.name for m in pkgutil.walk_packages(breathbench.__path__,
                                               "breathbench.")
         if ".tests" not in m.name]
for n in names:
    importlib.import_module(n)
from breathbench import harness, run as entry
for m in harness.benchmark()["per_layer"]:
    harness.reader(m["name"])
import tpu_breath_torch.features, tpu_breath_torch.ensemble
import tpu_breath_torch.train.loop, tpu_breath_torch.data.wav
bad = entry.forbidden_modules()
print("OK" if not bad else bad, len(names))
"""


def test_nothing_the_benchmark_imports_is_jax_or_the_jax_package():
    """Every module of breathbench, every metric reader and the port's
    modules the kinds use import with jax, jaxlib, flax and tpu_breath
    made unimportable (top-level names compared whole: tpu_breath_torch
    is not tpu_breath), and none of them is then loaded."""
    res = subprocess.run([sys.executable, "-c", BLOCK_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("OK"), res.stdout


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from breathbench import run as entry

    monkeypatch.setitem(sys.modules, "tpu_breath_torch_x", sys)
    assert "tpu_breath" not in entry.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_breath.config", sys)
    assert entry.forbidden_modules() == ["tpu_breath"]
