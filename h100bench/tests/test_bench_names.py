"""Every name in BENCHMARK.json resolves to its files, and the file keeps
to the benchmark contract's shape."""

import importlib
import json
import os
import re

import pytest

from benchlib import inputs
from benchlib.cell import HERE, ROOT, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "h100bench/run.py"]
    assert bench["paths"] == ["h100bench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_configs_resolve(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["input"]["generator"]


def test_generators_resolve(bench):
    """Each configuration's input generator, those of the tests' small
    configurations too, is a file inputs/<generator>.py with generate()."""
    data = os.path.join(HERE, "tests", "data")
    files = [os.path.join(ROOT, c["file"]) for c in bench["configs"]]
    files += [os.path.join(data, f) for f in sorted(os.listdir(data))
              if f.endswith(".json")]
    for path in files:
        with open(path) as fh:
            name = json.load(fh)["input"]["generator"]
        assert NAME.match(name), path
        assert os.path.isfile(inputs.generator_path(name)), path
        assert callable(inputs.generator(name).generate), path


def test_cells_resolve(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as fh:
            traffic = json.load(fh)
        kind = importlib.import_module(f"jobs.{traffic['job']}")
        for fn in ("setup", "run", "end_to_end", "check", "SPANS"):
            assert callable(getattr(kind, fn))
        assert traffic["limits"]
    assert len(pairs) == len(bench["workloads"])


def test_metrics_resolve(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert callable(metric_reader(m["name"]))
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in bench["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in bench["per_layer"])
