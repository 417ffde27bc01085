"""Nothing the benchmark runs is jax, jaxlib, flax or the JAX package,
compared by whole top-level name (the port's name begins with the JAX
package's and passes)."""

import ast
import os
import subprocess
import sys

from benchlib import cell

HERE = cell.HERE


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"wfmash_tpu_torch": 1,
                                         "wfmash_tpu_torch.cli": 1,
                                         "jaxtyping": 1, "numpy": 1})
    assert cell.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"wfmash_tpu.align": 1, "jax": 1,
                                         "jaxlib.xla_client": 1})
    assert cell.forbidden_modules() == ["jax", "jaxlib", "wfmash_tpu"]


def test_no_source_under_the_benchmark_imports_them():
    for base, _, files in os.walk(HERE):
        if os.sep + "tests" in base + os.sep:
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in cell.FORBIDDEN, (f, n)


def test_a_run_loads_none_of_them(tmp_path):
    """A whole small run in a fresh process (the CPU paths), then the
    process's modules."""
    code = f"""
import json, os, sys, time, torch
sys.path[:0] = [{HERE!r}, {cell.ROOT!r}]
os.environ["WFMASH_TPU_TORCH_DEVICE"] = "cpu"
from benchlib.cell import run_cell, load_json, forbidden_modules
bench = json.load(open(os.path.join({cell.ROOT!r}, "BENCHMARK.json")))
cfg = json.load(open(os.path.join({HERE!r}, "tests", "data",
                                  "yeast8_tiny.json")))
tr = dict(load_json("traffic", "hap_pair_chunks_2mbp.json"), sample=2)
run_cell(bench, "yeast8.align", 7, 0.5, False, torch.device("cpu"),
         time.monotonic(), work_root={str(tmp_path)!r}, config=cfg,
         traffic=tr)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path),
                       env=dict(os.environ, JAX_PLATFORMS=""))
    assert r.returncode == 0, r.stderr[-3000:]
    import json

    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "wfmash_tpu_torch" in top
    assert not top & set(cell.FORBIDDEN)


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA, run.py exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", "yeast8.align", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
