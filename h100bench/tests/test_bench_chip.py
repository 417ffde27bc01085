"""On the card: one short run of each cell, as the benchmark runs it."""

import json
import os
import subprocess
import sys

import pytest

from benchlib.cell import HERE, ROOT


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", _cells())
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", cell, "--seed", str(2 ** 31 + 3),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
