"""The mapping slice as a whole: `python -m wfmash_tpu_torch ... -m` with
the device stages (torch programs on CPU tensors here) writes the PAF bytes
that the host stages write, that two worker processes write, that the host
L2 walk writes and that the JAX package writes with its device stages.

A small multi-sequence pair made from a seed with numpy: three target
sequences in two PanSN groups, three queries of 12.6-28 kb, each with a tail
fragment. Tolerance: none, the outputs are compared byte for byte.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from util import mutate, random_dna, write_fasta

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("mapping")
    rng = np.random.default_rng(7)
    t1, t2, t3 = (random_dna(rng, n) for n in (40_000, 30_000, 20_000))
    write_fasta(d / "t.fa", {"tA#1#c1": t1, "tA#1#c2": t2, "tB#1#c1": t3})
    write_fasta(d / "q.fa", {
        "q1": mutate(rng, t1[2_000:27_300], 0.03),
        "q2": mutate(rng, t2[1_000:21_000], 0.05)
        + mutate(rng, t1[30_000:38_450], 0.02),
        "q3": mutate(rng, t3, 0.02)[:12_600]})
    return d


def _run(pair, package="wfmash_tpu_torch", threads=1, **env_over):
    """(exit code, PAF text, stderr) of one mapping-only CLI run."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("WFMASH_TPU_")}
    env.update(PYTHONPATH=str(REPO), WFMASH_TPU_TORCH_DEVICE="cpu",
               JAX_PLATFORMS="cpu", WFMASH_TPU_PERF="1", **env_over)
    r = subprocess.run(
        [sys.executable, "-m", package, "t.fa", "q.fa", "-m", "-t",
         str(threads)], capture_output=True, text=True, timeout=600,
        env=env, cwd=str(pair))
    return r.returncode, r.stdout, r.stderr


def _counters(stderr):
    return {k: float(v) for k, v in
            re.findall(r"\[wfmash::perf\] (\S+) = (\S+)", stderr)}


@pytest.fixture(scope="module")
def device_run(pair):
    rc, paf, err = _run(pair, WFMASH_TPU_DEVICE_L1="1")
    assert rc == 0, err[-3000:]
    return paf, _counters(err)


def test_device_mapping_maps_every_query(device_run):
    paf, counters = device_run
    rows = [ln.split("\t") for ln in paf.splitlines()]
    assert {f[0] for f in rows} == {"q1", "q2", "q3"}
    assert {f[5] for f in rows} == {"tA#1#c1", "tA#1#c2", "tB#1#c1"}
    # 25 + 28 + 12 whole fragments and one tail fragment a query
    assert counters["map.l1_rows"] == 68
    assert counters["map.device_calls"] == 1
    assert counters["map.l2_device_calls"] == 1
    assert counters["map.l2_rows"] >= 65
    assert counters["map.l1_host_rows"] == counters["map.l2_host_rows"] == 0
    assert counters["map.device_s"] > 0


VARIANTS = {
    "host-stages": dict(WFMASH_TPU_DEVICE_L1="0"),
    "two-workers": dict(WFMASH_TPU_DEVICE_L1="1", threads=2),
    "host-l2-walk": dict(WFMASH_TPU_DEVICE_L1="1", WFMASH_TPU_DEVICE_L2="0"),
    "default-on-cpu": {},
    "jax-package": dict(WFMASH_TPU_DEVICE_L1="1", package="wfmash_tpu"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paf_bytes_equal_the_device_run(pair, device_run, variant):
    rc, paf, err = _run(pair, **VARIANTS[variant])
    assert rc == 0, err[-3000:]
    assert paf == device_run[0]
    assert paf.count("\n") >= 5
    counters = _counters(err)
    if variant in ("host-stages", "default-on-cpu"):
        # on the CPU device the default is the host stages
        assert "map.device_calls" not in counters
    elif variant == "host-l2-walk":
        assert counters["map.device_calls"] == 1
        assert "map.l2_device_calls" not in counters
    elif variant == "two-workers":
        assert counters["map.device_calls"] == 1
        assert counters["map.l2_device_calls"] == 1


def test_mesh_is_refused_with_a_message(pair, device_run):
    """WFMASH_TPU_DEVICE_L1=mesh was refused until the sharded L1 was
    ported; it now runs (here over the one CPU device, a (1, 1) mesh;
    tests/test_torch_mesh_cli.py runs eight shards) and writes the device
    run's bytes."""
    rc, paf, err = _run(pair, WFMASH_TPU_DEVICE_L1="mesh")
    assert rc == 0, err[-3000:]
    assert paf == device_run[0]
    counters = _counters(err)
    assert counters["map.device_calls"] == 1
    assert counters["map.l1_host_rows"] == 0
    assert "Traceback" not in err
