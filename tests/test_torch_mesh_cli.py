"""The port's CLI over eight logical CPU shards: the mesh routes
(WFMASH_TPU_DEVICE_L1=mesh, WFMASH_TPU_ALIGN_MESH=force) write the PAF
bytes of the unsharded routes and of the JAX package's CLI with its mesh
route (on its eight virtual CPU devices, tests/conftest.py).

The inputs are tests/test_multichip.py's: the mapping pair of
test_sharded_pipeline_paf_byte_identical (seed 29) and the align pair of
test_sharded_align_paf_byte_identical (seed 37). The CLIs run in this
process, with parallel.mesh.mesh_devices replaced by a list of eight CPU
devices: the counterpart of the reference's eight virtual devices.
Tolerance: none, the outputs are compared byte for byte.
"""

import os

import numpy as np
import pytest
import torch

import wfmash_tpu.align.engine as ref_engine
from wfmash_tpu import cli as ref_cli
from wfmash_tpu.align.wfa_np import Penalties
from wfmash_tpu_torch import cli as port_cli
from wfmash_tpu_torch.align import wfa_seg
from wfmash_tpu_torch.parallel import mesh as PM
from wfmash_tpu_torch.utils import perf

from util import mutate, random_dna, write_fasta

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture
def env(monkeypatch):
    """A clean WFMASH_TPU_* environment on the CPU device, eight logical
    shards from mesh_devices, and a count of sharded segment launches."""
    for k in list(os.environ):
        if k.startswith("WFMASH_TPU_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(PM, "mesh_devices", lambda device=None: CPU8)
    shards = []
    real = wfa_seg._run_seg_sharded

    def counted(buf, n_rows, devices, **kw):
        got = real(buf, n_rows, devices, **kw)
        shards.append((len(devices), len(got[1])))
        return got

    monkeypatch.setattr(wfa_seg, "_run_seg_sharded", counted)
    return monkeypatch, shards


def _run(main, argv, monkeypatch, capsys, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    perf.reset()
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out, perf.snapshot()


@pytest.fixture(scope="module")
def map_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshmap")
    rng = np.random.default_rng(29)
    t1 = random_dna(rng, 22_000)
    t2 = random_dna(rng, 15_000)
    write_fasta(d / "t.fa", {"tA#1#c": t1, "tB#1#c": t2})
    write_fasta(d / "q.fa", {"q1#1#c": mutate(rng, t1[2_000:18_000], 0.03),
                             "q2#1#c": mutate(rng, t2, 0.05)})
    return [str(d / "t.fa"), str(d / "q.fa"), "-p", "90", "-t", "1"]


@pytest.fixture(scope="module")
def align_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshalign")
    rng = np.random.default_rng(37)
    t1 = random_dna(rng, 20_000)
    t2 = random_dna(rng, 14_000)
    q1 = mutate(rng, t1, 0.01)
    q2 = mutate(rng, t2, 0.04)
    write_fasta(d / "t.fa", {"tA#1#c": t1, "tB#1#c": t2})
    write_fasta(d / "q.fa", {"qA#1#c": q1, "qB#1#c": q2})
    return [str(d / "t.fa"), str(d / "q.fa"), "-p", "90", "-t", "1"]


def test_mesh_mapping_equals_every_route_and_the_reference(
        map_pair, env, capsys):
    monkeypatch, _ = env
    argv = map_pair + ["-m"]
    mesh, c = _run(port_cli.main, argv, monkeypatch, capsys,
                   WFMASH_TPU_DEVICE_L1="mesh")
    assert mesh.count("\n") >= 2
    assert c["map.device_calls"] == 1 and c["map.l2_device_calls"] == 1
    assert c["map.l1_rows"] >= 25 and c["map.l1_host_rows"] == 0
    for route in ("1", "0"):
        paf, c = _run(port_cli.main, argv, monkeypatch, capsys,
                      WFMASH_TPU_DEVICE_L1=route)
        assert paf == mesh, route
        assert ("map.device_calls" in c) == (route == "1")
    ref, _ = _run(ref_cli.main, argv, monkeypatch, capsys,
                  WFMASH_TPU_DEVICE_L1="mesh")
    assert ref == mesh


def test_align_mesh_paf_equals_unsharded(align_pair, env, capsys):
    """The segmented composition on the CPU (WFMASH_TPU_SEGMENTED=1) with
    the tiers' chunks over eight shards and the mesh mapping, against one
    device and the host mapping."""
    monkeypatch, shards = env
    monkeypatch.setenv("WFMASH_TPU_SEGMENTED", "1")
    sharded, c = _run(port_cli.main, align_pair, monkeypatch, capsys,
                      WFMASH_TPU_DEVICE_L1="mesh",
                      WFMASH_TPU_ALIGN_MESH="force")
    assert sharded.count("\tcg:Z:") >= 2
    assert c["map.device_calls"] >= 1 and c["align.device_calls"] >= 1
    # every chunk went out over the eight shards, in one launch a range
    # that holds job rows
    assert len(shards) == c["align.device_calls"]
    assert all(n == 8 and 1 <= k <= 8 for n, k in shards)
    del shards[:]
    single, _ = _run(port_cli.main, align_pair, monkeypatch, capsys,
                     WFMASH_TPU_DEVICE_L1="0", WFMASH_TPU_ALIGN_MESH="0")
    assert single == sharded and not shards
    # auto shards over distinct cards only: eight CPU shards stay one
    auto, _ = _run(port_cli.main, align_pair, monkeypatch, capsys,
                   WFMASH_TPU_DEVICE_L1="1", WFMASH_TPU_ALIGN_MESH="auto")
    assert auto == sharded and not shards


def test_cli_mesh_equals_reference_cli(align_pair, env, capsys):
    """Both packages' CLIs end to end with the mesh routes asked for: the
    mesh mapping on each side, and each side's engine on a CPU host (the
    native BudgetedHostEngine; the reference's without its latency
    probe)."""
    monkeypatch, _ = env
    monkeypatch.setattr(
        ref_engine, "make_engine", lambda params: ref_engine
        .BudgetedHostEngine(Penalties(5, 8, 2, 24, 1), params))
    mesh_env = dict(WFMASH_TPU_DEVICE_L1="mesh",
                    WFMASH_TPU_ALIGN_MESH="force")
    port, c = _run(port_cli.main, align_pair, monkeypatch, capsys,
                   **mesh_env)
    assert port.count("\tcg:Z:") >= 2 and c["map.device_calls"] >= 1
    ref, _ = _run(ref_cli.main, align_pair, monkeypatch, capsys, **mesh_env)
    assert ref == port
