"""The port's align path as a whole (wfmash_tpu_torch: SegmentedEngine,
run_alignment, CLI) against the JAX package under the same composition,
the reference's on a local accelerator: SegmentedEngine over the segment
tiers with the exact sweep engine for escalations (JaxWfaEngine in Pallas
interpret mode there, ExactWfaEngine here), which shares the tiers for
its leaves.

The reference runs its Pallas kernel in interpret mode, with the first
two tier envelopes (K, smax, lseg) of its default table at small launch
shapes (PB, groups; a job's result does not depend on its chunk): the
deeper tiers cost minutes of interpret-mode compiles. test_torch_seg.py
holds the kernel function against the reference kernel at small shapes,
and chip_smoke.py holds all five tiers on the card. The port gets the
same table and runs the kernels' plain versions on the CPU; the CLI test
runs its default five tiers. Tolerance: exact (byte-equal CIGARs and
PAF).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wfmash_tpu.align import engine as ref_engine
from wfmash_tpu.align import segmented as S
from wfmash_tpu.align import wfa_pallas_seg as R
from wfmash_tpu.align.wfa_jax import JaxWfaEngine
from wfmash_tpu.align.wfa_np import EndsFree, Penalties
from wfmash_tpu.cli import parse_args
from wfmash_tpu.runner import run_mapping
from wfmash_tpu_torch import cli as port_cli
from wfmash_tpu_torch.align import engine as port_engine
from wfmash_tpu_torch.align import segmented as port_segmented
from wfmash_tpu_torch.align import wfa_seg
from wfmash_tpu_torch.align.segmented import SegmentedEngine
from wfmash_tpu_torch.align.wfa_exact import ExactWfaEngine
from wfmash_tpu_torch.device import resolve

from util import mutate, random_dna, revcomp, write_fasta

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = Penalties(5, 8, 2, 24, 1)
CPU = torch.device("cpu")


def _ref_solver(p, n_tiers=5):
    """The reference's first n_tiers envelopes at small launch shapes."""
    ref = R.TieredSegmentSolver(p, interpret=True)
    ref.tiers = tuple(
        R.SegmentSolver(p, interpret=True, PB=8, K=t.K, smax=t.smax,
                        lseg=t.lseg, groups=2) for t in ref.tiers[:n_tiers])
    return ref


def _ref_engine(p, threads=1, solver=None):
    exact = JaxWfaEngine(p, backend="pallas-interpret")
    exact.threads = threads
    return S.SegmentedEngine(p, exact, interpret=True,
                             solver=solver or _ref_solver(p))


def _blocks():
    """Blocks of tests/test_segmented.py plus boundary-patch jobs."""
    rng = np.random.default_rng(1)
    jobs = []
    t = random_dna(rng, 6000)
    jobs.append((mutate(rng, t, 0.05), t, None))              # segmented
    t = random_dna(rng, 400)
    jobs.append((mutate(rng, t, 0.05), t, None))              # small block
    t = random_dna(rng, 6000)
    q = t[:3000] + revcomp(t[3000:3400]) + t[3400:]
    jobs.append((q, t, None))                                 # inversion
    for i in range(2):
        t = random_dna(rng, 3000 + 500 * i)
        jobs.append((mutate(rng, t, 0.04), t, None))
    q1, t1 = jobs[0][0], jobs[0][1]
    jobs.append((q1[:180], t1[:195],
                 EndsFree(target_begin=195, query_begin=180)))
    jobs.append((q1[-170:], t1[-150:],
                 EndsFree(target_end=150, query_end=170)))
    return jobs


def test_segmented_engine_matches_reference():
    """Tiers t1-t2 on both sides: the inverted piece fails both and takes
    the banded / exact route (deeper tiers are held against the reference
    kernel in test_torch_seg.py)."""
    jobs = _blocks()
    ref_solver = _ref_solver(PATCH, n_tiers=2)
    ref = _ref_engine(PATCH, solver=ref_solver)
    port = SegmentedEngine(
        PATCH, ExactWfaEngine.from_reference(ref.exact, CPU), CPU,
        solver=wfa_seg.TieredSegmentSolver.from_reference(ref_solver, CPU))
    assert port.exact.seg_solver is port.solver
    assert (port.exact.HOST_LEN, port.exact.banded_leaves) == (
        ref.exact.HOST_LEN, ref.exact.banded_leaves) == (1900, True)
    got_ref = ref.align_batch(jobs)
    got = port.align_batch(jobs)
    assert got == got_ref
    assert all(ops is not None for ops in got)
    assert port.inversions == ref.inversions and port.inversions
    assert port.stats == ref.stats
    assert port.stats["segments"] > 20


def _routed_blocks():
    """Blocks whose pieces take routes that _blocks() does not reach: a
    1.5 kb deletion and a 2 kb insertion, each leaving a skewed piece past
    the tiers' ends-free envelope (the short side placed inside the long
    one, the middle on the tiers; both directions), and a clean 223 bp
    deletion, whose piece t2 holds only at its band's edge with a banded
    score above 3x the certificate: a tier reject, escalated."""
    rng = np.random.default_rng(11)
    t = random_dna(rng, 7000)
    jobs = [(mutate(rng, t[:3000], 0.02) + mutate(rng, t[4500:], 0.02), t,
             None)]
    t = random_dna(rng, 6000)
    jobs.append((mutate(rng, t[:3000], 0.02) + random_dna(rng, 2000)
                 + mutate(rng, t[3000:], 0.02), t, None))
    t = random_dna(rng, 5000)
    jobs.append((t[:2500] + t[2723:], t, None))
    return jobs


def test_segmented_engine_placed_and_escalated_routes(monkeypatch):
    """Tiers t1-t2 on both sides, as above, on _routed_blocks(): the
    placed middles and the tier reject give the reference's CIGARs and
    stats, and each route is taken (placements found, pieces
    escalated)."""
    placed = []
    place = port_segmented._place_short

    def spy(*args, **kwargs):
        placed.append(place(*args, **kwargs))
        return placed[-1]

    monkeypatch.setattr(port_segmented, "_place_short", spy)
    jobs = _routed_blocks()
    ref_solver = _ref_solver(PATCH, n_tiers=2)
    ref = _ref_engine(PATCH, solver=ref_solver)
    port = SegmentedEngine(
        PATCH, ExactWfaEngine.from_reference(ref.exact, CPU), CPU,
        solver=wfa_seg.TieredSegmentSolver.from_reference(ref_solver, CPU))
    got_ref = ref.align_batch(jobs)
    got = port.align_batch(jobs)
    assert got == got_ref
    assert all(ops is not None for ops in got)
    assert port.inversions == ref.inversions
    assert port.stats == ref.stats
    assert sum(off is not None for off in placed) >= 2
    assert port.stats["escalated"] > 0


@pytest.fixture(autouse=True)
def _engine_env(monkeypatch):
    """These tests choose their engines themselves: other test modules
    set the engine switches in os.environ when they are imported, and
    every worker imports every module. They run the card's default
    composition on the CPU, which takes WFMASH_TPU_SEGMENTED=1 there
    (auto on the CPU device is the native host engine)."""
    monkeypatch.delenv("WFMASH_TPU_WFA_ENGINE", raising=False)
    monkeypatch.setenv("WFMASH_TPU_SEGMENTED", "1")


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """A 20 kb pair with SNPs and two indels, and its mapping PAF: the CLI
    arguments that align it (-i)."""
    d = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(7)
    t = random_dna(rng, 20_000)
    q = (mutate(rng, t[:9_000], 0.01) + mutate(rng, t[9_040:15_000], 0.02)
         + random_dna(rng, 60) + mutate(rng, t[15_000:], 0.01))
    tfa, qfa, mpaf = str(d / "t.fa"), str(d / "q.fa"), str(d / "m.paf")
    write_fasta(tfa, {"t1": t})
    write_fasta(qfa, {"q1": q})
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv("WFMASH_TPU_DEVICE_L1", "0")
        mp, _, _, _ = parse_args([tfa, qfa, "-t", "1"])
        with open(mpaf, "w") as fh:
            run_mapping(mp, fh)
    return [tfa, qfa, "-t", "1", "-i", mpaf]


def _port_paf(args):
    _, ap, _, _ = parse_args(args)
    out = io.StringIO()
    port_engine.run_alignment(ap, out, CPU)
    return out.getvalue()


def test_run_alignment_paf_matches_reference(mapped, monkeypatch):
    """Both run_alignment functions on the same mapping PAF, each with its
    own make_engine and the t1-t2 envelopes (the record-end pieces and
    patches that would go deeper escalate to the exact engine on both
    sides)."""
    ref_solver = _ref_solver(PATCH, n_tiers=2)
    monkeypatch.setattr(ref_engine, "make_engine", lambda params:
                        _ref_engine(PATCH, params.threads, ref_solver))
    monkeypatch.setattr(
        port_segmented, "TieredSegmentSolver", lambda p, device:
        wfa_seg.TieredSegmentSolver.from_reference(ref_solver, device))
    _, ap, _, _ = parse_args(mapped)
    out = io.StringIO()
    ref_engine.run_alignment(ap, out)
    ref_paf = out.getvalue()
    rows = ref_paf.splitlines()
    assert len(rows) >= 2 and all("\tcg:Z:" in r for r in rows)
    assert _port_paf(mapped) == ref_paf


def test_cli_with_jax_blocked(mapped):
    """The CLI in a process where importing jax fails: exit 0 and the PAF
    of the port's run_alignment in this process (default tiers)."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['wfmash_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('wfmash_tpu_torch', run_name='__main__')\n")
    r = subprocess.run(
        [sys.executable, "-c", code, *mapped], capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO,
                                         WFMASH_TPU_TORCH_DEVICE="cpu",
                                         WFMASH_TPU_PERF="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == _port_paf(mapped)
    assert r.stdout.count("\tcg:Z:") >= 2
    # the CPU device runs the plain versions: no kernel launch
    assert "seg_wfa kernel launches = 0" in r.stderr


def test_cli_without_cuda_device_exits_nonzero(mapped, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cuda")
    assert port_cli.main(mapped) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert wfa_seg.LAUNCHES == 0


def test_device_resolution(monkeypatch):
    assert resolve("cpu") == CPU
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    assert resolve() == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve("cuda")
