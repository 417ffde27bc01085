"""The port's exact engine (wfmash_tpu_torch.align.wfa_exact.ExactWfaEngine
over wfa_sweep and wfa_seg, plain versions on the CPU) against the JAX
package's JaxWfaEngine(backend="pallas-interpret"), built with the same
small settings and carried across by from_reference; then the slice as a
whole: the port's CLI with WFMASH_TPU_SEGMENTED=0 against the reference's
run_alignment on the same mapping PAF.

Both sides get the first two segment-tier envelopes at small launch
shapes (a job's result does not depend on its chunk; the deeper tiers
cost minutes of interpret-mode compiles), and the whole-path test caps
the span ladder at 1024 on both sides to keep the interpret-mode sweeps
short. Tolerance: exact (equal ops lists, byte-equal PAF); every score
equals the O(nm) oracle dp_align.
"""

import io

import numpy as np
import pytest
import torch

from wfmash_tpu.align import cigar as C
from wfmash_tpu.align import engine as ref_engine
from wfmash_tpu.align.wfa_jax import JaxWfaEngine
from wfmash_tpu.align.wfa_np import Penalties, dp_align, score_cigar
from wfmash_tpu.cli import parse_args
from wfmash_tpu_torch import cli as port_cli
from wfmash_tpu_torch.align import engine as port_engine
from wfmash_tpu_torch.align import wfa_exact, wfa_seg, wfa_sweep
from wfmash_tpu_torch.align.biwfa import HostWfaEngine
from wfmash_tpu_torch.align.segmented import SegmentedEngine
from wfmash_tpu_torch.align.wfa_exact import ExactWfaEngine

from test_torch_slice import (_engine_env, _ref_solver,  # noqa: F401
                              mapped)                     # (fixtures)
from test_wfa import make_pair
from util import random_dna

torch.set_num_threads(1)

PATCH = Penalties(5, 8, 2, 24, 1)
CPU = torch.device("cpu")


def _both(ref):
    """The reference engine with small tiers installed, and the port's
    engine carried across from it."""
    ref.seg_solver = _ref_solver(ref.p, n_tiers=2)
    port = ExactWfaEngine.from_reference(
        ref, CPU,
        seg_solver=wfa_seg.TieredSegmentSolver.from_reference(
            ref.seg_solver, CPU))
    for k in ("p", "batch_size", "HOST_LEN", "HOST_CELLS", "MAX_SPAN",
              "seg_min_batch", "banded_leaves", "threads"):
        assert getattr(port, k) == getattr(ref, k), k
    return ref, port


def _small_jobs():
    rng = np.random.default_rng(5)
    jobs = []
    for n in (160, 240, 420, 900):
        q, t = make_pair(rng, n, sub=0.05, indel=0.01, max_indel=5)
        jobs.append((q, t, None))
    q, t = make_pair(rng, 300, sub=0.03, indel=0.0)
    jobs.append((t, t, None))                      # perfect match
    jobs.append((q[:90], t[:80], None))            # below host_len
    return jobs


def _escalation_jobs():
    """tests/test_wfa_pallas.py::test_pallas_span_escalation's block: a
    balanced 300 bp excursion that leaves the K = 512 band."""
    rng = np.random.default_rng(21)
    s = random_dna(rng, 700)
    ins, jns = random_dna(rng, 300), random_dna(rng, 300)
    return [(s[:200] + ins + s[200:], s[:500] + jns + s[500:], None)]


@pytest.mark.parametrize("case", ["small-span", "span-escalation"])
def test_exact_engine_matches_reference(case, capfd):
    if case == "small-span":
        jobs, max_span = _small_jobs(), 257
    else:
        jobs, max_span = _escalation_jobs(), 4097
    ref, port = _both(JaxWfaEngine(
        PATCH, batch_size=4, host_len=100, max_span=max_span,
        backend="pallas-interpret"))
    want = ref.align_batch(jobs)
    capfd.readouterr()
    got = port.align_batch(jobs)
    err = capfd.readouterr().err
    assert got == want
    for (q, t, _), ops in zip(jobs, got):
        assert C.validate(ops, q, t, 0, 0)
        assert score_cigar(ops, PATCH) == dp_align(q, t, PATCH)
    assert port.sweeps.levels > 0
    assert ("span escalation" in err) == (case == "span-escalation")
    assert wfa_sweep.LAUNCHES == 0 and wfa_seg.LAUNCHES == 0   # CPU: plain


def test_from_reference_and_single_align():
    ref = JaxWfaEngine(PATCH, batch_size=7, host_len=321, max_span=1025,
                       backend="pallas-interpret")
    ref.HOST_CELLS, ref.seg_min_batch, ref.threads = 5000, 2, 3
    ref.banded_leaves = True
    _, port = _both(ref)
    assert port.device == CPU and port.sweeps.p == PATCH
    rng = np.random.default_rng(3)
    q, t = make_pair(rng, 200, sub=0.05, indel=0.01, max_indel=4)
    ops = port.align(q, t)                 # below host_len: host WFA
    assert C.validate(ops, q, t, 0, 0)
    assert score_cigar(ops, PATCH) == dp_align(q, t, PATCH)
    assert port.sweeps.levels == 0


@pytest.mark.parametrize("env,kind", [
    ({"WFMASH_TPU_WFA_ENGINE": "host"}, HostWfaEngine),
    ({"WFMASH_TPU_SEGMENTED": "0"}, ExactWfaEngine),
    ({}, port_engine.BudgetedHostEngine),     # auto on the CPU device
    ({"WFMASH_TPU_SEGMENTED": "1"}, SegmentedEngine),
])
def test_make_engine_choices(env, kind, monkeypatch):
    for k in ("WFMASH_TPU_WFA_ENGINE", "WFMASH_TPU_SEGMENTED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, ap, _, _ = parse_args(["t.fa", "q.fa", "-t", "3"])
    eng = port_engine.make_engine(ap, CPU)
    assert type(eng) is kind
    assert eng.threads == 3
    if kind is SegmentedEngine:
        # the reference's composition: the exact engine shares the tiers
        # and takes the segmented engine's leaf policy
        assert type(eng.exact) is ExactWfaEngine
        assert eng.exact.seg_solver is eng.solver
        assert eng.exact.HOST_LEN == 1900
        assert eng.exact.banded_leaves is True
        assert eng.exact.device == CPU


def test_cli_segmented0_paf_matches_reference(mapped, monkeypatch, capsys):
    """WFMASH_TPU_SEGMENTED=0: the port's CLI (ExactWfaEngine alone) and
    the reference's run_alignment with JaxWfaEngine in Pallas interpret
    mode, on the 20 kb pair's mapping PAF: byte-equal."""
    ref_solver = _ref_solver(PATCH, n_tiers=2)

    def ref_make(params):
        eng = JaxWfaEngine(PATCH, max_span=1025, backend="pallas-interpret")
        eng.threads = params.threads
        eng.seg_solver = ref_solver
        return eng

    monkeypatch.setattr(ref_engine, "make_engine", ref_make)
    _, ap, _, _ = parse_args(mapped)
    out = io.StringIO()
    ref_engine.run_alignment(ap, out)
    ref_paf = out.getvalue()
    assert ref_paf.count("\tcg:Z:") >= 2

    made = []

    class Capped(ExactWfaEngine):
        def __init__(self, penalties, device):
            super().__init__(
                penalties, device, max_span=1025,
                seg_solver=wfa_seg.TieredSegmentSolver.from_reference(
                    ref_solver, device))
            made.append(self)

    monkeypatch.setattr(port_engine, "ExactWfaEngine", Capped)
    monkeypatch.setenv("WFMASH_TPU_SEGMENTED", "0")
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    capsys.readouterr()
    assert port_cli.main(mapped) == 0
    assert capsys.readouterr().out == ref_paf
    assert len(made) == 1 and made[0].sweeps.levels > 0
    assert type(made[0]) is Capped and wfa_exact.MAX_LEN == 65535


def test_cli_default_on_cpu_matches_reference_host_engine(
        mapped, monkeypatch, capsys):
    """The default switches on the CPU device: the port's CLI takes the
    reference's "no accelerator" branch (BudgetedHostEngine) and writes
    the PAF the reference's run_alignment writes with its own."""
    monkeypatch.delenv("WFMASH_TPU_SEGMENTED")
    monkeypatch.setattr(
        ref_engine, "make_engine",
        lambda params: ref_engine.BudgetedHostEngine(PATCH, params))
    _, ap, _, _ = parse_args(mapped)
    out = io.StringIO()
    ref_engine.run_alignment(ap, out)
    ref_paf = out.getvalue()
    assert ref_paf.count("\tcg:Z:") >= 2
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    capsys.readouterr()
    assert port_cli.main(mapped) == 0
    got = capsys.readouterr()
    assert got.out == ref_paf
    assert "no accelerator; using the native engine" in got.err


def test_budgeted_host_engine_matches_reference(monkeypatch):
    """The port's copy of BudgetedHostEngine: batch results equal the
    reference's on main blocks of every routing class and ends-free
    patches, and the memory-budget reroute lands on the port's own
    engines (SegmentedEngine over ExactWfaEngine on the given device)."""
    from wfmash_tpu.align.biwfa import EndsFree
    from wfmash_tpu.params import AlignParams
    from wfmash_tpu_torch import native as port_native

    ap = AlignParams(ref_sequences=["x"], query_sequences=["y"]
                     ).finalize(1000)
    rng = np.random.default_rng(23)

    def seqs(n, d):
        t = random_dna(rng, n)
        q = bytearray(t)
        for _ in range(int(n * d)):
            q[int(rng.integers(0, n))] = b"ACGT"[int(rng.integers(0, 4))]
        return bytes(q), t

    jobs = [(*seqs(3000, 0.002), None), (*seqs(3000, 0.15), None),
            (*seqs(800, 0.1), None)]
    q, t = seqs(900, 0.1)
    jobs += [(q, t, EndsFree(target_begin=len(t), query_begin=len(q))),
             (q, t, EndsFree(target_end=len(t), query_end=len(q))),
             (random_dna(rng, 2500), random_dna(rng, 2500), None)]
    ref = ref_engine.BudgetedHostEngine(PATCH, ap)
    port = port_engine.BudgetedHostEngine(PATCH, ap, CPU)
    assert port.align_batch(jobs) == ref.align_batch(jobs)

    monkeypatch.setenv("WFMASH_TPU_WFA_MEM_MB", "8")
    q, t = make_pair(rng, 4000, sub=0.15, indel=0.02)
    with pytest.raises(port_native.WfaMemoryBudget):
        port_native.wfa_align_ops_native(q, t, PATCH)
    assert C.validate(port.align(q, t), q, t, 0, 0)   # capped probe route
    ops = port._exact_or_reroute(q, t)                # over budget: reroute
    assert C.validate(ops, q, t, 0, 0)
    assert type(port._full) is SegmentedEngine
    assert type(port._full.exact) is ExactWfaEngine
    assert port._full.exact.device == CPU
