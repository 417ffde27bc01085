"""The native tier-chunk pack (wfmash_tpu_torch/native/tierpack.cpp)
against its Python spec, SegmentSolver.pack_chunk_py.

Every chunk buffer, certificate bound and always-flag must be equal byte
for byte: on all five tier envelopes and a small one, on seeded job mixes
with every ends-free span, skews whose band centre lies below zero (the
floor-division case), caps absent, above and below the tier's smax, full,
partial and empty chunks, the per-chunk remap of other bytes and the
give-up past 14 symbols. The reference's own buffer goes through the
native path; a UBSAN build packs clean; and a CPU `-i` run packs every
chunk natively, while the same run without the library writes the same
PAF through the spec.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from util import mutate, random_dna, write_fasta
from wfmash_tpu_torch import cli, native
from wfmash_tpu_torch.align import wfa_seg as T
from wfmash_tpu_torch.align.wfa_np import EndsFree, Penalties
from wfmash_tpu_torch.utils import perf

PATCH = Penalties(5, 8, 2, 24, 1)
SMALL = (4, 64, 64, 256, 2)          # tests/test_torch_seg.py's SMALL
ENVELOPES = T.TIERS + (SMALL,)
ENV_IDS = [f"t{i + 1}" for i in range(len(T.TIERS))] + ["small"]


def _solver(env):
    pb, k, smax, lseg, groups = env
    return T.SegmentSolver(PATCH, "cpu", PB=pb, K=k, smax=smax, lseg=lseg,
                           groups=groups)


def _ends_free(rng, kind, K):
    """None, or an EndsFree with the begin spans, the end spans or all
    four, each drawn up to 2K (wide spans leave one hull out of band)."""
    if kind == 0:
        return None
    v = [int(x) for x in rng.integers(0, 2 * K, 4)]
    if kind == 1:
        return EndsFree(target_begin=v[0], query_begin=v[1])
    if kind == 2:
        return EndsFree(target_end=v[2], query_end=v[3])
    return EndsFree(target_begin=v[0], query_begin=v[1], target_end=v[2],
                    query_end=v[3])


def _mix(rng, sol, nj):
    """(jobs, caps): nj jobs the envelope holds. The first are fixed
    skews (target longer by an odd count: the band centre's floor
    division at a negative sum) and empty sides; the rest are drawn."""
    K, lseg, smax = sol.K, sol.lseg, sol.smax
    jobs, caps = [], []
    fixed = [(100, 103, None), (60, 61, None), (0, 7, None), (9, 0, None),
             (0, 0, None), (50, 87, EndsFree(target_end=5, query_end=2))]
    for m, n, ef in fixed[:nj]:
        assert sol.accepts(m, n, ef)
        t = random_dna(rng, n)
        jobs.append((mutate(rng, t[:m] + random_dna(rng, max(0, m - n)),
                            0.05), t, ef))
        caps.append(None)
    while len(jobs) < nj:
        n = int(rng.integers(1, lseg - 1))
        m = max(1, n + int(rng.integers(-K // 2, K // 2)))
        ef = _ends_free(rng, int(rng.integers(0, 4)), K)
        if not sol.accepts(m, n, ef):
            continue
        t = random_dna(rng, n)
        q = mutate(rng, (t * 2)[:m], 0.03)
        jobs.append((q, t, ef))
        c = int(rng.integers(0, 3))
        caps.append(None if c == 0 else
                    smax + int(rng.integers(1, 100)) if c == 1 else
                    int(rng.integers(1, smax)))
    return jobs, caps


def _pack_both(sol, jobs, caps):
    idxs = list(range(len(jobs)))
    before = perf.get("align.tier.pack_native")
    got = sol.pack_chunk(idxs, jobs, caps)
    assert perf.get("align.tier.pack_native") == before + 1
    return got, sol.pack_chunk_py(idxs, jobs, caps)


def _assert_same(got, want):
    (buf, meta), (buf_py, meta_py) = got, want
    if buf_py is None:
        assert buf is None and meta["give_up"] and meta_py["give_up"]
        return
    assert buf.dtype == np.uint8 and buf.shape == buf_py.shape
    np.testing.assert_array_equal(buf, buf_py)
    np.testing.assert_array_equal(meta["cert_b"], meta_py["cert_b"])
    np.testing.assert_array_equal(meta["cert_always"],
                                  meta_py["cert_always"])
    assert meta["cert_b"].dtype == meta_py["cert_b"].dtype
    assert meta["cert_always"].dtype == meta_py["cert_always"].dtype


@pytest.mark.parametrize("env", ENVELOPES, ids=ENV_IDS)
@pytest.mark.parametrize("fill", ["full", "partial", "empty"])
def test_native_pack_matches_python_spec(env, fill):
    sol = _solver(env)
    B = sol.groups * sol.PB
    nj = {"full": B, "partial": max(1, B // 3 - 1), "empty": 0}[fill]
    rng = np.random.default_rng(
        [ENVELOPES.index(env), ["full", "partial", "empty"].index(fill)])
    jobs, caps = _mix(rng, sol, nj)
    got, want = _pack_both(sol, jobs, caps)
    _assert_same(got, want)
    if fill == "empty":
        return
    par = want[0][:, sol.lseg:].copy().view("<i4")[:nj]
    # the mix reaches what it is meant to: a centre below zero, each
    # ends-free span, capped and uncapped rows, both certificate kinds
    assert (par[:, 3] > 0).any()
    if fill == "full" and B >= 64:
        for col in (4, 5, 6, 7):
            assert (par[:, col] > 0).any(), col
        assert (par[:, 8] == 0).any() and (par[:, 8] == sol.smax).any()
        assert ((par[:, 8] > 0) & (par[:, 8] < sol.smax)).any()
        assert want[1]["cert_always"].any()
        assert not want[1]["cert_always"][:nj].all()


@pytest.mark.parametrize("env", [T.TIERS[0], SMALL], ids=["t1", "small"])
def test_native_pack_remaps_other_bytes_and_gives_up(env):
    sol = _solver(env)
    rng = np.random.default_rng(5)
    jobs, caps = _mix(rng, sol, min(40, sol.groups * sol.PB))
    # lower case and IUPAC codes: every byte present gets a code
    odd = []
    for q, t, ef in jobs:
        q = bytearray(q)
        if len(q) > 6:
            q[1:3] = b"ac"
            q[4:6] = b"RY"
        odd.append((bytes(q), t.lower() if len(t) % 2 else t, ef))
    got, want = _pack_both(sol, odd, caps)
    assert want[0] is not None
    _assert_same(got, want)
    # 15 distinct bytes and more: the chunk gives up
    many = list(odd)
    many[0] = (bytes(range(65, 80)) + many[0][0][15:], *many[0][1:])
    got, want = _pack_both(sol, many, caps)
    assert want[0] is None
    _assert_same(got, want)


def test_native_pack_leaves_what_it_cannot_pack_to_the_spec():
    """A parameter that leaves int32 goes to the spec, which refuses it
    as before; the native counter does not move."""
    sol = _solver(SMALL)
    q = random_dna(np.random.default_rng(1), 30)
    jobs = [(q, q, EndsFree(target_end=1 << 40))]
    before = perf.get("align.tier.pack_native")
    with pytest.raises(OverflowError):
        sol.pack_chunk([0], jobs, None)
    with pytest.raises(OverflowError):
        sol.pack_chunk_py([0], jobs, None)
    assert perf.get("align.tier.pack_native") == before


def test_pack_chunk_matches_reference_buffer_natively(monkeypatch):
    """test_torch_seg's reference-buffer mix through the native path: the
    buffer the reference uploads, byte for byte, with the counter
    showing the native call packed it."""
    from wfmash_tpu.align import wfa_pallas_seg as R
    from wfmash_tpu.align.wfa_np import Penalties as RefPenalties
    from test_torch_seg import _job_mix

    rng = np.random.default_rng(22)
    jobs, caps = _job_mix(rng)
    got = {}

    def capture(buf, **kw):
        got["buf"] = np.asarray(buf)
        B = buf.shape[0]
        return (np.zeros((B, kw["maxr"]), np.int32),
                np.zeros((B // kw["PB"], kw["PB"], 16 + 128), np.int16))

    monkeypatch.setattr(R, "_run_seg", capture)
    small = dict(zip(("PB", "K", "smax", "lseg", "groups"), SMALL))
    R.SegmentSolver(RefPenalties(5, 8, 2, 24, 1), interpret=True,
                    **small)._dispatch_chunk(list(range(len(jobs))), jobs,
                                             caps)
    before = perf.get("align.tier.pack_native")
    buf, meta = T.SegmentSolver(PATCH, "cpu", **small).pack_chunk(
        list(range(len(jobs))), jobs, caps)
    assert perf.get("align.tier.pack_native") == before + 1
    np.testing.assert_array_equal(got["buf"], buf)


def test_tierpack_ubsan_clean():
    """The library built with WFMASH_TPU_SANITIZE=1 (UBSAN, aborting on
    any undefined behaviour) packs full, partial, remapped and given-up
    chunks of three envelopes equal to the spec, in its own process."""
    prog = r"""
import numpy as np
import test_torch_pack as P
from wfmash_tpu_torch import native
from wfmash_tpu_torch.align import wfa_seg as T

assert native._LIB6.name == "_tierpack.san.so"
for k, env in enumerate((T.TIERS[0], T.TIERS[3], P.SMALL)):
    sol = P._solver(env)
    B = sol.groups * sol.PB
    for nj in (B, B // 2, 0):
        jobs, caps = P._mix(np.random.default_rng([k, nj]), sol, nj)
        P._assert_same(*P._pack_both(sol, jobs, caps))
P.test_native_pack_remaps_other_bytes_and_gives_up(P.SMALL)
print("UBSAN-OK")
"""
    tests = Path(__file__).parent
    env = dict(os.environ, WFMASH_TPU_SANITIZE="1",
               UBSAN_OPTIONS="print_stacktrace=1",
               PYTHONPATH=os.pathsep.join(
                   [str(tests), str(tests.parent),
                    os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       cwd=str(tests.parent), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    assert "UBSAN-OK" in r.stdout
    assert "runtime error" not in r.stderr, r.stderr[-2000:]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 14 kb target, a query with SNPs and an insertion, and the
    mapping PAF from the port's own `-m` run."""
    d = tmp_path_factory.mktemp("pack")
    rng = np.random.default_rng(17)
    t = random_dna(rng, 14_000)
    q = (mutate(rng, t[:8_000], 0.01) + random_dna(rng, 40)
         + mutate(rng, t[8_000:], 0.02))
    write_fasta(d / "t.fa", {"t1": t})
    write_fasta(d / "q.fa", {"q1": q})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
        mp.setenv("WFMASH_TPU_DEVICE_L1", "0")
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main([str(d / "t.fa"), str(d / "q.fa"), "-m"]) == 0
    (d / "m.paf").write_text(buf.getvalue())
    assert buf.getvalue().count("\n") >= 1
    return d


def _align(pair, monkeypatch):
    for k in list(os.environ):
        if k.startswith("WFMASH_TPU_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("WFMASH_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WFMASH_TPU_SEGMENTED", "1")
    perf.reset()
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main([str(pair / "t.fa"), str(pair / "q.fa"),
                         "-i", str(pair / "m.paf")]) == 0
    return buf.getvalue(), perf.snapshot()


def test_align_run_packs_every_chunk_natively(pair, monkeypatch):
    paf, snap = _align(pair, monkeypatch)
    assert "\tcg:Z:" in paf
    assert snap["align.device_calls"] >= 1
    assert snap["align.tier.pack_native"] == snap["align.device_calls"]
    # without the library the spec packs: the same PAF bytes
    monkeypatch.setattr(native, "get_tierpack_lib", lambda: None)
    paf_py, snap_py = _align(pair, monkeypatch)
    assert paf_py == paf
    assert snap_py.get("align.tier.pack_native", 0) == 0
    assert snap_py["align.device_calls"] == snap["align.device_calls"]
