"""The port's multi-device paths (wfmash_tpu_torch/parallel/, the sharded
segment tiers) over eight logical CPU shards, against the JAX package on
its eight virtual CPU devices (tests/conftest.py) and against the same
computations unsharded. The counterparts of tests/test_multichip.py.

Inputs are made from seeds with numpy and handed to both packages; the
reference's sequences go in as `_pack_words` words, the port's as the
same bytes. Tolerance: none; rings, counts, candidate rows, CIGARs and
kernel outputs are compared exactly.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from wfmash_tpu.align.wfa_jax import (NEG_I, _advance, _pack_words,
                                      make_blocks, ring_size)
from wfmash_tpu.align.wfa_np import Penalties
from wfmash_tpu.parallel import mesh as RM
from wfmash_tpu_torch.align import wfa_np as port_np
from wfmash_tpu_torch.align import wfa_seg
from wfmash_tpu_torch.align.wfa_sweep import advance_torch
from wfmash_tpu_torch.parallel import dryrun
from wfmash_tpu_torch.parallel import mesh as PM

from util import mutate, random_dna

CPU8 = [torch.device("cpu")] * 8
PENALTIES = {"patch": (5, 8, 2, 24, 1), "wflign": (2, 3, 1, 3, 1)}
_step = jax.jit(_advance, static_argnames=("K", "R", "penalties"))


def _both(pen):
    return Penalties(*pen), port_np.Penalties(*pen)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(seed, L, K):
    """Four problems in (4, L) byte rows: the reference test's two
    mismatch-dense ones and two short ones with a few edits that finish
    inside 48 levels; bytes past each length are random."""
    rng = np.random.default_rng(seed)
    q = rng.integers(65, 69, (4, L), dtype=np.uint8)
    t = q.copy()
    t[:2, ::11] = 65
    t[:2, ::29] = 67
    qlen = np.array([L - 8, L - 8, 90, 120], np.int32)
    tlen = np.array([L - 12, L - 12, 88, 123], np.int32)
    for r, edits in ((2, ((30, 2),)), (3, ((20, -3),))):
        for pos, shift in edits:
            if shift > 0:      # the target lacks `shift` query bytes
                t[r, pos:L - shift] = q[r, pos + shift:]
            else:              # the target has -shift extra bytes
                t[r, pos - shift:] = q[r, pos:L + shift]
        t[r, 60] = 65 if q[r, 60] != 65 else 67
    return q, t, qlen, tlen


def _state(B, R, K):
    off = np.full((B, R, 5, K), NEG_I, np.int32)
    off[:, 0, 0, K // 2] = 0
    return (off, np.full((B, R, 5, K), -1, np.int32),
            np.full((B, R, 5, K), -1, np.int32),
            np.full((B, R, 4, K), -1, np.int32))


@pytest.mark.parametrize("axis", ["target", "query"])
@pytest.mark.parametrize("pen", sorted(PENALTIES))
def test_advance_torch_equals_advance(pen, axis):
    """48 levels, all seven outputs after every level, bit for bit."""
    rp, pp = _both(PENALTIES[pen])
    R, K, L = ring_size(rp), 256, 480
    q, t, qlen, tlen = _rows(0, L, K)
    axis_q = np.full(4, axis == "query")
    mid = np.where(axis_q, qlen // 2, tlen // 2).astype(np.int32)
    ref = tuple(jnp.asarray(a) for a in _state(4, R, K))
    got = tuple(_t(a) for a in _state(4, R, K))
    qb, tb = make_blocks(jnp.asarray(_pack_words(q))), \
        make_blocks(jnp.asarray(_pack_words(t)))
    finished = np.zeros(4, bool)
    for s in range(1, 49):
        r = _step(*ref, jnp.int32(s), qb, tb, jnp.asarray(qlen),
                  jnp.asarray(tlen), jnp.asarray(axis_q), jnp.asarray(mid),
                  K=K, R=R, penalties=rp)
        g = advance_torch(*got, s, _t(q), _t(t), _t(qlen), _t(tlen),
                          _t(axis_q), _t(mid), K, R, pp)
        for a, b in zip(r, g):
            assert np.array_equal(np.asarray(a), b.numpy()), s
        ref, got = r[:4], g[:4]
        finished |= np.asarray(r[4])
    assert finished[2:].all() and not finished[:2].any()


@pytest.mark.parametrize("window", ["holds-end-diagonal", "misses-it"])
def test_advance_torch_kvec_window(window):
    """A shard's window (kvec = its global diagonals, halo lanes
    included): all seven outputs equal the reference's _advance with the
    same kvec, whether or not the window holds the end diagonal that
    `done` and the final anchor are read from (d_end is window-local)."""
    rp, pp = _both(PENALTIES["patch"])
    R, K, L = ring_size(rp), 256, 480
    q, t, qlen, tlen = _rows(1, L, K)
    axis_q = np.zeros(4, bool)
    mid = (tlen // 2).astype(np.int32)
    st = tuple(_t(a) for a in _state(4, R, K))
    seq = (_t(q), _t(t), _t(qlen), _t(tlen), _t(axis_q), _t(mid))
    for s in range(1, 40):
        st = advance_torch(*st, s, *seq, K, R, pp)[:4]
    end_lane = int(qlen[3] - tlen[3]) + K // 2
    a = end_lane - 20 if window == "holds-end-diagonal" else end_lane + 5
    lanes = slice(a - 1, a + 33)
    kvec = (np.arange(a - 1, a + 33, dtype=np.int32) - K // 2)[None, :]
    win = [x[..., lanes].contiguous() for x in st]
    r = _step(*(jnp.asarray(x.numpy()) for x in win), jnp.int32(40),
              make_blocks(jnp.asarray(_pack_words(q))),
              make_blocks(jnp.asarray(_pack_words(t))), jnp.asarray(qlen),
              jnp.asarray(tlen), jnp.asarray(axis_q), jnp.asarray(mid),
              K=34, R=R, penalties=rp, kvec=jnp.asarray(kvec))
    g = advance_torch(*win, 40, *seq, 34, R, pp, kvec=_t(kvec))
    for x, y in zip(r, g):
        assert np.array_equal(np.asarray(x), y.numpy())
    holds = a - 1 <= end_lane < a + 33
    assert holds == (window == "holds-end-diagonal")


def test_diagonal_sharded_equals_unsharded_and_reference():
    """test_multichip.py's inputs: K = 256 split over 8 logical shards for
    48 levels, equal to the reference's unsharded _advance loop and to its
    diagonal_sharded_wfa_steps on 8 virtual devices, rings and anchors."""
    rp, pp = _both(PENALTIES["patch"])
    R = ring_size(rp)
    B, K, L = 2, 256, 480
    rng = np.random.default_rng(0)
    q = rng.integers(65, 69, (B, L), dtype=np.uint8)
    t = q.copy()
    t[:, ::11] = 65
    t[:, ::29] = 67
    qlen = np.full(B, L - 8, np.int32)
    tlen = np.full(B, L - 12, np.int32)
    axis_q = np.zeros(B, bool)
    mid = (tlen // 2).astype(np.int32)
    st = _state(B, R, K)
    qb, tb = make_blocks(jnp.asarray(_pack_words(q))), \
        make_blocks(jnp.asarray(_pack_words(t)))
    ref = tuple(jnp.asarray(a) for a in st)
    for s in range(1, 49):
        ref = _step(*ref, jnp.int32(s), qb, tb, jnp.asarray(qlen),
                    jnp.asarray(tlen), jnp.asarray(axis_q), jnp.asarray(mid),
                    K=K, R=R, penalties=rp)[:4]
    ref_sharded = RM.diagonal_sharded_wfa_steps(
        *(jnp.asarray(a) for a in st), jnp.asarray(_pack_words(q)),
        jnp.asarray(_pack_words(t)), jnp.asarray(qlen), jnp.asarray(tlen),
        jnp.asarray(axis_q), jnp.asarray(mid),
        JaxMesh(np.asarray(jax.devices()[:8]), ("data",)), 48, rp)
    got = PM.diagonal_sharded_wfa_steps(
        *(_t(a) for a in st), _t(q), _t(t), _t(qlen), _t(tlen), _t(axis_q),
        _t(mid), PM.Mesh(CPU8, ("data",)), 48, pp)
    for a, b, c in zip(ref, ref_sharded, got):
        assert np.array_equal(np.asarray(a), c.numpy())
        assert np.array_equal(np.asarray(b), c.numpy())
    assert (got[0].numpy() > NEG_I).sum() > 100
    with pytest.raises(ValueError, match="not divisible"):
        PM.diagonal_sharded_wfa_steps(
            *(_t(a)[..., :250] for a in st), _t(q), _t(t), _t(qlen),
            _t(tlen), _t(axis_q), _t(mid), PM.Mesh(CPU8, ("data",)), 2, pp)


def test_multichip_step_and_data_parallel_equal_unsharded_and_reference():
    rp, pp = _both(PENALTIES["patch"])
    fn, args = PM.multichip_step(PM.make_mesh(2, 4, CPU8), pp, n_steps=8)
    counts, off = fn(*args)
    # the unsharded runs: the same inputs on a (1, 1) mesh, and the
    # data-parallel advance over one data slot against four
    assert torch.equal(PM.data_parallel_wfa_steps(
        *args[:5], PM.make_mesh(1, 1, CPU8), 8, pp), off)
    assert torch.equal(PM.data_parallel_wfa_steps(
        *args[:5], PM.make_mesh(1, 4, CPU8), 8, pp), off)
    assert torch.equal(PM.sharded_hit_counts(
        args[5], args[6], PM.make_mesh(1, 1, CPU8)), counts)
    ref_fn, ref_args = RM.multichip_step(RM.make_mesh(2, 4), rp, n_steps=8)
    ref_counts, ref_off = ref_fn(*ref_args)
    assert np.array_equal(np.asarray(ref_counts), counts.numpy())
    assert np.array_equal(np.asarray(ref_off), off.numpy())
    assert np.array_equal(np.asarray(ref_args[0]), args[0].numpy())
    assert counts[0] >= args[5].shape[1] // 2
    assert (off != args[0]).any()


def test_sharded_hit_counts_match_oracle():
    rng = np.random.default_rng(1)
    B, S, H = 8, 32, 512
    qhash = rng.integers(0, 1 << 30, (B, S), dtype=np.uint32)
    ihash = np.sort(rng.integers(0, 1 << 30, (H,), dtype=np.uint32))
    for b in range(B):
        ihash[b * 16: b * 16 + b] = np.sort(qhash[b, :b])
    ihash = np.sort(ihash)
    counts = PM.sharded_hit_counts(_t(qhash), _t(ihash),
                                   PM.make_mesh(4, 2, CPU8))
    idx = np.clip(np.searchsorted(ihash, qhash), 0, H - 1)
    np.testing.assert_array_equal(counts.numpy(),
                                  (ihash[idx] == qhash).sum(axis=1))
    with pytest.raises(ValueError):
        PM.sharded_hit_counts(_t(qhash), _t(ihash[:510]),
                              PM.make_mesh(4, 2, CPU8))


@pytest.fixture(scope="module")
def l1_setup():
    """test_multichip.py:57-101's index, with 500 bp fragments and one
    300 bp tail fragment in seven (the host route)."""
    from wfmash_tpu.index.build import build_index
    from wfmash_tpu.map.stats import compute_sketch_cutoffs
    from wfmash_tpu.params import MapParams
    from wfmash_tpu.sketch.minhash import sketch_fragment

    from test_l1_device import host_candidates

    rng = np.random.default_rng(23)
    mp = MapParams(percentage_identity=0.85, auto_pct_identity=False,
                   window_length=500, kmer_size=15)
    mp.ref_sequences = mp.query_sequences = ["x"]
    mp = mp.finalize()
    base = random_dna(rng, 25_000)
    seqs = [(0, base), (1, base[4_000:20_000]),
            (2, random_dna(rng, 8_000))]
    index = build_index(mp, seqs, log=lambda m: None)
    group_arr = np.array([0, 1, 2], np.int32)
    cutoffs = compute_sketch_cutoffs(mp.sketch_size, mp.kmer_size, 0.0,
                                     0.999)
    frags, host = [], []
    for trial in range(40):
        start = int(rng.integers(0, 24_000))
        n = 300 if trial % 7 == 0 else 500
        fa = np.frombuffer(base[start:start + n], np.uint8).copy()
        mut = rng.random(len(fa)) < 0.03
        fa[mut] = rng.integers(65, 69, int(mut.sum()))
        sk = sketch_fragment(fa.tobytes(), mp.kmer_size, mp.sketch_size)
        if sk.sketch_size == 0:
            continue
        frags.append(dict(hashes=sk.hashes, n=sk.sketch_size, q_len=n,
                          q_seqid=99, q_group=99, min_hits=2))
        host.append(host_candidates(sk, n, index, 99, 99, group_arr, mp,
                                    cutoffs, 2))
    return index, group_arr, mp, cutoffs, frags, host


@pytest.mark.parametrize("cap", [4096, 160])
def test_sharded_l1_equals_reference_row_for_row(l1_setup, cap):
    """A (4, 2) mesh on both sides: the port's rows equal the reference
    ShardedDeviceL1's, None rows included, and the host L1 where they
    answer. At cap 160 a shard's cap is 40 endpoints: rows that one
    device answers overflow on the mesh and go to the host on both."""
    from wfmash_tpu_torch.map.l1_device import DeviceL1

    index, group_arr, mp, cutoffs, frags, host = l1_setup
    ref = RM.ShardedDeviceL1(index, group_arr, mp, cutoffs,
                             RM.make_mesh(4, 2), cap=cap)
    dev = PM.ShardedDeviceL1(index, group_arr, mp, cutoffs,
                             PM.make_mesh(4, 2, CPU8), cap=cap)
    got = dev.candidates(frags)
    assert got == ref.candidates(frags)
    assert dev.shard_ep_counts == ref.shard_ep_counts
    assert all(g == h for g, h in zip(got, host) if g is not None)
    single = DeviceL1(index, group_arr, mp, cutoffs, cap=cap,
                      device="cpu").candidates(frags)
    n_none = sum(g is None for g in got)
    tails = sum(f["q_len"] != 500 for f in frags)
    assert len(got) >= 35 and any(h for h in host)
    assert sum(g is not None and g != [] for g in got) >= 10
    if cap == 4096:
        assert n_none == tails and got == single
    else:
        assert n_none > sum(s is None for s in single) >= tails


def _solver_jobs():
    """End-to-end and ends-free jobs for the first three tiers, a few
    that escalate past tier 1, and trivial ones."""
    from wfmash_tpu_torch.align.wfa_np import EndsFree

    rng = np.random.default_rng(11)
    jobs = []
    for i in range(30):
        t = random_dna(rng, int(rng.integers(120, 260)))
        jobs.append((mutate(rng, t, 0.04), t, None))
    for i in range(6):
        t = random_dna(rng, int(rng.integers(80, 160)))
        q = mutate(rng, t, 0.05)
        ef = EndsFree(target_begin=len(t), query_begin=len(q)) if i % 2 \
            else EndsFree(target_end=len(t), query_end=len(q))
        jobs.append((q, t, ef))
    for n in (600, 900):       # past tier 1's lseg: tier 3
        t = random_dna(rng, n)
        jobs.append((mutate(rng, t, 0.03), t, None))
    t = random_dna(rng, 300)   # divergent: past tier 1's smax
    jobs.append((mutate(rng, t, 0.2), t, None))
    jobs += [(b"", t[:50], None), (b"ACGT", b"", None)]
    return jobs


def test_sharded_tiered_solver_equals_unsharded_and_wfa_np():
    p = port_np.Penalties(5, 8, 2, 24, 1)
    jobs = _solver_jobs()
    outs = []
    for mesh in (None, PM.Mesh(CPU8, ("data",))):
        solver = wfa_seg.TieredSegmentSolver(p, "cpu", mesh=mesh)
        assert all((t.mesh is None) == (mesh is None) for t in solver.tiers)
        st, unc = [], []
        outs.append((solver.solve(jobs, status=st, uncertified=unc), st,
                     unc))
    assert outs[0] == outs[1]
    res, st, _ = outs[1]
    n_ok = 0
    for (q, t, ef), ops, s in zip(jobs, res, st):
        if ops is not None:
            assert ops == port_np.wfa_align(q, t, p, ef)[1]
            n_ok += 1
    assert n_ok >= 38
    assert {s[1] for s in st} >= {128, 768}   # tiers 1 and 3 ran


def test_sharded_chunk_equals_unsharded_launch():
    """One tier-2 chunk (1024 rows, 64 groups) split over 8 devices: the
    ranges holding the chunk's 200 job rows (two of 128 rows) are
    launched, and their outputs equal the unsharded run's rows."""
    p = port_np.Penalties(5, 8, 2, 24, 1)
    tier = wfa_seg.TieredSegmentSolver(p, "cpu").tiers[1]
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(200):
        t = random_dna(rng, int(rng.integers(150, 300)))
        jobs.append((mutate(rng, t, 0.08), t, None))
    buf, _ = tier.pack_chunk(list(range(200)), jobs, None)
    kw = dict(penalties=p, K=tier.K, smax=tier.smax, maxr=tier.maxr)
    runs, out16 = wfa_seg._run_seg_sharded(buf, 200, CPU8, **kw)
    assert len(runs) == len(out16) == 2
    whole = wfa_seg.run_seg(torch.from_numpy(buf), **kw)
    got = (wfa_seg._host(runs), wfa_seg._host(out16))
    assert got[1].shape == (256, whole[1].shape[1])
    for a, b in zip(got, whole):
        assert np.array_equal(a[:200], b.numpy()[:200])


def test_tier_sharding_rule():
    """A tier shards only over more than one device that divides its
    groups (64, 64, 32, 16, 32)."""
    p = port_np.Penalties(5, 8, 2, 24, 1)
    for n, want in ((1, [False] * 5), (3, [False] * 5),
                    (32, [True, True, True, False, True]),
                    (8, [True] * 5)):
        s = wfa_seg.TieredSegmentSolver(
            p, "cpu", mesh=PM.Mesh([torch.device("cpu")] * n, ("data",)))
        assert [t.mesh is not None for t in s.tiers] == want, n


def test_mesh_shapes_and_devices(monkeypatch):
    m = PM.make_mesh(2, 4, CPU8)
    assert m.shape == {"shard": 2, "data": 4}
    assert m.axis_names == ("shard", "data")
    assert m.axis_devices("data") == CPU8[:4]
    assert PM.mesh_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        PM.make_mesh(4, 4, CPU8)
    monkeypatch.setattr(PM, "mesh_devices", lambda device=None: CPU8)
    assert PM.make_mesh(2, 4).shape == {"shard": 2, "data": 4}


def test_dryrun_multichip_on_cpu_shards(capsys):
    got = dryrun.dryrun_multichip(8, CPU8)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[wfmash-tpu] multichip dryrun OK on mesh "
                               "(shard=2, data=4)")
    assert lines[1].startswith("[wfmash-tpu] multichip balance: ")
    # the reference's dry run gives the same numbers on its 8 devices
    assert got["n_cand"] == 14 and got["n_live"] == 9
    assert got["n_solved"] == got["n_jobs"] == 17
    assert got["shard_ep_counts"] == [902, 902]
    assert got["wf_dev_lanes"] == [0, 0, 0, 4, 5, 0, 0, 0]
    assert got["align_dev_levels"][0] > 0


def test_entry_equals_graft_entry():
    """entry()'s 16 levels equal __graft_entry__.entry()'s, bit for bit."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    graft = importlib.import_module("__graft_entry__")
    rfn, rargs = graft.entry()
    want = np.asarray(jax.jit(rfn)(*rargs))
    fn, args = dryrun.entry("cpu")
    got = fn(*args)
    assert got.shape == (8, ring_size(Penalties(5, 8, 2, 24, 1)), 5, 257)
    assert np.array_equal(got.numpy(), want)
