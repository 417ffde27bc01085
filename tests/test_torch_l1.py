"""The port's device L1 (wfmash_tpu_torch/map/l1_device.py, a torch
program on CPU tensors here) against the JAX package's (XLA on the CPU)
and against the host stage (map/l1l2.py).

The fixture is tests/test_l1_device.py's (seed 17, four target sequences
in PanSN-style groups, 24 mutated fragments), made with numpy; the same
padded arrays go through both `_l1_kernel`s, then `DeviceL1.candidates`
of both packages and the host answer are compared. Results are integers:
the tolerance is none, every comparison is equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wfmash_tpu.index.build import build_index as ref_build_index
from wfmash_tpu.map import l1_device as ref_l1
from wfmash_tpu.map.stats import compute_sketch_cutoffs
from wfmash_tpu.params import MapParams as RefParams
from wfmash_tpu.sketch.minhash import sketch_fragment
from wfmash_tpu_torch.index.build import build_index
from wfmash_tpu_torch.map import l1_device as port_l1
from wfmash_tpu_torch.map import l1l2
from wfmash_tpu_torch.params import MapParams
from wfmash_tpu_torch.utils import perf

from util import random_dna

GROUPS = np.array([0, 1, 1, 2], np.int32)   # PanSN-style groups
MIN_HITS = 2


def _params(cls, **over):
    mp = cls(percentage_identity=0.85, auto_pct_identity=False,
             window_length=500, kmer_size=15)
    mp.ref_sequences = mp.query_sequences = ["x"]
    mp = mp.finalize()
    for k, v in over.items():
        setattr(mp, k, v)
    return mp


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(17)
    base = random_dna(rng, 30_000)
    seqs = [(0, base), (1, base[5_000:25_000]), (2, base[2_000:17_000]),
            (3, random_dna(rng, 12_000))]
    mp = _params(MapParams)
    index = build_index(mp, seqs, log=lambda m: None)
    ref_index = ref_build_index(_params(RefParams), seqs, log=lambda m: None)
    assert np.array_equal(index.unique_hashes, ref_index.unique_hashes)
    assert index.endpoints.tobytes() == ref_index.endpoints.tobytes()
    cutoffs = compute_sketch_cutoffs(mp.sketch_size, mp.kmer_size, 0.0,
                                     0.999)
    sketches = []
    for trial in range(24):
        start = int(rng.integers(0, 29_000))
        fa = np.frombuffer(base[start:start + 500], np.uint8).copy()
        mut = rng.random(len(fa)) < (0.02 + 0.02 * (trial % 5))
        fa[mut] = rng.integers(65, 69, int(mut.sum()))
        sk = sketch_fragment(fa.tobytes(), mp.kmer_size, mp.sketch_size)
        if sk.sketch_size:
            sketches.append(sk)
    # a fragment of the target that shares nothing with `base`, and one
    # that is in no target: every slot of its row is the invalid one
    sketches.append(sketch_fragment(seqs[3][1][3_000:3_500], mp.kmer_size,
                                    mp.sketch_size))
    sketches.append(sketch_fragment(random_dna(rng, 500), mp.kmer_size,
                                    mp.sketch_size))
    return index, ref_index, cutoffs, sketches


def _frags(sketches, q_seqid, q_group):
    return [dict(hashes=sk.hashes, n=sk.sketch_size, q_len=500,
                 q_seqid=q_seqid, q_group=q_group, min_hits=MIN_HITS)
            for sk in sketches]


def host_candidates(sk, q_len, index, q_seqid, q_group, mp, cutoffs):
    """tests/test_l1_device.py's host answer, on the port's l1l2."""
    group_of = lambda ids: GROUPS[np.asarray(ids, np.int64)]  # noqa: E731
    pts = l1l2.get_seed_interval_points(sk, index, q_seqid, q_group,
                                        group_of, mp)
    out = []
    groups = group_of(pts["seq_id"]) if len(pts) else []
    i, n = 0, len(pts)
    while i < n:
        j = i + 1
        if mp.skip_prefix:
            while j < n and groups[j] == groups[i]:
                j += 1
        else:
            j = n
        l1l2.compute_l1_candidate_regions(
            sk.sketch_size, q_len, pts[i:j], MIN_HITS, mp, cutoffs, out)
        i = j
    return [(c.seq_id, c.range_start, c.range_end, c.intersection_size)
            for c in out]


# name -> (parameter overrides, DeviceL1 keywords, q_seqid, q_group)
CASES = {
    "default": ({}, {}, 99, 99),
    "self-group-skip": ({}, {}, 1, 1),
    "stage1-off": (dict(stage1_topANI_filter=False), {}, 99, 99),
    "lower-triangular": (dict(lower_triangular=True), {}, 2, 99),
    "cap-overflow": ({}, dict(cap=96), 99, 99),
    "more-than-maxc-runs": ({}, dict(maxc=2), 99, 99),
}


def _both_kernels(index, cutoffs, frags, mp, cap, maxc):
    """The same padded arrays through the JAX `_l1_kernel` and the
    port's; returns two (cand, ncand, overflow) numpy triples."""
    import jax.numpy as jnp

    B = len(frags)
    S = -(-max(len(f["hashes"]) for f in frags) // 64) * 64
    qh = np.full((B, S), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    q_nh = np.zeros(B, np.int32)
    meta = np.zeros((B, 4), np.int32)
    for i, f in enumerate(frags):
        qh[i, :len(f["hashes"])] = f["hashes"]
        q_nh[i] = len(f["hashes"])
        meta[i] = (f["q_group"], f["q_seqid"], f["min_hits"], f["n"])
    ep = index.endpoints
    arrays = dict(
        offs=index.endpoint_offsets.astype(np.int32),
        ep_pos=ep["pos"].astype(np.int32),
        ep_seq=ep["seq_id"].astype(np.int32),
        ep_side=ep["side"].astype(np.int8), seq_group=GROUPS,
        q_group=meta[:, 0], q_seqid=meta[:, 1],
        skip_grp=np.full(B, bool(mp.skip_self or mp.skip_prefix)),
        lower_tri=np.full(B, bool(mp.lower_triangular)),
        min_hits=meta[:, 2], sketch_size=meta[:, 3],
        cutoffs=np.asarray(cutoffs, np.int32))
    cut_div = np.float32(max(1.0, mp.sketch_size / 1000.0))
    kw = dict(cap=cap, maxc=maxc, stage1=bool(mp.stage1_topANI_filter))
    uh = index.unique_hashes.astype(np.uint64)

    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    qh_hi, qh_lo = ref_l1._split_u64(qh)
    uh_hi, uh_lo = ref_l1._split_u64(uh)
    want = ref_l1._l1_kernel(
        jnp.asarray(qh_hi), jnp.asarray(qh_lo), jnp.asarray(q_nh),
        jnp.asarray(uh_hi), jnp.asarray(uh_lo), j["offs"], j["ep_pos"],
        j["ep_seq"], j["ep_side"], j["seq_group"], j["q_group"],
        j["q_seqid"], j["skip_grp"], j["lower_tri"], j["min_hits"],
        j["sketch_size"], j["cutoffs"], cut_div,
        np.int32(mp.window_length), full_scan=True, **kw)

    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in arrays.items()}
    got = port_l1._l1_kernel(
        torch.from_numpy(port_l1._order_key(qh)), torch.from_numpy(q_nh),
        torch.from_numpy(port_l1._order_key(uh)), t["offs"], t["ep_pos"],
        t["ep_seq"], t["ep_side"], t["seq_group"], t["q_group"],
        t["q_seqid"], t["skip_grp"], t["lower_tri"], t["min_hits"],
        t["sketch_size"], t["cutoffs"], torch.tensor([cut_div]),
        int(mp.window_length), **kw)
    return ([np.asarray(a) for a in want], [a.numpy() for a in got])


def test_order_key_keeps_the_order_of_uint64():
    rng = np.random.default_rng(1)
    h = rng.integers(0, 1 << 64, 4000, dtype=np.uint64)
    h[:4] = (0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1)
    k = port_l1._order_key(h)
    assert k.dtype == np.int64
    assert np.array_equal(np.argsort(k, kind="stable"),
                          np.argsort(h, kind="stable"))
    assert k.max() == np.iinfo(np.int64).max      # the pad hash sorts last


@pytest.mark.parametrize("case", sorted(CASES))
def test_l1_kernel_equals_the_jax_program(setup, case):
    index, _, cutoffs, sketches = setup
    over, kw, q_seqid, q_group = CASES[case]
    mp = _params(MapParams, **over)
    want, got = _both_kernels(
        index, cutoffs, _frags(sketches, q_seqid, q_group), mp,
        kw.get("cap", 4096), kw.get("maxc", 64))
    # every row and every slot, the padding beyond ncand included
    for name, w, g in zip(("cand", "ncand", "overflow"), want, got):
        assert w.shape == g.shape, name
        assert np.array_equal(w, g), name
    assert got[0].dtype == np.int32
    assert int(got[1].max()) > 0
    if kw:
        assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_l1_equals_the_reference_and_the_host_stage(setup, case):
    index, ref_index, cutoffs, sketches = setup
    over, kw, q_seqid, q_group = CASES[case]
    mp = _params(MapParams, **over)
    frags = _frags(sketches, q_seqid, q_group)
    perf.reset()
    got = port_l1.DeviceL1(index, GROUPS, mp, cutoffs, device="cpu",
                           **kw).candidates(frags)
    assert perf.get("map.device_calls") == 1
    assert perf.get("map.l1_rows") == len(frags)
    assert perf.get("map.l1_host_rows") == sum(g is None for g in got)
    want = ref_l1.DeviceL1(ref_index, GROUPS, _params(RefParams, **over),
                           cutoffs, **kw).candidates(frags)
    assert got == want
    n_device = 0
    for sk, g in zip(sketches, got):
        if g is None:
            continue
        n_device += 1
        assert g == host_candidates(sk, 500, index, q_seqid, q_group, mp,
                                    cutoffs)
        assert all(type(x) is int for row in g for x in row)
    if kw:       # a small cap or maxc sends some rows to the host stage
        assert 0 < n_device < len(frags)
    else:
        assert n_device == len(frags)
    assert any(got), "no candidates at all"
    # the two fragments that are not of `base` find nothing there
    assert all(c[0] == 3 for c in got[-2] or ())
    assert not got[-1]
    if case == "self-group-skip":
        assert all(c[0] not in (1, 2) for g in got for c in g)
    if case == "lower-triangular":
        assert all(c[0] < q_seqid for g in got for c in g)


def test_device_l1_routes_tails_and_other_modes_to_the_host(setup):
    index, _, cutoffs, sketches = setup
    frags = _frags(sketches[:6], 99, 99)
    frags[2]["q_len"] = 700           # a query's tail fragment
    got = port_l1.DeviceL1(index, GROUPS, _params(MapParams), cutoffs,
                           device="cpu").candidates(frags)
    assert got[2] is None and all(g is not None for g in got[:2] + got[3:])
    scan_off = _params(MapParams, stage2_full_scan=False)
    got = port_l1.DeviceL1(index, GROUPS, scan_off, cutoffs,
                           device="cpu").candidates(frags)
    assert got == [None] * 6


def test_device_l1_chunks_and_empty_index(setup):
    """More fragments than one chunk holds give the rows of one chunk
    each; an index without postings answers every row with no candidate."""
    index, _, cutoffs, sketches = setup
    mp = _params(MapParams)
    frags = _frags(sketches, 99, 99)
    dev = port_l1.DeviceL1(index, GROUPS, mp, cutoffs, device="cpu")
    whole = dev.candidates(frags)
    dev.BATCH = 7
    perf.reset()
    assert dev.candidates(frags) == whole
    assert perf.get("map.device_calls") == -(-len(frags) // 7)

    empty = dataclasses.replace(
        index, unique_hashes=index.unique_hashes[:0],
        endpoint_offsets=index.endpoint_offsets[:1],
        endpoints=index.endpoints[:0])
    got = port_l1.DeviceL1(empty, GROUPS, mp, cutoffs,
                           device="cpu").candidates(frags[:3])
    assert got == [[], [], []]
