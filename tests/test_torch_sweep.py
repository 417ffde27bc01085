"""The port's exact sweep (wfmash_tpu_torch.align.wfa_sweep: the plain
PyTorch version of the CUDA kernel csrc/sweep_wfa.cu, through the
wrapper's CPU path and the ExactSweeps front end) against the JAX package:
PallasSweeps in interpret mode and wfa_jax._sweep, on the same numpy
inputs.

Tolerance: exact, integers. f_score, f_pv, f_ph and finished must be
equal; clipped under the stated one-way rule (port-clipped implies
reference-clipped: the TPU kernel kept raising the flag of a finished
problem while its group peers ran).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wfmash_tpu.align import wfa_jax as WJ
from wfmash_tpu.align import wfa_pallas as WP
from wfmash_tpu.align.wfa_np import Penalties
from wfmash_tpu_torch.align import wfa_sweep

from test_wfa import make_pair

torch.set_num_threads(1)

PATCH = Penalties(5, 8, 2, 24, 1)
WFLIGN = Penalties(2, 3, 1, 3, 1)
CPU = torch.device("cpu")


def _batch(rng, B, L, K, axis=None, perfect=()):
    """The inputs of tests/test_wfa_pallas.py::_sweep_both as a dict of
    numpy arrays. axis: None (split the longer side), "query" or "target"
    (forced for every problem). perfect: indices whose query is made
    equal to the target (done0 set)."""
    ms, ns, qs, ts = [], [], [], []
    for i in range(B):
        n = int(rng.integers(L // 2, L))
        q, t = make_pair(rng, n, sub=0.05, indel=0.01, max_indel=6)
        if i in perfect:
            q = t
        qs.append(np.frombuffer(q, np.uint8))
        ts.append(np.frombuffer(t, np.uint8))
        ms.append(len(q))
        ns.append(len(t))
    query = np.full((B, 1024), 0x01, np.uint8)
    target = np.full((B, 1024), 0x02, np.uint8)
    for i in range(B):
        query[i, :ms[i]] = qs[i]
        target[i, :ns[i]] = ts[i]
    qlen = np.array(ms, np.int32)
    tlen = np.array(ns, np.int32)
    axis_q = {None: qlen > tlen, "query": np.ones(B, bool),
              "target": np.zeros(B, bool)}[axis]
    mid = np.where(axis_q, qlen // 2, tlen // 2).astype(np.int32)
    lcp = np.array([WJ._lcp_np(q, t) for q, t in zip(qs, ts)], np.int32)
    done0 = (lcp >= qlen) & (lcp >= tlen)
    seed_off = np.full((B, K), WJ.NEG_I, np.int32)
    seed_anc = np.full((B, K), WP.UNSET32, np.uint32)
    seed_off[:, K // 2] = lcp
    cr = ~done0 & (lcp > mid)
    seed_anc[cr, K // 2] = (mid[cr].astype(np.uint32) << 16) \
        | mid[cr].astype(np.uint32)
    return dict(query=query, target=target, qlen=qlen, tlen=tlen,
                axis_q=axis_q, mid=mid, lcp=lcp, done0=done0,
                seed_off=seed_off, seed_anc=seed_anc)


def _xla(d, p, K, max_s):
    """wfa_jax._sweep on the batch (span K + 1, as the reference test)."""
    B = len(d["qlen"])
    Kx, R = K + 1, WJ.ring_size(p)
    off = np.full((B, R, 5, Kx), WJ.NEG_I, np.int32)
    anc_v = np.full((B, R, 5, Kx), -1, np.int32)
    anc_h = np.full((B, R, 5, Kx), -1, np.int32)
    open_a = np.full((B, R, 4, Kx), -1, np.int32)
    off[:, 0, WJ.M_, Kx // 2] = d["lcp"]
    cr = ~d["done0"] & (d["lcp"] > d["mid"])
    anc_v[cr, 0, WJ.M_, Kx // 2] = d["mid"][cr]
    anc_h[cr, 0, WJ.M_, Kx // 2] = d["mid"][cr]
    got = WJ._sweep(
        jnp.asarray(off), jnp.asarray(anc_v), jnp.asarray(anc_h),
        jnp.asarray(open_a), jnp.asarray(WJ._pack_words(d["query"])),
        jnp.asarray(WJ._pack_words(d["target"])), jnp.asarray(d["qlen"]),
        jnp.asarray(d["tlen"]), jnp.asarray(d["axis_q"]),
        jnp.asarray(d["mid"]), jnp.asarray(d["done0"]), jnp.int32(max_s),
        K=Kx, R=R, penalties=p)
    return tuple(np.asarray(a) for a in got)


def _args(d, max_s, K):
    return (d["query"], d["target"], d["qlen"], d["tlen"], d["axis_q"],
            d["mid"], d["seed_off"], d["seed_anc"], d["done0"], max_s, K)


CASES = {
    "patch-b3": dict(seed=11, B=3, L=260, p=PATCH),
    "wflign-b3": dict(seed=11, B=3, L=260, p=WFLIGN),
    "patch-b12": dict(seed=13, B=12, L=220, p=PATCH),
    "done0": dict(seed=17, B=5, L=200, p=PATCH, perfect=(1, 3)),
    "axis-query": dict(seed=19, B=4, L=200, p=PATCH, axis="query"),
    "axis-target": dict(seed=19, B=4, L=200, p=PATCH, axis="target"),
    "wflign-b12": dict(seed=13, B=12, L=220, p=WFLIGN),
    "wflign-done0": dict(seed=17, B=5, L=200, p=WFLIGN, perfect=(1, 3)),
    "wflign-axis-query": dict(seed=19, B=4, L=200, p=WFLIGN, axis="query"),
    "wflign-axis-target": dict(seed=19, B=4, L=200, p=WFLIGN,
                               axis="target"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_matches_pallas_and_xla(case):
    c = CASES[case]
    p, K = c["p"], 256
    d = _batch(np.random.default_rng(c["seed"]), c["B"], c["L"], K,
               axis=c.get("axis"), perfect=c.get("perfect", ()))
    assert d["done0"].sum() == len(c.get("perfect", ()))
    max_s = int(p.mismatch * 2 * c["L"] + 64)
    port = wfa_sweep.ExactSweeps.from_reference(
        WP.PallasSweeps(p, interpret=True, chunk_steps=32), CPU)
    fs, pv, ph, fin, clip = port.sweep(*_args(d, max_s, K))
    ref = WP.PallasSweeps(p, interpret=True, chunk_steps=32)
    fs_r, pv_r, ph_r, fin_r, clip_r = ref.sweep(*_args(d, max_s, K))
    assert fin.all() and fin_r.all()
    np.testing.assert_array_equal(fs, fs_r)
    np.testing.assert_array_equal(pv, pv_r)
    np.testing.assert_array_equal(ph, ph_r)
    np.testing.assert_array_equal(fin, fin_r)
    assert not (clip & ~clip_r).any()         # one-way rule
    fs_x, pv_x, ph_x, fin_x = _xla(d, p, K, max_s)
    keep = ~d["done0"]
    assert fin_x.all() and keep.any()
    np.testing.assert_array_equal(fs[keep], fs_x[keep])
    np.testing.assert_array_equal(pv[keep], pv_x[keep])
    np.testing.assert_array_equal(ph[keep], ph_x[keep])
    assert (pv[keep] >= 0).all() and (ph[keep] >= 0).all()
    # one seeded lane: level s computes the lanes K/2 - s .. K/2 + s of
    # the band
    assert port.levels == int(fs[keep].sum())
    assert port.lanes == sum(
        min(K - 1, K // 2 + s) - max(0, K // 2 - s) + 1
        for f in fs[keep] for s in range(1, int(f) + 1))


def test_sweep_max_s_and_band_edge():
    """A problem still open at max_s returns finished = False (the rule
    of wfa_jax._sweep), and a 300 bp out-and-back excursion at K = 512
    raises clipped on both sides."""
    from util import random_dna

    rng = np.random.default_rng(21)
    s = random_dna(rng, 700)
    q = np.frombuffer(s[:200] + random_dna(rng, 300) + s[200:], np.uint8)
    t = np.frombuffer(s[:500] + random_dna(rng, 300) + s[500:], np.uint8)
    K = 512
    d = dict(query=np.full((1, 1024), 0x01, np.uint8),
             target=np.full((1, 1024), 0x02, np.uint8),
             qlen=np.array([len(q)], np.int32),
             tlen=np.array([len(t)], np.int32),
             axis_q=np.zeros(1, bool), done0=np.zeros(1, bool))
    d["query"][0, :len(q)] = q
    d["target"][0, :len(t)] = t
    d["mid"] = d["tlen"] // 2
    d["seed_off"] = np.full((1, K), WJ.NEG_I, np.int32)
    d["seed_anc"] = np.full((1, K), WP.UNSET32, np.uint32)
    d["seed_off"][0, K // 2] = WJ._lcp_np(q, t)
    port = wfa_sweep.ExactSweeps(PATCH, CPU)
    fs, pv, ph, fin, clip = port.sweep(*_args(d, 5000, K))
    ref = WP.PallasSweeps(PATCH, interpret=True, chunk_steps=64)
    fs_r, pv_r, ph_r, fin_r, clip_r = ref.sweep(*_args(d, 5000, K))
    assert fin.all() and clip.all() and clip_r.all()
    assert (fs, pv, ph) == (fs_r, pv_r, ph_r)
    short = int(fs[0]) - 1
    fs2, pv2, ph2, fin2, _ = port.sweep(*_args(d, short, K))
    assert not fin2.any() and fs2[0] == 0 and pv2[0] == -1 and ph2[0] == -1
    fs_x, _, _, fin_x = _xla(d | dict(lcp=d["seed_off"][:, K // 2]), PATCH,
                             K, short)
    assert not fin_x.any()


def test_run_sweep_rejects_bad_inputs():
    z = torch.zeros((2, 64), dtype=torch.uint8)
    par = torch.zeros((2, wfa_sweep.NPAR), dtype=torch.int32)
    seed = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        wfa_sweep.run_sweep(z, z, par, seed, seed.to(torch.int64),
                            penalties=PATCH, K=16, max_s=4)
    with pytest.raises(ValueError):
        wfa_sweep.run_sweep(z[:, :62], z[:, :62], par, seed, seed,
                            penalties=PATCH, K=16, max_s=4)
    with pytest.raises(ValueError):
        wfa_sweep.run_sweep(z, z, par, seed[:, :15], seed[:, :15],
                            penalties=PATCH, K=15, max_s=4)
    assert wfa_sweep.LAUNCHES == 0
    assert wfa_sweep.ring_sizes(PATCH) == WP.ring_sizes(PATCH) == (26, 3)
    assert wfa_sweep.scratch_words(PATCH, 256) == (52 + 36) * 256


def _longest_pair(rng):
    """A query of 65534 bases, the longest the sweep takes, and a target
    that differs by three substitutions, a 10-base deletion in the middle
    and 6 extra bases at its end. The path runs on diagonal 10 to the
    query's end and then takes 6 deletion steps, so for 20 levels an M
    cell sits at offset 65534 beside the end diagonal: the insertion cells
    opened from it hold offsets of 65535 and more, past what a 16-bit ring
    word can tell from "none"."""
    n = 65534
    q = rng.integers(0, 4, n).astype(np.uint8)
    t = q.copy()
    for pos in (1000, 30000, 60000):
        t[pos] = (t[pos] + 1 + rng.integers(0, 3)) % 4
    t = np.concatenate([t[:32000], t[32010:],
                        rng.integers(0, 4, 6).astype(np.uint8)])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return acgt[q], acgt[t]


@pytest.mark.parametrize("axis", ["query", "target"])
@pytest.mark.parametrize("pen", [PATCH, WFLIGN], ids=["patch", "wflign"])
def test_sweep_at_the_16_bit_edge(pen, axis):
    """Lengths at the limit: the narrow ring words of the plain version
    (uint16 offsets with 0xFFFF for none, insertion offsets saturated)
    give the five outputs of wfa_jax._sweep and of PallasSweeps, which
    keep 32-bit words."""
    K = 256
    q, t = _longest_pair(np.random.default_rng(29))
    L = 65544
    d = dict(query=np.full((1, L), 0x01, np.uint8),
             target=np.full((1, L), 0x02, np.uint8),
             qlen=np.array([len(q)], np.int32),
             tlen=np.array([len(t)], np.int32),
             axis_q=np.array([axis == "query"]), done0=np.zeros(1, bool))
    assert d["qlen"][0] == 65534 and d["tlen"][0] == 65530
    d["query"][0, :len(q)] = q
    d["target"][0, :len(t)] = t
    d["mid"] = np.where(d["axis_q"], d["qlen"] // 2, d["tlen"] // 2) \
        .astype(np.int32)
    d["lcp"] = np.array([WJ._lcp_np(q, t)], np.int32)
    d["seed_off"] = np.full((1, K), WJ.NEG_I, np.int32)
    d["seed_anc"] = np.full((1, K), WP.UNSET32, np.uint32)
    d["seed_off"][0, K // 2] = d["lcp"][0]
    max_s = 400
    port = wfa_sweep.ExactSweeps(pen, CPU)
    fs, pv, ph, fin, clip = port.sweep(*_args(d, max_s, K))
    fs_x, pv_x, ph_x, fin_x = _xla(d, pen, K, max_s)
    assert fin.all() and fin_x.all() and not clip.any()
    assert (fs, pv, ph) == (fs_x, pv_x, ph_x)
    gap = min(pen.gap_opening1 + 10 * pen.gap_extension1,
              pen.gap_opening2 + 10 * pen.gap_extension2) \
        + min(pen.gap_opening1 + 6 * pen.gap_extension1,
              pen.gap_opening2 + 6 * pen.gap_extension2)
    assert fs[0] == 3 * pen.mismatch + gap
    ref = WP.PallasSweeps(pen, interpret=True, chunk_steps=32)
    fs_r, pv_r, ph_r, fin_r, clip_r = ref.sweep(*_args(d, max_s, K))
    assert (fs, pv, ph, fin) == (fs_r, pv_r, ph_r, fin_r)
    assert not clip_r.any()


def test_kernel_choice():
    """The kernel a shape takes follows from K and the penalties alone:
    shared-memory rings in one block up to K = 512, in a cluster of K / 512
    blocks above, and global rings where that layout does not fit."""
    assert wfa_sweep.ring_bytes_per_lane(PATCH) == 6 * 26 + 32 * 3 == 252
    assert [wfa_sweep.kernel_choice(PATCH, K)
            for K in (256, 512, 1024, 2048, 4096)] == [1, 1, 2, 4, 8]
    assert [wfa_sweep.kernel_choice(WFLIGN, K)
            for K in (64, 512, 4096)] == [1, 1, 8]
    # K the cluster layout does not take
    assert wfa_sweep.kernel_choice(PATCH, 768) == 0
    assert wfa_sweep.kernel_choice(PATCH, 8192) == 0
    # rings over 227 KB a 512-lane block: (6 * 66 + 32 * 3) * 512 = 246 KiB
    deep = Penalties(5, 8, 2, 64, 1)
    assert wfa_sweep.ring_bytes_per_lane(deep) * 512 > wfa_sweep.SMEM_LIMIT
    assert wfa_sweep.kernel_choice(deep, 512) == 0
    assert wfa_sweep.kernel_choice(deep, 1024) == 0
    assert wfa_sweep.kernel_choice(deep, 256) == 1    # 123 KiB: it fits
    assert wfa_sweep.kernel_name(0) == "global rings"
    assert wfa_sweep.kernel_name(4) == "shared rings, cluster of 4"


def test_ring_words_round_trip():
    """The narrow ring words hold every value the recurrence can store:
    offsets 0..65534 and "none" as they are, insertion offsets exactly up
    to 65535 and saturated above (all of those are past every query's
    end), gap-open coordinates with 0xFFFF for -1, anchors as 32 bits."""
    i32 = torch.int32
    off = torch.tensor([wfa_sweep.NEG_I, 0, 1, 65533, 65534], dtype=i32)
    w = wfa_sweep._narrow16(off, False)
    assert w.dtype == torch.uint16
    assert w.to(i32).tolist() == [0xFFFF, 0, 1, 65533, 65534]
    assert torch.equal(wfa_sweep._widen16(w, wfa_sweep.NEG_I, False), off)
    ins = torch.tensor([wfa_sweep.NEG_I, 1, 65534, 65535, 65536, 69000],
                       dtype=i32)
    w = wfa_sweep._narrow16(ins, True)
    assert w.to(i32).tolist() == [0xFFFF, 0, 65533, 65534, 65534, 65534]
    assert wfa_sweep._widen16(w, wfa_sweep.NEG_I, True).tolist() == \
        [wfa_sweep.NEG_I, 1, 65534, 65535, 65535, 65535]
    opens = torch.tensor([-1, 0, 65534], dtype=i32)
    assert torch.equal(wfa_sweep._widen16(
        wfa_sweep._narrow16(opens, False), -1, False), opens)
    anc = torch.tensor([0, 5 << 16 | 7, 0x80000001, wfa_sweep.UNSET32])
    w = wfa_sweep._narrow32(anc)
    assert w.dtype == i32 and torch.equal(wfa_sweep._widen32(w), anc)


@pytest.mark.parametrize("K", [1024, 2048, 4096])
def test_smoke_boundary_batches(K):
    """The card's check of the cluster kernel (chip_smoke.py) needs
    problems whose paths run beside the outermost block boundaries of a
    cluster, lanes 511/512 and K - 513/K - 512, where a block's halo has a
    neighbour on one side only: its generator must end problems on either
    side of both, within the 16 halo lanes' reach of small indels, and stay
    inside the lengths the sweep takes."""
    import chip_smoke

    pairs = chip_smoke._boundary_pairs(np.random.default_rng(K), 32, K)
    d_end = np.array([len(q) - len(t) + K // 2 for q, t in pairs])
    assert all(3000 <= len(q) < 5000 and len(t) < 65535 for q, t in pairs)
    low, high = d_end[d_end < K // 2], d_end[d_end >= K // 2]
    if K == 1024:               # the seed lane is the one boundary
        low = high = d_end
    for side, lane in ((low, 512), (high, K - 512)):
        assert len(side) >= 8
        assert (np.abs(side - lane) <= 40).all()
        assert (side < lane).any() and (side >= lane).any()
