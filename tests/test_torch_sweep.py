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
