"""The port's device L2 (wfmash_tpu_torch/map/l2_device.py, a torch
program on CPU tensors here) against the JAX package's (XLA on the CPU)
and against the host walk (map/l1l2.py::compute_l2_mapped_regions).

The fixture is tests/test_l2_device.py's (seed 23), made with numpy; the
same event arrays go through both `_l2_walk_kernel`s, then
`DeviceL2.walk` of both packages and the host answer are compared.
Results are integers: the tolerance is none, every comparison is equality.
"""

import numpy as np
import pytest
import torch

from wfmash_tpu.index.build import build_index as ref_build_index
from wfmash_tpu.map import l1l2 as ref_l1l2
from wfmash_tpu.map import l2_device as ref_l2
from wfmash_tpu.map.stats import compute_sketch_cutoffs
from wfmash_tpu.params import MapParams as RefParams
from wfmash_tpu.sketch.minhash import sketch_fragment
from wfmash_tpu_torch.index.build import build_index
from wfmash_tpu_torch.map import l1l2
from wfmash_tpu_torch.map import l2_device as port_l2
from wfmash_tpu_torch.params import MapParams
from wfmash_tpu_torch.utils import perf

from util import mutate, random_dna


def _params(cls):
    mp = cls(percentage_identity=0.85, auto_pct_identity=False,
             window_length=500, kmer_size=15)
    mp.ref_sequences = mp.query_sequences = ["x"]
    return mp.finalize()


def _key(m):
    return (m.seq_id, m.mean_optimal_pos, m.optimal_start, m.optimal_end,
            m.shared_sketch_size, m.strand)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(23)
    mp = _params(MapParams)
    base = random_dna(rng, 40_000)
    seqs = [(0, base), (1, mutate(rng, base[5_000:30_000], 0.08)),
            (2, base[10_000:20_000][::-1]), (3, random_dna(rng, 15_000))]
    index = build_index(mp, seqs, log=lambda m: None)
    ref_index = ref_build_index(_params(RefParams), seqs, log=lambda m: None)
    assert index.minmer_index.tobytes() == ref_index.minmer_index.tobytes()
    group_arr = np.array([0, 1, 2, 3], np.int64)
    cutoffs = compute_sketch_cutoffs(mp.sketch_size, mp.kmer_size, 0.0,
                                     0.999)
    rows, ref_rows = [], []
    for fi in range(40):
        off = int(rng.integers(0, 39_000))
        frag = bytes(base[off:off + mp.window_length])
        if fi % 3 == 1:
            frag = mutate(rng, frag, 0.10)
        sk = sketch_fragment(frag, mp.kmer_size, mp.sketch_size)
        if sk.sketch_size == 0:
            continue
        pts = l1l2.get_seed_interval_points(
            sk, index, 99, 99, lambda ids: group_arr[np.asarray(ids)], mp)
        if len(pts) == 0:
            continue
        l1 = []
        l1l2.compute_l1_candidate_regions(
            sk.sketch_size, len(frag), pts, 2, mp, cutoffs, l1)
        for cand in l1[:4]:
            rows.append((sk, len(frag), cand))
            ref_rows.append((sk, len(frag), ref_l1l2.L1Candidate(
                cand.seq_id, cand.range_start, cand.range_end,
                cand.intersection_size)))
    assert len(rows) > 20, "fixture produced too few candidates"
    expected = [[_key(m) for m in l1l2.compute_l2_mapped_regions(
        sk, ql, cand, index, mp)] for sk, ql, cand in rows]
    return mp, index, ref_index, rows, ref_rows, expected


def _both_kernels(arrays, S):
    """(shared, votes) of the JAX `_l2_walk_kernel` and of the port's on
    the same numpy event arrays."""
    import jax.numpy as jnp

    want = ref_l2._l2_walk_kernel(*(jnp.asarray(a) for a in arrays), S=S)
    got = port_l2._l2_walk_kernel(*(torch.from_numpy(a) for a in arrays),
                                  S=S)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _kernel_arrays(dev, rows):
    """One chunk of all `rows`: the port's packed host arrays, and the
    (wpos, wend, slot, svote, valid, s_row) arrays of `_l2_walk_kernel`
    with the slot codes looked up by the port's `_slot_codes`."""
    prep = dev._prepare(rows)
    assert prep["rows"].tolist() == list(range(len(rows)))
    packed = dev._pack(rows, prep, 0, len(rows))
    wpos, wend, ev_key, ev_strand, valid, is_main, sk_key, sk_strand, \
        s_row = packed
    slot, svote = port_l2._slot_codes(
        *(torch.from_numpy(a) for a in (sk_key, sk_strand, s_row, ev_key,
                                        ev_strand)), S=dev.S_CAP)
    return packed, (wpos, wend, slot.numpy(), svote.numpy(), valid, s_row)


def test_events_and_slot_codes_equal_the_reference(setup):
    """The vectorised windows and the device's slot lookup give, row by
    row, the events that the reference's DeviceL2._events builds."""
    mp, index, ref_index, rows, ref_rows, _ = setup
    dev = port_l2.DeviceL2(index, mp, device="cpu")
    ref = ref_l2.DeviceL2(ref_index, _params(RefParams))
    packed, arrays = _kernel_arrays(dev, rows)
    is_main = packed[5]
    wpos, wend, slot, svote, valid, s_row = arrays
    n_lead = 0
    for j, (sk, _, cand) in enumerate(ref_rows):
        want = ref._events(sk, cand)
        e = len(want[0])
        assert valid[j].sum() == e and valid[j, :e].all()
        for w, g in zip(want, (wpos, wend, slot, svote, is_main)):
            assert np.array_equal(w, g[j, :e])
        assert s_row[j] == sk.sketch_size
        n_lead += int((~want[4]).sum())
    assert n_lead > 0 and (slot > dev.S_CAP).any() and (svote != 0).any()


def test_l2_walk_kernel_equals_the_jax_program(setup):
    mp, index, _, rows, _, _ = setup
    dev = port_l2.DeviceL2(index, mp, device="cpu")
    _, arrays = _kernel_arrays(dev, rows)
    valid = arrays[4]
    assert valid.any(axis=1).all() and not valid.all()
    want, got = _both_kernels(arrays, dev.S_CAP)
    for name, w, g in zip(("shared", "votes"), want, got):
        assert g.dtype == np.int32 and g.shape == valid.shape
        assert np.array_equal(w[valid], g[valid]), name
    assert int(got[0].max()) > 10 and (got[1] != 0).any()


@pytest.mark.parametrize("batch", [256, 5], ids=["one-chunk", "chunks-of-5"])
def test_device_l2_equals_the_reference_and_the_host_walk(setup, batch):
    mp, index, ref_index, rows, ref_rows, expected = setup
    dev = port_l2.DeviceL2(index, mp, device="cpu")
    dev.BATCH = batch
    perf.reset()
    got = dev.walk(rows)
    assert perf.get("map.l2_device_calls") == -(-len(rows) // batch)
    assert perf.get("map.l2_rows") == len(rows)
    assert perf.get("map.l2_host_rows") == 0
    want = ref_l2.DeviceL2(ref_index, _params(RefParams)).walk(ref_rows)
    assert all(g is not None for g in got)
    assert [[_key(m) for m in g] for g in got] == \
        [[_key(m) for m in w] for w in want] == expected
    assert any(expected)


def test_rows_over_the_caps_go_to_the_host_walk(setup):
    mp, index, _, rows, _, expected = setup
    dev = port_l2.DeviceL2(index, mp, device="cpu")
    n_events = np.diff(dev._prepare(rows)["offs"]).tolist()
    assert len(n_events) == len(rows)
    dev.E_CAP = sorted(n_events)[len(n_events) // 2]    # the median row
    perf.reset()
    got = dev.walk(rows)
    n_host = sum(g is None for g in got)
    assert 0 < n_host < len(rows)
    assert perf.get("map.l2_host_rows") == n_host
    for g, e, n in zip(got, expected, n_events):
        assert (g is None) == (n > dev.E_CAP)
        if g is not None:
            assert [_key(m) for m in g] == e
    # a tail fragment, and a sketch larger than S_CAP
    sk, q_len, cand = rows[0]
    dev = port_l2.DeviceL2(index, mp, device="cpu")
    assert dev.walk([(sk, q_len + 100, cand)]) == [None]
    dev.S_CAP = sk.sketch_size - 1
    assert dev.walk([(sk, q_len, cand)]) == [None]


def test_emit_equals_the_reference_row_by_row(setup):
    """Random chunks with several best runs a row, gaps on both sides of
    one window, lead-ins, rows without main events and rows of zeros,
    against the reference's per-row emission."""
    mp, index, ref_index, _, _, _ = setup
    dev = port_l2.DeviceL2(index, mp, device="cpu")
    ref = ref_l2.DeviceL2(ref_index, _params(RefParams))
    rng = np.random.default_rng(5)
    B, E = 40, 30
    n_joined = n_multi = 0
    for _ in range(5):
        wpos = np.cumsum(rng.choice([1, 40, 400, 1500], (B, E)), axis=1) \
            .astype(np.int32)
        n_lead = rng.integers(0, 6, B)
        n_ev = rng.integers(0, E + 1, B)
        lane = np.arange(E)[None, :]
        is_main = (lane >= n_lead[:, None]) & (lane < n_ev[:, None])
        shared = rng.integers(0, 4, (B, E)).astype(np.int32)
        shared[::7] = 0
        votes = rng.integers(-3, 4, (B, E)).astype(np.int32)
        got: dict = {}
        for j, m in dev._emit(wpos, is_main, shared, votes,
                              list(range(100, 100 + B))):
            got.setdefault(j, []).append(_key(m))
        for j in range(B):
            cand = ref_l1l2.L1Candidate(100 + j, 0, 0, 0)
            e = int(max(n_ev[j], n_lead[j]))
            ev = (wpos[j, :e], None, None, None, is_main[j, :e])
            want = [_key(m) for m in ref._emit(cand, ev, shared[j, :e],
                                               votes[j, :e])]
            assert got.get(j, []) == want
            n_multi += len(want) > 1
            at = is_main[j] & (shared[j] == max(shared[j][is_main[j]].max(),
                                                1)) if is_main[j].any() \
                else np.zeros(E, bool)
            n_runs = int((at & ~np.r_[False, at[:-1]]).sum())
            n_joined += n_runs > len(want)
    assert n_multi > 10 and n_joined > 10


def _walk_by_hand(wpos, wend, slot, svote, valid, s, S):
    """shared and votes of one row, event by event."""
    E = len(wpos)
    shared = np.zeros(E, np.int64)
    votes = np.zeros(E, np.int64)
    for i in range(E):
        cnt = np.zeros(S, np.int64)
        nb = np.zeros(S, np.int64)
        vt = np.zeros(S, np.int64)
        for j in range(i + 1):
            if not valid[j] or wend[j] <= wpos[i]:
                continue
            if slot[j] <= S:
                if slot[j] < S:
                    cnt[slot[j]] += 1
                    vt[slot[j]] += svote[j]
            elif slot[j] - (S + 1) < S:
                nb[slot[j] - (S + 1)] += 1
        in_b = np.arange(1, S + 1) + np.cumsum(nb) <= s
        shared[i] = cnt[in_b].sum()
        votes[i] = vt[in_b].sum()
    return shared, votes


def test_counts_past_256_in_one_slot_stay_exact():
    """301 live records in one slot: a bfloat16 result would round the
    count to 300 or 302. Row 0 holds them as matching records of slot 2
    (the count is in `shared` itself), row 1 as non-matching records of
    slot 3 with matching ones on both sides of it."""
    S, E, n = 256, 320, 301
    wpos = np.tile(np.arange(E, dtype=np.int32), (2, 1))
    wend = np.full((2, E), 10_000, np.int32)       # nothing is evicted
    wend[1, 5] = 200                               # but one, in row 1
    slot = np.zeros((2, E), np.int32)
    svote = np.zeros((2, E), np.int32)
    valid = np.ones((2, E), bool)
    valid[:, -3:] = False
    s_row = np.array([200, 256], np.int32)
    slot[0, :n] = 2
    svote[0, :n] = np.where(np.arange(n) % 3 == 0, -1, 1)
    slot[0, n:] = np.arange(E - n) + 4
    svote[0, n:] = 1
    slot[1, :n] = 3 + (S + 1)
    slot[1, n:] = np.arange(E - n) % 8            # slots on both sides of 3
    svote[1, n:] = -1
    arrays = (wpos, wend, slot, svote, valid, s_row)
    want, got = _both_kernels(arrays, S)
    for b in range(2):
        hand = _walk_by_hand(wpos[b], wend[b], slot[b], svote[b], valid[b],
                             int(s_row[b]), S)
        for w, g, h in zip(want, got, hand):
            assert np.array_equal(g[b][valid[b]], h[valid[b]])
            assert np.array_equal(w[b][valid[b]], h[valid[b]])
    assert got[0][0, n - 1] == n                  # 301 live in slot 2
    assert got[0][0].max() == E - 3
    assert 0 < got[0][1].max() < 10 and got[1][1].min() < 0
