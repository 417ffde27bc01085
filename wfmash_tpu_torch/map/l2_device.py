"""Device-side L2 mapping stage: the sliding-sketch walk as batched matrix
products (a torch program on tensors, no hand-written kernel).

The reference's L2 (reference: src/map/include/mappingCore.hpp:306-442
with SlideMapper, slidingMap.hpp:27-212) walks each L1 candidate's
minmer records through a min-heap window, maintaining the bottom-s union
sketch and tracking argmax runs of the shared-sketch count. Sequential
on a CPU; here the whole walk becomes one batched matrix product per
batch of candidates (production window_len == 0 path, i.e. w-length
fragments):

* events of a candidate = its minmer records in (seq, wpos) order
  (lead-ins whose interval covers range_start included). Record j is
  ACTIVE at event i iff j <= i (already inserted) and
  wpos_end[j] > wpos[i] (not yet evicted): the closed form of the
  heap eviction, exact because window_len == 0 evicts every expired
  record before each insertion;
* pair(i, j) = that predicate as a (E, E) 0/1 matrix; per-slot counts
  cnt/nb/votes at every event are pair @ onehot(slot) products. The
  operands are float32 and so is the result: products of 0 and +-1 are
  exact and the sums are exact below 2^24 (bfloat16 operands would be
  exact too, but a bfloat16 result holds integers only up to 256, and a
  slot's count can pass that);
* SlideMapper's pivot: rank(l) = (l+1) + cum(nb) is strictly
  increasing, so slot l is inside the bottom-s union sketch iff
  rank(l) <= s. shared(i) / votes(i) are masked row sums. Ref hashes
  above the largest query hash are dropped (slidingMap.hpp insert
  returns early) via a dead slot S.

Each event's slot in the query sketch is looked up on the device too
(`_slot_codes`: one batched `torch.searchsorted`), and the argmax-run
emission (best runs, prev-event strand votes, join within one window:
mappingCore.hpp:402-435) is replayed on host, a chunk at a time, from
the device-computed shared/votes arrays. Identical to
compute_l2_mapped_regions (tested against it and the C++ native walk).

Memory of one chunk of B rows padded to E events: the pair matrix
(B, E, E), the three one-hot operands side by side (B, E, 3 (S + 1)) and
their product of the same shape, all float32 and alive together:
4 B E (E + 6 (S + 1)) bytes, ~1.8 GB at B = 256, E = E_CAP = 768, S = 256.
A chunk is padded to its own longest row, not to E_CAP.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..params import STRAND_FWD, STRAND_REV
from .l1_device import _order_key
from .l1l2 import L2Mapping


def _l2_walk_kernel(wpos, wend, slot, svote, valid, s_row, *, S):
    """(B, E) event arrays -> (shared (B, E), votes (B, E)) int32.

    slot: searchsorted position into the row's query sketch, in [0, S]
    (S = ignored/above-max) for events whose hash is in the sketch (eq);
    the others carry slot + (S + 1). svote: q_strand*ref_strand for eq
    events, else 0 (0 also for ambiguous strands, hence the slot code)."""
    B, E = wpos.shape
    dev = wpos.device
    f32 = torch.float32
    eq = slot <= S
    lane = torch.arange(E, dtype=torch.int32, device=dev)
    tri = lane[None, :] <= lane[:, None]              # j <= i
    cover = wend[:, None, :] > wpos[:, :, None]       # wend_j > wpos_i
    pair = (cover & tri[None, :, :] & valid[:, None, :]).to(f32)
    del cover

    # one-hot operands for cnt, nb and votes, side by side: column
    # k (S + 1) + slot holds the event's weight
    slot_eq = torch.where(eq, slot, 0).to(torch.int64)
    slot_nb = torch.where(eq, 0, slot - (S + 1)).to(torch.int64)
    is_eq = (eq & valid).to(f32)
    is_nb = (~eq & valid).to(f32)
    oh = torch.zeros((B, E, 3 * (S + 1)), dtype=f32, device=dev)
    oh.scatter_(2, slot_eq[:, :, None], is_eq[:, :, None])
    oh.scatter_(2, (slot_nb + (S + 1))[:, :, None], is_nb[:, :, None])
    oh.scatter_(2, (slot_eq + 2 * (S + 1))[:, :, None],
                (is_eq * svote.to(f32))[:, :, None])
    prod = torch.bmm(pair, oh)
    del pair, oh
    cnt = prod[:, :, :S]
    nbx = prod[:, :, S + 1:2 * S + 1]
    votes = prod[:, :, 2 * S + 2:3 * S + 2]
    rank = torch.cumsum(nbx, dim=2, dtype=f32) + torch.arange(
        1, S + 1, dtype=f32, device=dev)
    in_b = rank <= s_row[:, None, None].to(f32)
    shared = torch.where(in_b, cnt, 0.0).sum(dim=2)
    votes_t = torch.where(in_b, votes, 0.0).sum(dim=2)
    return shared.to(torch.int32), votes_t.to(torch.int32)


def _slot_codes(sk_key, sk_strand, s_row, ev_key, ev_strand, *, S):
    """Each event's slot code and strand vote against its row's query
    sketch. sk_key: (B, Sw) order keys of the sketch hashes, ascending,
    padded with the largest int64; sk_strand: (B, Sw) int8; s_row: (B,)
    sketch sizes; ev_key / ev_strand: (B, E) order keys and strands of the
    events' records. Returns (slot (B, E) int32, svote (B, E) int32) as
    `_l2_walk_kernel` takes them."""
    Sw = sk_key.shape[1]
    slots = torch.searchsorted(sk_key, ev_key)
    inb = slots < s_row[:, None]
    at = slots.clamp(max=Sw - 1)
    eq = inb & (torch.gather(sk_key, 1, at) == ev_key)
    svote = torch.where(
        eq, torch.gather(sk_strand, 1, at).to(torch.int32)
        * ev_strand.to(torch.int32), 0)
    # ignored events (above the max query hash): dead slot S; events whose
    # hash is not in the sketch are offset by S + 1
    slot = torch.where(inb, slots, S).to(torch.int32)
    return torch.where(eq, slot, slot + (S + 1)), svote


class DeviceL2:
    """Batched device walk over L1 candidates, in chunks of BATCH rows;
    rows past E_CAP events or S_CAP sketch hashes go to the host walk.

    The host side works on whole calls and chunks, not on rows: the
    candidates' record windows are cut out of the index's columns with two
    vectorised binary searches, the slot lookup runs on the device beside
    the walk (`_slot_codes`), and the run emission is numpy over a chunk's
    (B, E) arrays."""

    BATCH = 256
    E_CAP = 768
    S_CAP = 256

    def __init__(self, index, params, device=None):
        self.params = params
        self.device = device_mod.resolve(device)
        # contiguous columns of the (seq_id, wpos)-sorted records
        rec_hash, self.rec_wpos, self.rec_wend, rec_seq, self.rec_strand = \
            index.soa()
        self.rec_key = _order_key(rec_hash)
        # (seq_id, wpos) as one ascending int64 (positions are below 2^32)
        self.rec_at = (rec_seq.astype(np.int64) << 32) | self.rec_wpos

    def walk(self, rows):
        """rows: list of (sketch, q_len, candidate). Returns per row a
        list[L2Mapping] or None (host route: oversized / non-default
        window)."""
        from ..utils import perf

        out: list = [None] * len(rows)
        prep = self._prepare(rows)
        n_dev = len(prep["rows"])
        for ri in prep["rows"].tolist():
            out[ri] = []
        for k0 in range(0, n_dev, self.BATCH):
            self._walk_chunk(rows, prep, k0, min(k0 + self.BATCH, n_dev),
                             out)
        # rows seen, and rows left to the host walk
        perf.add("map.l2_rows", len(rows))
        perf.add("map.l2_host_rows", len(rows) - n_dev)
        return out

    def _prepare(self, rows):
        """The events of every row this stage answers, flat and in row
        order: a candidate's events are its sequence's records with wpos in
        [range_start - w - 1, range_end], less the lead-ins (wpos <
        range_start) that closed at or before range_start. Returns a dict:
        rows (ids of the answered rows), offs (each one's first event in
        the flat arrays, and the total), rec (record index per event),
        main (event is at or past range_start)."""
        w = self.params.window_length
        n = len(rows)
        ok = np.fromiter((q_len == w and sk.sketch_size <= self.S_CAP
                          for sk, q_len, _ in rows), bool, n)
        seq = np.fromiter((c.seq_id for _, _, c in rows), np.int64, n)
        rs = np.fromiter((c.range_start for _, _, c in rows), np.int64, n)
        re = np.fromiter((c.range_end for _, _, c in rows), np.int64, n)
        top = (1 << 32) - 1
        lo = np.searchsorted(
            self.rec_at, (seq << 32) | np.clip(rs - w - 1, 0, top), "left")
        hi = np.searchsorted(
            self.rec_at, (seq << 32) | np.clip(re, 0, top), "right")
        width = np.where(ok & (re >= 0), hi - lo, 0).clip(min=0)
        row_of = np.repeat(np.arange(n), width)
        first = np.cumsum(width) - width
        rec = np.repeat(lo - first, width) + np.arange(len(row_of))
        main = self.rec_wpos[rec] >= rs[row_of]
        keep = main | (self.rec_wend[rec] > rs[row_of])
        kept = np.bincount(row_of[keep], minlength=n)
        answered = ok & (kept <= self.E_CAP)
        keep &= answered[row_of]
        ids = np.nonzero(answered)[0]
        offs = np.concatenate(([0], np.cumsum(kept[ids])))
        return dict(rows=ids, offs=offs, rec=rec[keep], main=main[keep])

    def _pack(self, rows, prep, k0, k1):
        """Host arrays of the chunk of answered rows k0 .. k1 - 1, padded
        to its longest row and widest sketch: (wpos, wend, ev_key,
        ev_strand, valid, is_main) of (B, E) and (sk_key, sk_strand) of
        (B, Sw), s_row (B,)."""
        ids, offs = prep["rows"], prep["offs"]
        B = k1 - k0
        a, b = int(offs[k0]), int(offs[k1])
        n_ev = np.diff(offs[k0:k1 + 1])
        E = max(int(n_ev.max()), 1)
        r = np.repeat(np.arange(B), n_ev)
        c = np.arange(b - a) - np.repeat(offs[k0:k1] - a, n_ev)
        rec = prep["rec"][a:b]

        def spread(values, dtype):
            out = np.zeros((B, E), dtype)
            out[r, c] = values
            return out

        sks = [rows[ri][0] for ri in ids[k0:k1].tolist()]
        Sw = max(max(sk.sketch_size for sk in sks), 1)
        sk_hash = np.full((B, Sw), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
        sk_strand = np.zeros((B, Sw), np.int8)
        for j, sk in enumerate(sks):
            sk_hash[j, :sk.sketch_size] = sk.hashes
            sk_strand[j, :sk.sketch_size] = sk.strand
        s_row = np.fromiter((sk.sketch_size for sk in sks), np.int32, B)
        return (spread(self.rec_wpos[rec], np.int32),
                spread(self.rec_wend[rec], np.int32),
                spread(self.rec_key[rec], np.int64),
                spread(self.rec_strand[rec], np.int8),
                spread(True, bool), spread(prep["main"][a:b], bool),
                _order_key(sk_hash), sk_strand, s_row)

    def _run(self, packed):
        """Slot lookup and walk on this object's device for one chunk's
        host arrays; returns (shared, votes) device tensors."""
        wpos, wend, ev_key, ev_strand, valid, _, sk_key, sk_strand, s_row = (
            torch.from_numpy(a).to(self.device) for a in packed)
        slot, svote = _slot_codes(sk_key, sk_strand, s_row, ev_key,
                                  ev_strand, S=self.S_CAP)
        return _l2_walk_kernel(wpos, wend, slot, svote, valid, s_row,
                               S=self.S_CAP)

    def _walk_chunk(self, rows, prep, k0, k1, out):
        from ..utils import perf

        packed = self._pack(rows, prep, k0, k1)
        with perf.span("map.l2.device") as run:
            shared, votes = self._run(packed)
            shared = shared.cpu().numpy()
            votes = votes.cpu().numpy()
        perf.add("map.device_s", run.seconds)
        perf.add("map.l2_device_calls", 1)
        ids = prep["rows"][k0:k1]
        seq_ids = [rows[ri][2].seq_id for ri in ids.tolist()]
        for j, m in self._emit(packed[0], packed[5], shared, votes,
                               seq_ids):
            out[ids[j]].append(m)

    def _emit(self, wpos, is_main, shared, votes, seq_ids):
        """Replay the argmax-run emission (mappingCore.hpp:402-435 + the
        _close_l2 join) from a chunk's per-event shared/votes: yields
        (row, L2Mapping) in row order. A row's main events follow its
        lead-ins, so runs of main events are runs of the row."""
        w = self.params.window_length
        sh = np.where(is_main, shared, -1)
        best = np.maximum(sh.max(axis=1), 1)
        at = is_main & (sh == best[:, None])
        edge = np.zeros((at.shape[0], 1), bool)
        # maximal runs of consecutive `at` events: first and last of each
        r0, c0 = np.nonzero(at & ~np.concatenate([edge, at[:, :-1]], axis=1))
        r1, c1 = np.nonzero(at & ~np.concatenate([at[:, 1:], edge], axis=1))
        start, end = wpos[r0, c0].astype(np.int64), wpos[r1, c1]
        # a run opens a mapping unless it is within one window of the
        # previous run of its row, which it then extends
        opens = np.ones(len(r0), bool)
        opens[1:] = (r0[1:] != r0[:-1]) | (end[:-1] + w < start[1:])
        first = np.nonzero(opens)[0]
        last = np.concatenate((first[1:], [len(r0)])) - 1
        # the strand is voted as of the opening run's last event
        fwd = votes[r1[first], c1[first]] >= 0
        for j, a, b, f in zip(r0[first].tolist(), start[first].tolist(),
                              end[last].tolist(), fwd.tolist()):
            yield j, L2Mapping(
                seq_id=seq_ids[j], mean_optimal_pos=(a + b) // 2,
                optimal_start=a, optimal_end=b,
                shared_sketch_size=int(best[j]),
                strand=STRAND_FWD if f else STRAND_REV)
