"""Device-side L1 mapping stage: batched hash join + interval sweep.

A torch program on tensors (eager, no hand-written kernel) that
re-formulates the reference's L1 candidate search (reference:
src/map/include/mappingCore.hpp:81-301) for BATCHES of query fragments,
integer-identical to the host implementation (map/l1l2.py +
native/l1l2.cpp) for the production split-mapping path (window_len == 0,
the default for every w-length fragment):

1. **join**: each fragment's sketch hashes are looked up in the index's
   sorted unique hashes; posting ranges turn into a ragged gather (fixed
   cap per fragment, overflow -> host route);
2. **sort**: endpoints key-sort by (target group run, seq, pos, side),
   reproducing the per-group subranges the host loop feeds to
   compute_l1_candidate_regions one at a time;
3. **sweep**: segmented cumulative sums give every position-group's
   distinct-hash coverage (open_cum at group end minus close_cum at the
   end of the lead (seq,pos) sub-run: the closed form of the
   trailing/leading pointer walk, including the reference's
   group-by-position-only and drop-last-group quirks);
4. **two thresholds**: pass 1's per-subrange best coverage raises the
   minimum-hit bar through the hypergeometric cutoff table; pass 2
   emits runs >= the raised bar (stage2 full-scan semantics) and joins
   candidates within the cluster length.

Hashes travel as order keys: a uint64 hash with its top bit flipped, read
as int64, sorts as the hash does (the pad hash 0xFFFF...F becomes the
largest int64), so one `torch.searchsorted` over the index's unique hashes
stands where an unrolled binary search over (hi, lo) uint32 pairs would.

Every gather index is clamped explicitly: torch raises on an index out of
range where a silent clamp may have been relied on.

Memory of one chunk: ~30 int32 / int64 arrays of (B, width) elements live
at the peak, where width is the chunk's longest posting list, `cap` at
most (B = 256, width = cap = 4096: 4 or 8 MB each); the run reductions are
`scatter_reduce` on (B, maxc + 1); no (B, cap, S) or (B, cap, maxc)
broadcast is materialised.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod

NEG = -(1 << 30)
BIG = 1 << 30
_I32 = torch.int32
_I64 = torch.int64


def _order_key(h: np.ndarray) -> np.ndarray:
    """uint64 hashes -> int64 keys of the same order (top bit flipped)."""
    h = np.ascontiguousarray(h, np.uint64)
    return (h ^ np.uint64(1 << 63)).view(np.int64)


def _seg_cumsum(x, seg_start):
    """Per-row int32 cumsum of non-negative x that resets at seg_start.

    The reset works by carrying each segment's base (plain-cumsum value
    just before the segment) forward with a max-scan: valid because the
    plain cumsum of non-negative values is non-decreasing."""
    c = torch.cumsum(x, dim=1, dtype=_I32)
    base = torch.where(seg_start, c - x, 0)
    carried = torch.cummax(base, dim=1).values
    return c - carried


def _take(a, idx):
    """take_along_axis(a, idx, axis=1) for int32 index arrays."""
    return torch.gather(a, 1, idx.to(_I64))


def _join_endpoints(qh, q_nh, uh, offs, ep_pos, ep_seq, ep_side, seq_group,
                    q_group, q_seqid, skip_grp, lower_tri, *, cap: int):
    """Hash join + skip filters: sketch hash keys -> padded endpoint arrays
    (pos, seq, side, grp) of shape (B, width <= cap), int32, plus
    per-fragment overflow."""
    B, S = qh.shape
    U = uh.shape[0]
    E = ep_pos.shape[0]
    dev = qh.device
    if U == 0 or E == 0:        # an index without postings joins nothing
        big = torch.full((B, 1), BIG, dtype=_I32, device=dev)
        zero = torch.zeros((B, 1), dtype=_I32, device=dev)
        return big, big.clone(), zero, big.clone(), \
            torch.zeros(B, dtype=torch.bool, device=dev)

    idx_c = torch.searchsorted(uh, qh).clamp_(max=U - 1)
    lane_s = torch.arange(S, dtype=_I32, device=dev)
    present = (uh[idx_c] == qh) & (lane_s[None, :] < q_nh[:, None])
    starts = torch.where(present, offs[idx_c], 0)
    ends = torch.where(present, offs[idx_c + 1], 0)   # offs holds U + 1
    lens = ends - starts
    cum = torch.cumsum(lens, dim=1, dtype=_I32)
    total = cum[:, -1]
    overflow = total > cap
    # the arrays are as wide as the chunk's longest row needs, `cap` at
    # most: a row within the cap has all its endpoints either way, and a
    # row over it is cut at `cap` as soon as there is one (one read of a
    # device scalar; everything after it is that much narrower)
    width = max(1, min(cap, int(total.max())))
    lane_c = torch.arange(width, dtype=_I32, device=dev).expand(B, width)
    # ragged gather: out slot j falls in the first hash range s with
    # cum[s] > j
    src = torch.searchsorted(cum, lane_c.contiguous(), right=True)
    src_c = src.clamp_(0, S - 1)
    base = torch.where(src_c > 0,
                       torch.gather(cum, 1, (src_c - 1).clamp_(min=0)), 0)
    within = lane_c - base
    ep_idx = torch.gather(starts, 1, src_c) + within
    valid = lane_c < total.clamp(max=cap)[:, None]
    ep_idx = ep_idx.clamp_(0, E - 1).to(_I64)
    pos = torch.where(valid, ep_pos[ep_idx], BIG)
    seq = torch.where(valid, ep_seq[ep_idx], BIG)
    side = torch.where(valid, ep_side[ep_idx].to(_I32), 0)

    # ---- filters (mappingCore.hpp:109-118) ----------------------------
    # invalid slots carry seq = BIG: clamp both sides before the gather
    n_seq = seq_group.shape[0]
    grp = torch.where(
        valid, seq_group[seq.clamp(0, max(n_seq - 1, 0)).to(_I64)], BIG)
    skip = skip_grp[:, None] & (grp == q_group[:, None])
    skip |= lower_tri[:, None] & (q_seqid[:, None] <= seq)
    valid = valid & ~skip
    pos = torch.where(valid, pos, BIG)
    seq = torch.where(valid, seq, BIG)
    grp = torch.where(valid, grp, BIG)
    side = torch.where(valid, side, 0)
    return pos, seq, side, grp, overflow


def _scatter_runs(idx, n, src, fill, reduce):
    """Per-row reduction of src into n slots by slot index idx (slot n is
    the discard slot); slots that receive nothing hold `fill`."""
    out = torch.full((src.shape[0], n + 1), fill, dtype=src.dtype,
                     device=src.device)
    out.scatter_reduce_(1, idx, src, reduce, include_self=True)
    return out[:, :n]


def _sweep_candidates(pos, seq, side, grp, min_hits, sketch_size,
                      cutoffs, cut_div, cluster_len, *, maxc: int,
                      stage1: bool = True):
    """Sort + interval-stacking sweep + two-threshold candidate emission
    over padded endpoint arrays (B, width). Returns (cand (B, maxc, 4),
    ncand (B,), run_overflow (B,))."""
    B, width = pos.shape
    dev = pos.device

    # ---- sort by (group, seq, pos, side) ------------------------------
    # all four arrays are keys (every value is < 2^31 and side + 1 < 4):
    # two packed int64 keys, the minor one sorted first, the major one
    # stably after it
    k_minor = pos.to(_I64) * 4 + (side + 1)
    k_major = grp.to(_I64) * (1 << 31) + seq
    k_minor, o1 = torch.sort(k_minor, dim=1, stable=True)
    k_major, o2 = torch.sort(torch.gather(k_major, 1, o1), dim=1,
                             stable=True)
    k_minor = torch.gather(k_minor, 1, o2)
    grp_s = (k_major >> 31).to(_I32)
    seq_s = (k_major & ((1 << 31) - 1)).to(_I32)
    pos_s = (k_minor >> 2).to(_I32)
    side_s = (k_minor & 3).to(_I32) - 1
    del k_minor, k_major, o1, o2
    valid = seq_s < BIG

    # ---- sweep --------------------------------------------------------
    true_col = torch.ones((B, 1), dtype=torch.bool, device=dev)
    grp_ne = grp_s[:, 1:] != grp_s[:, :-1]
    pos_ne = pos_s[:, 1:] != pos_s[:, :-1]
    seq_ne = seq_s[:, 1:] != seq_s[:, :-1]
    new_seg = torch.cat([true_col, grp_ne], dim=1) & valid
    opens = (valid & (side_s > 0)).to(_I32)
    closes = (valid & (side_s < 0)).to(_I32)
    open_cum = _seg_cumsum(opens, new_seg)
    close_cum = _seg_cumsum(closes, new_seg)

    # position groups (grouped by pos only within a subrange)
    pg_start = torch.cat([true_col, pos_ne | grp_ne], dim=1) & valid
    # (seq, pos) sub-runs
    sr_start = torch.cat([true_col, pos_ne | seq_ne], dim=1) & valid
    lane = torch.arange(width, dtype=_I32, device=dev).expand(B, width)
    big_col = torch.full((B, 1), BIG, dtype=_I32, device=dev)

    # end index of each run: (next run start) - 1 via reverse min-scan
    def run_end(start_mask):
        aft = torch.where(start_mask, lane, BIG)
        aft = torch.cat([aft[:, 1:], big_col], dim=1)
        aft = torch.cummin(aft.flip(1), dim=1).values.flip(1)
        return (aft - 1).clamp_(max=width - 1)

    pg_end = run_end(pg_start)            # per event: its pos-group end
    sr_end = run_end(sr_start)            # per event: its sub-run end

    # coverage evaluated at pos-group starts g:
    #   overlap(g) = open_cum[pg_end(g)] - close_cum[sr_end(g)]
    oc_at_pg_end = _take(open_cum, pg_end)
    cc_at_sr_end = _take(close_cum, sr_end)
    overlap = torch.where(pg_start, oc_at_pg_end - cc_at_sr_end, 0)

    # drop-last-group quirk: a pos-group whose end is the subrange's last
    # event is never examined (mappingCore.hpp:216-249 sampling)
    seg_end = run_end(new_seg)            # subrange end per event
    examined = pg_start & (pg_end < seg_end)

    # ---- pass 1: per-subrange best -> raised threshold ----------------
    # segment max via one scan: add a large per-segment offset so values
    # from earlier segments can never win (overlap < 2^20, segment count
    # is the number of target groups, small). int32, as the sums it
    # stands for.
    seg_off = torch.cumsum(new_seg, dim=1, dtype=_I32) * (1 << 20)
    fwd_best = torch.cummax(overlap + seg_off, dim=1).values - seg_off
    seg_best = _take(fwd_best, seg_end)   # per event
    # float32 divide by a float32 divisor that lives on the device: with a
    # host scalar torch may multiply by the reciprocal instead, and the
    # bucket could then differ by one at a boundary
    bucket = (torch.minimum(seg_best, sketch_size[:, None])
              .to(torch.float32) / cut_div).to(_I64)
    bucket = bucket.clamp_(0, cutoffs.shape[0] - 1)
    raised = torch.maximum(cutoffs[bucket], min_hits[:, None])
    thresh = torch.where(seg_best >= min_hits[:, None], raised, BIG)
    if not stage1:   # pass 1 disabled: plain minimum-hit threshold
        thresh = min_hits[:, None].expand(B, width)

    # ---- pass 2: eligible runs + candidate emission -------------------
    # compact examined groups to the left (stable) for run analysis
    order = torch.sort((~examined).to(torch.int8), dim=1,
                       stable=True).indices
    n_exam = examined.sum(dim=1, dtype=_I32)
    gvalid = lane < n_exam[:, None]

    def g(a, fill):
        return torch.where(gvalid, torch.gather(a, 1, order), fill)

    g_seq = g(seq_s, BIG)
    g_pos = g(pos_s, BIG)
    g_ov = g(overlap, 0)
    g_th = g(thresh, BIG)
    g_elig = gvalid & (g_ov >= g_th)

    # run starts among eligible compacted groups
    neg_col = torch.full((B, 1), -1, dtype=_I32, device=dev)
    p_seq = torch.cat([neg_col, g_seq[:, :-1]], dim=1)
    p_elig = torch.cat([~true_col, g_elig[:, :-1]], dim=1)
    rstart = g_elig & (~p_elig | (g_seq != p_seq))
    rid = torch.cumsum(rstart, dim=1, dtype=_I32) - 1
    rid = torch.where(g_elig, rid, -1)
    nruns = rid.max(dim=1).values + 1

    # per-run reductions (maxc runs at most; later runs and ineligible
    # groups go to the discard slot)
    r_idx = torch.where(g_elig & (rid < maxc), rid, maxc).to(_I64)
    r_start_pos = _scatter_runs(r_idx, maxc, g_pos, BIG, "amin")
    r_end_pos = _scatter_runs(r_idx, maxc, g_pos, NEG, "amax")
    r_inter = _scatter_runs(r_idx, maxc, g_ov, 0, "amax")
    r_seq = _scatter_runs(r_idx, maxc, g_seq, BIG, "amin")
    slot = torch.arange(maxc, dtype=_I32, device=dev)
    r_valid = slot[None, :] < nruns.clamp(max=maxc)[:, None]

    # candidate join (mappingCore.hpp:287-300): a run merges into the
    # previous candidate when same seq and start <= prev_end + cluster;
    # chained joins via segment ids
    pr_seq = torch.cat([neg_col, r_seq[:, :-1]], dim=1)
    pr_end = torch.cat([torch.full((B, 1), NEG, dtype=_I32, device=dev),
                        r_end_pos[:, :-1]], dim=1)
    joined = r_valid & (r_seq == pr_seq) & (
        r_start_pos <= pr_end + cluster_len)
    cstart = r_valid & ~joined
    cid = torch.cumsum(cstart, dim=1, dtype=_I32) - 1
    cid = torch.where(r_valid, cid, -1)
    ncand = cid.max(dim=1).values + 1
    c_idx = torch.where(r_valid, cid, maxc).to(_I64)
    c_seq = _scatter_runs(c_idx, maxc, r_seq, BIG, "amin")
    c_start = _scatter_runs(c_idx, maxc, r_start_pos, BIG, "amin")
    c_end = _scatter_runs(c_idx, maxc, r_end_pos, NEG, "amax")
    c_inter = _scatter_runs(c_idx, maxc, r_inter, 0, "amax")
    cand = torch.stack([c_seq, c_start, c_end, c_inter], dim=2)
    return cand, ncand.clamp(max=maxc), nruns > maxc


def pack_fragments(frags):
    """The L1 stage's host arrays for a list of fragment dicts: (qh keys
    (B, S) as wide as the longest sketch, q_nh (B,), meta (B, 4) of
    q_group, q_seqid, min_hits, sketch size)."""
    B = len(frags)
    S = max(max(len(f["hashes"]) for f in frags), 1)
    qh = np.full((B, S), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    q_nh = np.zeros(B, np.int32)
    meta = np.zeros((B, 4), np.int32)
    for i, f in enumerate(frags):
        h = np.asarray(f["hashes"], np.uint64)
        qh[i, :len(h)] = h
        q_nh[i] = len(h)
        meta[i] = (f["q_group"], f["q_seqid"], f["min_hits"], f["n"])
    return _order_key(qh), q_nh, meta


def answer_rows(frags, cand, ncand, overflow, params):
    """Per fragment, its candidate list [(seq, start, end, inter)] from a
    chunk's results brought to the host (cand as nested lists at least
    max(ncand) wide, ncand and overflow as lists), or None for the host
    route; counts the rows seen and left to the host."""
    from ..utils import perf

    out = []
    for i, f in enumerate(frags):
        # tail fragments (q_len != window) need the windowed hash-dedup
        # branch of the L1 sweep (l1l2.py, mappingCore.hpp windowLen !=
        # 0), which this batched sweep does not implement: those (at most
        # one per query) go to the identical host path, as do overflowed
        # rows and non-full-scan modes.
        if overflow[i] or f["q_len"] != params.window_length \
                or not params.stage2_full_scan:
            out.append(None)
            continue
        out.append([tuple(r) for r in cand[i][:ncand[i]]])
    perf.add("map.l1_rows", len(frags))
    perf.add("map.l1_host_rows", sum(r is None for r in out))
    return out


def _l1_kernel(qh, q_nh, uh, offs, ep_pos, ep_seq, ep_side, seq_group,
               q_group, q_seqid, skip_grp, lower_tri, min_hits,
               sketch_size, cutoffs, cut_div, cluster_len,
               *, cap: int, maxc: int, stage1: bool = True):
    """Batched single-device L1 (join + sweep), all tensors on one device.
    qh: (B, S) int64 order keys of the sketch hashes (pad: the key of
        0xFFFFFFFFFFFFFFFF); q_nh: (B,) valid hash counts
    uh: (U,) int64 order keys of the index's sorted unique hashes;
        offs: (U+1,) int32
    ep_pos/ep_seq: (E,) int32, ep_side: (E,) int8 (+1 open / -1 close)
    seq_group: (n_seqs,) int32 group per target seq id
    q_group/q_seqid: (B,) int32 per-fragment query group/seq id
    skip_grp/lower_tri: (B,) bool flags; min_hits, sketch_size: (B,) int32
    cutoffs: (T,) int32; cut_div: (1,) float32 tensor; cluster_len: int
    Returns (cand (B, maxc, 4) int32 [seq, start, end, inter],
             n_cand (B,), overflow (B,) bool)."""
    pos, seq, side, grp, overflow = _join_endpoints(
        qh, q_nh, uh, offs, ep_pos, ep_seq, ep_side, seq_group,
        q_group, q_seqid, skip_grp, lower_tri, cap=cap)
    cand, ncand, run_over = _sweep_candidates(
        pos, seq, side, grp, min_hits, sketch_size, cutoffs, cut_div,
        cluster_len, maxc=maxc, stage1=stage1)
    return cand, ncand, overflow | run_over


class DeviceL1:
    """Host wrapper: uploads the index arrays of a MinmerIndex once and
    runs batched fragment L1 (integer-identical to the host path for
    window_len == 0 + stage2 full-scan; anything else, or a fragment
    overflowing the endpoint cap, reports None for the host route)."""

    # fragments are processed in chunks of BATCH rows; a chunk is as wide
    # as its longest sketch (eager torch has no program to recompile, so
    # rows and sketch width are not padded further)
    BATCH = 256

    def __init__(self, index, group_arr: np.ndarray, params,
                 sketch_cutoffs: np.ndarray, cap: int = 4096,
                 maxc: int = 64, device=None):
        self.cap = cap
        self.maxc = maxc
        self.params = params
        self.device = dev = device_mod.resolve(device)
        ep = index.endpoints

        def up(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        # device-resident index (uploaded once per target subset; the
        # reference's posting table equivalent)
        self.uh = torch.from_numpy(
            _order_key(np.asarray(index.unique_hashes))).to(dev)
        self.offs = up(index.endpoint_offsets, np.int32)
        self.ep_pos = up(ep["pos"], np.int32)
        self.ep_seq = up(ep["seq_id"], np.int32)
        self.ep_side = up(ep["side"], np.int8)
        self.group_arr = up(group_arr, np.int32)
        self.cutoffs = up(sketch_cutoffs, np.int32)
        self.cut_div = up([max(1.0, params.sketch_size / 1000.0)],
                          np.float32)

    def candidates(self, frags):
        """frags: list of dicts with keys hashes (sorted u64 array),
        n (sketch size), q_len, q_seqid, q_group, min_hits.
        Returns list of (list[tuple(seq,start,end,inter)] | None)."""
        out: list = []
        for c0 in range(0, len(frags), self.BATCH):
            out.extend(self._candidates_chunk(frags[c0:c0 + self.BATCH]))
        return out

    def _pack(self, frags):
        """The chunk's host arrays (`pack_fragments`)."""
        return pack_fragments(frags)

    def _run(self, qh, q_nh, meta):
        """_l1_kernel on this object's device for packed host arrays;
        returns device tensors."""
        p = self.params
        dev = self.device
        B = qh.shape[0]
        meta_d = torch.from_numpy(meta).to(dev)
        return _l1_kernel(
            torch.from_numpy(qh).to(dev), torch.from_numpy(q_nh).to(dev),
            self.uh, self.offs, self.ep_pos, self.ep_seq, self.ep_side,
            self.group_arr, meta_d[:, 0], meta_d[:, 1],
            torch.full((B,), bool(p.skip_self or p.skip_prefix), device=dev),
            torch.full((B,), bool(p.lower_triangular), device=dev),
            meta_d[:, 2], meta_d[:, 3], self.cutoffs, self.cut_div,
            int(p.window_length), cap=self.cap, maxc=self.maxc,
            stage1=bool(p.stage1_topANI_filter))

    def _candidates_chunk(self, frags):
        from ..utils import perf

        if not frags:
            return []
        packed = self._pack(frags)
        with perf.span("map.l1.device") as run:
            cand, ncand, overflow = self._run(*packed)
            ncand = ncand.cpu().tolist()
            overflow = overflow.cpu().tolist()
            cand = cand[:, :max(ncand)].cpu().tolist()
        perf.add("map.device_s", run.seconds)
        perf.add("map.device_calls", 1)
        return answer_rows(frags, cand, ncand, overflow, self.params)
