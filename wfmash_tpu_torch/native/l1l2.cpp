// Native L1/L2 mapping stages — bit-identical ports of the executable
// specs in wfmash_tpu/map/l1l2.py (themselves ports of the reference's
// mappingCore.hpp:136-442 and slidingMap.hpp:27-212).
//
// l1_sweep: the two-pass interval-stacking sweep producing L1 candidate
// regions (before the cross-call proximal join, which stays in Python).
// l2_walk:  the sliding shared-sketch maximization over one candidate.
//
// Compiled lazily by wfmash_tpu/native/__init__.py (g++ -O3); tested
// bit-identical against the Python spec.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

int64_t l1_sweep(const int64_t* pos, const int64_t* seq, const int8_t* side,
                 const uint64_t* hash, int64_t n,
                 int64_t window_len, int64_t minimum_hits,
                 int stage1_filter, int stage2_full_scan,
                 int64_t sketch_size, double cutoff_div,
                 const int32_t* sketch_cutoffs, int64_t n_cutoffs,
                 int64_t* out_seq, int64_t* out_start, int64_t* out_end,
                 int64_t* out_inter, int64_t cap) {
    if (n == 0) return 0;

    // materialize per-position groups: (lead_seq, lead_pos, overlap)
    std::vector<int64_t> g_seq, g_pos, g_cov;
    g_seq.reserve(n);
    g_pos.reserve(n);
    g_cov.reserve(n);
    {
        std::unordered_map<uint64_t, int64_t> freq;
        int64_t overlap = 0, trailing = 0, leading = 0;
        while (leading < n) {
            int64_t lead_seq = seq[leading];
            int64_t lead_pos = pos[leading];
            while (trailing < n &&
                   ((seq[trailing] == lead_seq &&
                     pos[trailing] <= lead_pos - window_len) ||
                    seq[trailing] < lead_seq)) {
                if (side[trailing] == -1) {  // CLOSE
                    uint64_t h = hash[trailing];
                    if (window_len != 0) freq[h] -= 1;
                    int64_t f = 0;
                    auto it = freq.find(h);
                    if (it != freq.end()) f = it->second;
                    if (window_len == 0 || f == 0) overlap -= 1;
                }
                trailing += 1;
            }
            // leading advance groups by POSITION ONLY (mappingCore.hpp:176)
            while (leading < n && pos[leading] == lead_pos) {
                if (side[leading] == 1) {  // OPEN
                    uint64_t h = hash[leading];
                    int64_t f = 0;
                    auto it = freq.find(h);
                    if (it != freq.end()) f = it->second;
                    if (window_len == 0 || f == 0) overlap += 1;
                    if (window_len != 0) freq[h] = f + 1;
                }
                leading += 1;
            }
            g_seq.push_back(lead_seq);
            g_pos.push_back(lead_pos);
            g_cov.push_back(overlap);
        }
    }
    const int64_t G = (int64_t)g_seq.size();

    // pass 1: best intersection raises minimum_hits via the cutoff table
    if (stage1_filter) {
        int64_t best = 0;
        for (int64_t i = 0; i < G; i++) best = std::max(best, g_cov[i]);
        if (best < minimum_hits) return 0;
        int64_t bucket =
            (int64_t)((double)std::min(best, sketch_size) / cutoff_div);
        if (bucket >= 0 && bucket < n_cutoffs)
            minimum_hits =
                std::max((int64_t)sketch_cutoffs[bucket], minimum_hits);
    }

    // pass 2 with the reference's one-behind sampling: group i's body
    // examines group i-1's coverage; the final group is never examined
    int64_t n_out = 0;
    bool in_cand = false;
    int64_t c_seq = 0, c_start = 0, c_end = 0, c_inter = 0;
    for (int64_t i = 0; i + 1 < G; i++) {
        int64_t prev_seq = g_seq[i], prev_pos = g_pos[i], prev_cov = g_cov[i];
        if (prev_cov >= minimum_hits) {
            if (in_cand && c_seq != prev_seq) {
                if (n_out >= cap) return -1;
                out_seq[n_out] = c_seq;
                out_start[n_out] = c_start;
                out_end[n_out] = c_end;
                out_inter[n_out] = c_inter;
                n_out += 1;
                in_cand = false;
            }
            if (!in_cand) {
                c_seq = prev_seq;
                c_start = prev_pos - window_len;
                c_end = prev_pos - window_len;
                c_inter = prev_cov;
                in_cand = true;
            } else if (stage2_full_scan) {
                c_inter = std::max(c_inter, prev_cov);
                c_end = prev_pos - window_len;
            } else if (c_inter < prev_cov) {
                c_inter = prev_cov;
                c_start = prev_pos - window_len;
                c_end = prev_pos - window_len;
            }
        } else if (in_cand) {
            if (n_out >= cap) return -1;
            out_seq[n_out] = c_seq;
            out_start[n_out] = c_start;
            out_end[n_out] = c_end;
            out_inter[n_out] = c_inter;
            n_out += 1;
            in_cand = false;
        }
    }
    if (in_cand) {
        if (n_out >= cap) return -1;
        out_seq[n_out] = c_seq;
        out_start[n_out] = c_start;
        out_end[n_out] = c_end;
        out_inter[n_out] = c_inter;
        n_out += 1;
    }
    return n_out;
}

// l1_sweep over MANY group subranges in one call (the Python caller
// previously made one ctypes call per target group per fragment —
// ~12k calls on LPA; the loop + glue dominated the mapping wall).
// grp_b holds n_groups+1 boundaries into the endpoint arrays. Each
// group runs the exact single-group sweep (minimum_hits re-derived
// from the same base), then one in-place pass applies the proximal
// join (mappingCore.hpp:287-300) across the concatenated results —
// identical to the per-call join since candidates are emitted in the
// same order and only consecutive same-seq candidates ever merge.
int64_t l1_sweep_multi(const int64_t* pos, const int64_t* seq,
                       const int8_t* side, const uint64_t* hash,
                       const int64_t* grp_b, int64_t n_groups,
                       int64_t window_len, int64_t minimum_hits,
                       int stage1_filter, int stage2_full_scan,
                       int64_t sketch_size, double cutoff_div,
                       const int32_t* sketch_cutoffs, int64_t n_cutoffs,
                       int64_t cluster_len,
                       int64_t* out_seq, int64_t* out_start,
                       int64_t* out_end, int64_t* out_inter, int64_t cap) {
    int64_t n_out = 0;
    for (int64_t g = 0; g < n_groups; g++) {
        int64_t b = grp_b[g], e = grp_b[g + 1];
        if (e <= b) continue;
        int64_t got = l1_sweep(pos + b, seq + b, side + b, hash + b,
                               e - b, window_len, minimum_hits,
                               stage1_filter, stage2_full_scan,
                               sketch_size, cutoff_div, sketch_cutoffs,
                               n_cutoffs, out_seq + n_out,
                               out_start + n_out, out_end + n_out,
                               out_inter + n_out, cap - n_out);
        if (got < 0) return -1;
        n_out += got;
    }
    // proximal join, in place
    int64_t w = 0;
    for (int64_t i = 0; i < n_out; i++) {
        if (w > 0 && out_seq[i] == out_seq[w - 1] &&
            out_start[i] <= out_end[w - 1] + cluster_len) {
            out_end[w - 1] = out_end[i];
            out_inter[w - 1] =
                std::max(out_inter[w - 1], out_inter[i]);
        } else {
            out_seq[w] = out_seq[i];
            out_start[w] = out_start[i];
            out_end[w] = out_end[i];
            out_inter[w] = out_inter[i];
            w += 1;
        }
    }
    return w;
}

// The WHOLE per-fragment L1 stage in one call: gather the sketch
// hashes' endpoint ranges, apply the self/group/lower-triangular skip
// (mappingCore.hpp:109-118), stable-sort by (seq, pos, side) — the
// same order and tie behavior as np.lexsort over the gather order —
// then run the per-group sweeps + proximal join (l1_sweep_multi).
int64_t l1_fragment(const int64_t* ep_pos, const uint64_t* ep_hash,
                    const int32_t* ep_seq, const int8_t* ep_side,
                    const int64_t* starts, const int64_t* ends, int64_t S,
                    const int64_t* group_of, int64_t query_group,
                    int64_t query_seq_id, int skip_group, int lower_tri,
                    int split_by_group,
                    int64_t window_len, int64_t minimum_hits,
                    int stage1_filter, int stage2_full_scan,
                    int64_t sketch_size, double cutoff_div,
                    const int32_t* sketch_cutoffs, int64_t n_cutoffs,
                    int64_t cluster_len,
                    int64_t* out_seq, int64_t* out_start,
                    int64_t* out_end, int64_t* out_inter, int64_t cap) {
    struct Pt {
        uint64_t key;
        uint64_t hash;
    };
    std::vector<Pt> pts;
    for (int64_t s = 0; s < S; s++) {
        for (int64_t j = starts[s]; j < ends[s]; j++) {
            int64_t sq = ep_seq[j];
            if (skip_group && group_of[sq] == query_group) continue;
            if (lower_tri && query_seq_id <= sq) continue;
            if (sq >= (1ll << 23) || ep_pos[j] < 0 ||
                ep_pos[j] >= (1ll << 40))
                return -1;   // key packing overflow: caller falls back
            uint64_t key = ((uint64_t)sq << 41) |
                           ((uint64_t)ep_pos[j] << 1) |
                           (ep_side[j] > 0 ? 1u : 0u);
            pts.push_back({key, ep_hash[j]});
        }
    }
    int64_t n = (int64_t)pts.size();
    if (n == 0) return 0;
    std::stable_sort(pts.begin(), pts.end(),
                     [](const Pt& a, const Pt& b) { return a.key < b.key; });

    // decode into parallel arrays for the sweep
    std::vector<int64_t> pos(n), seq(n), grp_b;
    std::vector<int8_t> side(n);
    std::vector<uint64_t> hash(n);
    for (int64_t i = 0; i < n; i++) {
        seq[i] = (int64_t)(pts[i].key >> 41);
        pos[i] = (int64_t)((pts[i].key >> 1) & ((1ull << 40) - 1));
        side[i] = (pts[i].key & 1) ? 1 : -1;
        hash[i] = pts[i].hash;
    }
    grp_b.push_back(0);
    if (split_by_group) {
        for (int64_t i = 1; i < n; i++)
            if (group_of[seq[i]] != group_of[seq[i - 1]])
                grp_b.push_back(i);
    }
    grp_b.push_back(n);
    return l1_sweep_multi(pos.data(), seq.data(), side.data(), hash.data(),
                          grp_b.data(), (int64_t)grp_b.size() - 1,
                          window_len, minimum_hits, stage1_filter,
                          stage2_full_scan, sketch_size, cutoff_div,
                          sketch_cutoffs, n_cutoffs, cluster_len,
                          out_seq, out_start, out_end, out_inter, cap);
}

// ---------------------------------------------------------------------------

struct Slide {
    // bottom-s union pivot over the query sketch (slidingMap.hpp:27-212)
    const uint64_t* q;
    const int8_t* qs;
    int64_t n;
    std::vector<int64_t> strand_vote, num_before;
    std::vector<uint8_t> active;
    int64_t pivot, piv_rank, shared_sketch, strand_votes, intersection;

    Slide(const uint64_t* q_, const int8_t* qs_, int64_t n_)
        : q(q_), qs(qs_), n(n_), strand_vote(n_, 0), num_before(n_, 1),
          active(n_, 0), pivot(n_ - 1), piv_rank(n_), shared_sketch(0),
          strand_votes(0), intersection(0) {}

    void insert(uint64_t h, int64_t strand) {
        int64_t loc = std::lower_bound(q, q + n, h) - q;
        if (loc >= n) return;
        if (q[loc] == h) {
            active[loc] = 1;
            strand_vote[loc] += (int64_t)qs[loc] * strand;
            intersection += 1;
            if (q[loc] <= q[pivot]) {
                shared_sketch += 1;
                strand_votes += strand_vote[loc];
            }
        } else {
            num_before[loc] += 1;
            if (q[loc] <= q[pivot]) piv_rank += 1;
            if (piv_rank > n) {
                shared_sketch -= active[pivot] ? 1 : 0;
                strand_votes -= strand_vote[pivot];
                piv_rank -= num_before[pivot];
                pivot -= 1;
            }
        }
    }

    void erase(uint64_t h, int64_t strand) {
        int64_t loc = std::lower_bound(q, q + n, h) - q;
        if (loc >= n) return;
        if (q[loc] == h) {
            if (q[loc] <= q[pivot]) {
                shared_sketch -= 1;
                strand_votes -= strand_vote[loc];
            }
            active[loc] = 0;
            strand_vote[loc] = 0;
            intersection -= 1;
        } else {
            num_before[loc] -= 1;
            if (q[loc] <= q[pivot]) piv_rank -= 1;
            if (pivot + 1 < n &&
                piv_rank + num_before[pivot + 1] <= n) {
                pivot += 1;
                shared_sketch += active[pivot] ? 1 : 0;
                strand_votes += strand_vote[pivot];
                piv_rank += num_before[pivot];
            }
        }
    }
};

static void close_l2(int64_t* out, int64_t& n_out, int64_t cap,
                     int64_t seq_id2, int64_t opt_start, int64_t opt_end,
                     int64_t shared, int64_t strand_votes, int64_t w,
                     bool& overflow) {
    int64_t mean = (opt_start + opt_end) >= 0
                       ? (opt_start + opt_end) / 2
                       : -(((-(opt_start + opt_end)) + 1) / 2);  // floor div
    // python // floors; replicate for negatives
    int64_t sum = opt_start + opt_end;
    mean = (sum >= 0) ? sum / 2 : -((-sum + 1) / 2);
    int64_t strand = strand_votes >= 0 ? 1 : -1;
    if (n_out == 0 || out[(n_out - 1) * 6 + 3] + w < opt_start) {
        if (n_out >= cap) { overflow = true; return; }
        int64_t* r = out + n_out * 6;
        r[0] = seq_id2;
        r[1] = mean;
        r[2] = opt_start;
        r[3] = opt_end;
        r[4] = shared;
        r[5] = strand;
        n_out += 1;
    } else {
        int64_t* r = out + (n_out - 1) * 6;
        r[3] = opt_end;
        int64_t s2 = r[2] + opt_end;
        r[1] = (s2 >= 0) ? s2 / 2 : -((-s2 + 1) / 2);
    }
}

int64_t l2_walk(const uint64_t* mi_hash, const int64_t* mi_wpos,
                const int64_t* mi_wend, const int32_t* mi_seq,
                const int8_t* mi_strand, int64_t n,
                int64_t cand_seq, int64_t range_start, int64_t range_end,
                const uint64_t* q_hashes, const int8_t* q_strand,
                int64_t s, int64_t window_len, int64_t w,
                int64_t* out, int64_t cap) {
    // lower_bound by (seq_id, wpos) >= (cand_seq, range_start - w - 1)
    int64_t lo_pos = range_start - w - 1;
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid2 = (lo + hi) / 2;
        if (mi_seq[mid2] < cand_seq ||
            (mi_seq[mid2] == cand_seq && mi_wpos[mid2] < lo_pos))
            lo = mid2 + 1;
        else
            hi = mid2;
    }

    typedef std::pair<int64_t, int64_t> HeapEl;  // (wpos_end, index)
    std::priority_queue<HeapEl, std::vector<HeapEl>, std::greater<HeapEl>>
        sliding;
    std::unordered_map<uint64_t, int64_t> freq;
    Slide slide(q_hashes, q_strand, s);

    int64_t n_out = 0;
    bool overflow = false;
    int64_t best = 1;
    bool in_cand = false;
    int64_t c_start = 0, c_end = 0, c_shared = 0;
    int64_t i = lo;

    while (i < n && mi_seq[i] == cand_seq && mi_wpos[i] < range_start) {
        if (mi_wend[i] > range_start) {
            uint64_t h = mi_hash[i];
            int64_t f = 1;
            if (window_len > 0) f = (freq[h] += 1);
            if (window_len == 0 || f == 1) {
                sliding.push({mi_wend[i], i});
                slide.insert(h, mi_strand[i]);
            }
        }
        i += 1;
    }

    while (i < n && mi_seq[i] == cand_seq &&
           mi_wpos[i] <= range_end + window_len) {
        int64_t prev_votes = slide.strand_votes;
        int64_t wpos = mi_wpos[i];

        while (!sliding.empty() && sliding.top().first <= wpos - window_len) {
            int64_t j = sliding.top().second;
            uint64_t h = mi_hash[j];
            int64_t f = 0;
            if (window_len > 0) f = (freq[h] -= 1);
            if (window_len == 0 || f == 0) {
                slide.erase(h, mi_strand[j]);
                sliding.pop();
            }
        }

        uint64_t h = mi_hash[i];
        int64_t f = 1;
        if (window_len > 0) f = (freq[h] += 1);
        if (window_len == 0 || f == 1) {
            slide.insert(h, mi_strand[i]);
            sliding.push({mi_wend[i], i});
        } else {
            i += 1;
            continue;
        }

        if (slide.shared_sketch > best) {
            n_out = 0;
            in_cand = true;
            best = slide.shared_sketch;
            c_start = wpos - window_len;
            c_end = wpos - window_len;
            c_shared = slide.shared_sketch;
        } else if (slide.shared_sketch == best) {
            if (!in_cand) {
                c_start = wpos - window_len;
                c_shared = slide.shared_sketch;
            }
            in_cand = true;
            c_end = wpos - window_len;
        } else {
            if (in_cand) {
                close_l2(out, n_out, cap, cand_seq, c_start, c_end, c_shared,
                         prev_votes, w, overflow);
                if (overflow) return -1;
            }
            in_cand = false;
        }
        i += 1;
    }

    if (in_cand) {
        close_l2(out, n_out, cap, cand_seq, c_start, c_end, c_shared,
                 slide.strand_votes, w, overflow);
        if (overflow) return -1;
    }
    return n_out;
}

// l2_walk over MANY candidates in one call (one ctypes call per
// fragment instead of one per candidate — see l1_sweep_multi above).
// Results concatenate in candidate order; out_counts[i] = number of
// 6-int rows for candidate i.
int64_t l2_walk_multi(const uint64_t* mi_hash, const int64_t* mi_wpos,
                      const int64_t* mi_wend, const int32_t* mi_seq,
                      const int8_t* mi_strand, int64_t n,
                      const int64_t* cand_seq, const int64_t* range_start,
                      const int64_t* range_end, int64_t n_cands,
                      const uint64_t* q_hashes, const int8_t* q_strand,
                      int64_t s, int64_t window_len, int64_t w,
                      int64_t* out, int64_t cap, int64_t* out_counts) {
    int64_t n_out = 0;
    for (int64_t c = 0; c < n_cands; c++) {
        int64_t got = l2_walk(mi_hash, mi_wpos, mi_wend, mi_seq,
                              mi_strand, n, cand_seq[c], range_start[c],
                              range_end[c], q_hashes, q_strand, s,
                              window_len, w, out + 6 * n_out,
                              cap - n_out);
        if (got < 0) return -1;
        out_counts[c] = got;
        n_out += got;
    }
    return n_out;
}

// l1_fragment over MANY fragments in one call (one ctypes call per
// QUERY instead of one per fragment). starts/ends concatenate with
// s_off fragment offsets; window_len / minimum_hits / sketch_size are
// per-fragment. Candidates concatenate in fragment order with
// out_counts[f] rows each (-1 = key-packing overflow: caller re-runs
// that fragment on its per-fragment path). Returns total rows or -2
// when cap is insufficient.
int64_t l1_fragment_multi(
    const int64_t* ep_pos, const uint64_t* ep_hash,
    const int32_t* ep_seq, const int8_t* ep_side,
    const int64_t* starts, const int64_t* ends, const int64_t* s_off,
    int64_t n_frag, const int64_t* group_of, int64_t query_group,
    int64_t query_seq_id, int skip_group, int lower_tri,
    int split_by_group, const int64_t* window_len,
    const int64_t* minimum_hits, int stage1_filter,
    int stage2_full_scan, const int64_t* sketch_size,
    double cutoff_div, const int32_t* sketch_cutoffs,
    int64_t n_cutoffs, int64_t cluster_len, int64_t* out_seq,
    int64_t* out_start, int64_t* out_end, int64_t* out_inter,
    int64_t cap, int64_t* out_counts) {
    int64_t n_out = 0;
    for (int64_t f = 0; f < n_frag; f++) {
        int64_t got = l1_fragment(
            ep_pos, ep_hash, ep_seq, ep_side, starts + s_off[f],
            ends + s_off[f], s_off[f + 1] - s_off[f], group_of,
            query_group, query_seq_id, skip_group, lower_tri,
            split_by_group, window_len[f], minimum_hits[f],
            stage1_filter, stage2_full_scan, sketch_size[f], cutoff_div,
            sketch_cutoffs, n_cutoffs, cluster_len, out_seq + n_out,
            out_start + n_out, out_end + n_out, out_inter + n_out,
            cap - n_out);
        if (got == -2) return -2;
        out_counts[f] = got;   // -1 = overflow: per-fragment fallback
        if (got > 0) n_out += got;
    }
    return n_out;
}

// Union-find chaining roots for mergeMappingsInRangeWithChains
// (map/chain.py::merge_mappings_with_chains is the Python spec —
// bit-identical: dset64 union-by-rank with smaller-root-wins ties
// [common/dset64.hpp:88-118 semantics], the same geometric best-pair
// scan, and the same union call order, which the root identities —
// and hence downstream chain ids — observe). Inputs are the SORTED
// (refSeqId, strand, queryStart, refStart) order; split_id maps to
// original indices. Writes find(split_id[i]) per position to out.
void chain_roots(const int64_t* ref_seq_id, const int8_t* strand,
                 const int64_t* q_start, const int64_t* q_end,
                 const int64_t* r_start, const int64_t* r_end,
                 const int64_t* split_id, int64_t n, int64_t max_dist,
                 int64_t rdist_floor, int64_t* out) {
    std::vector<int64_t> parent(n), rank_(n, 0);
    for (int64_t i = 0; i < n; i++) parent[i] = i;
    auto find = [&](int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };
    auto unite = [&](int64_t a, int64_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return;
        int64_t r1 = rank_[a], r2 = rank_[b];
        if (r1 > r2 || (r1 == r2 && a < b)) {
            std::swap(a, b);
            std::swap(r1, r2);
        }
        parent[a] = b;
        if (r1 == r2) rank_[b]++;
    };
    const double INF = 1e300;
    std::vector<double> pair_score(n, INF);
    std::vector<int64_t> pair_id(n, 0);
    int64_t g0 = 0;
    while (g0 < n) {
        int64_t g1 = g0 + 1;
        while (g1 < n && ref_seq_id[g1] == ref_seq_id[g0] &&
               strand[g1] == strand[g0])
            g1++;
        for (int64_t i = g0; i < g1; i++) {
            if (pair_score[i] != INF) unite(split_id[i], pair_id[i]);
            double best_score = INF;
            int64_t best_j = g1;
            for (int64_t j = i + 1; j < g1; j++) {
                if (q_start[j] > q_end[i] + max_dist) break;
                int64_t q_dist = q_start[j] - q_end[i];
                if (q_dist < 0) q_dist = 0;
                int64_t r_dist = (strand[i] >= 0)
                                     ? r_start[j] - r_end[i]
                                     : r_start[i] - r_end[j];
                if (q_dist <= max_dist && r_dist >= -rdist_floor &&
                    r_dist <= max_dist) {
                    double dist_sq = (double)q_dist * q_dist +
                                     (double)r_dist * r_dist;
                    if (dist_sq < best_score && dist_sq < pair_score[j]) {
                        best_score = dist_sq;
                        best_j = j;
                    }
                }
            }
            if (best_j != g1) {
                pair_score[best_j] = best_score;
                pair_id[best_j] = split_id[i];
            }
        }
        g0 = g1;
    }
    for (int64_t i = 0; i < n; i++)
        if (pair_score[i] != INF) unite(split_id[i], pair_id[i]);
    for (int64_t i = 0; i < n; i++) out[i] = find(split_id[i]);
}

}  // extern "C"
