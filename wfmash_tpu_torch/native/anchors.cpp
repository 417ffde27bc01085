// Native anchor-chain helpers for the segmented aligner.
//
// lis_chain: longest strictly-increasing subsequence of (qpos asc, tpos)
// anchor pairs — the planning hot loop (wfmash_tpu/align/segmented.py::
// _lis_chain is the Python spec; bit-identical selection incl. the
// lexsort tie order). O(n log n) patience sorting.

#include <algorithm>
#include <array>
#include <cstdint>
#include <ctime>
#include <vector>

// Fine-grained plan timing (diagnostic; read via segsolve_phase_times
// slots 13-15 when compiled into _segsolve.so): 13 codes_s, 14 join_s,
// 15 lis_s.
thread_local double g_anchor_prof[3] = {0};
static inline double anchors_now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

extern "C" {

// qpos/tpos: n int64 pairs already LEXSORTED by (qpos, tpos) ascending
// (the caller sorts; ties resolved identically to np.lexsort).
// out: caller-allocated n int64 slots; returns the kept count m with
// out[0..m) = indices into the SORTED arrays forming the chain.
int64_t lis_chain(const int64_t* tpos, int64_t n, int64_t* out) {
    if (n == 0) return 0;
    std::vector<int64_t> tails;       // smallest tail tpos per length
    std::vector<int64_t> tails_idx;
    std::vector<int64_t> parent(n, -1);
    tails.reserve(256); tails_idx.reserve(256);
    for (int64_t i = 0; i < n; i++) {
        int64_t t = tpos[i];
        // bisect_left
        size_t lo = 0, hi = tails.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (tails[mid] < t) lo = mid + 1; else hi = mid;
        }
        if (lo > 0) parent[i] = tails_idx[lo - 1];
        if (lo == tails.size()) {
            tails.push_back(t);
            tails_idx.push_back(i);
        } else {
            tails[lo] = t;
            tails_idx[lo] = i;
        }
    }
    int64_t m = 0;
    int64_t i = tails_idx.back();
    while (i >= 0) { out[m++] = i; i = parent[i]; }
    // reverse in place
    for (int64_t a = 0, b = m - 1; a < b; a++, b--) {
        int64_t tmp = out[a]; out[a] = out[b]; out[b] = tmp;
    }
    return m;
}

}  // extern "C" (reopened below; internal helpers follow)

// Anchor-chain selection for one block (segmented.py::find_anchors is
// the Python spec — bit-identical selection: 2-bit rolling k-mer
// codes, unique (max_occ=1) or rare (count <= max_occ,
// cartesian-paired, max_pairs cutoff after each query k-mer's hits)
// matching, (qpos, tpos) lexsort, strict-LIS on tpos, then the
// strict-monotone qpos filter). Appends anchors to out_q/out_t.
static void find_anchors_impl(const uint8_t* q, int64_t qlen,
                              const uint8_t* t, int64_t tlen,
                              int k, int max_occ, int64_t max_pairs,
                              std::vector<int64_t>& out_q,
                              std::vector<int64_t>& out_t) {
    // magic-static init is thread-safe (the old two-static pattern had
    // a benign but racy init when called from a thread pool)
    static const auto B2_tab = []() {
        std::array<int8_t, 256> a;
        a.fill(-1);
        a['A'] = 0; a['C'] = 1; a['G'] = 2; a['T'] = 3;
        return a;
    }();
    const int8_t* B2 = B2_tab.data();
    struct CP { uint64_t code; int64_t pos; };
    auto codes_of = [&](const uint8_t* s, int64_t len, int64_t stride,
                        std::vector<CP>& out_cp) {
        int64_t n = len - k + 1;
        if (n <= 0) return;
        out_cp.reserve(stride > 1 ? n / stride + 1 : n);
        uint64_t code = 0;
        const uint64_t mask = (k >= 32) ? ~0ull
            : ((1ull << (2 * k)) - 1);
        int bad = 0;   // bases since last invalid (lazy counter)
        for (int64_t i = 0; i < len; i++) {
            int8_t b = B2[s[i]];
            code = ((code << 2) | (uint64_t)(b < 0 ? 0 : b)) & mask;
            if (b < 0) bad = k;
            else if (bad > 0) bad--;
            if (i >= k - 1 && bad == 0) {
                int64_t p = i - k + 1;
                if (stride == 1 || p % stride == 0)
                    out_cp.push_back({code, p});
            }
        }
    };
    // density sampling (spec rule, mirrored in segmented.find_anchors):
    // on big blocks unique anchors land every ~1 bp and the chain is
    // thousands of times denser than the >= seg_target cut spacing
    // needs; sampling query-side k-mer positions at stride 4 keeps
    // anchors every ~4 bp while quartering the join/sort/LIS cost.
    const int64_t qstride =
        (max_occ == 1 && qlen > 16384) ? 4 : 1;
    std::vector<CP> qc, tc;
    double tp0 = anchors_now();
    codes_of(q, qlen, qstride, qc);
    codes_of(t, tlen, 1, tc);
    g_anchor_prof[0] += anchors_now() - tp0;
    if (qc.empty() || tc.empty()) return;
    tp0 = anchors_now();
    std::vector<CP> pairs;   // code field reused as qpos; pos = tpos
    bool presorted = false;  // pair stream already lexsorted by (q,t)
    constexpr uint64_t MUL = 0x9E3779B97F4A7C15ull;
    constexpr size_t PF = 8;  // software-prefetch distance: the join
    // tables exceed L2, so every probe was a cache miss — prefetching
    // the home slot ~8 probes ahead hides most of that latency
    if (max_occ == 1) {
        // unique-anchor path: open-addressing hash join with compact
        // 24-byte slots (counts saturate at 255 — only ==1 is tested)
        struct Slot {
            uint64_t code;
            uint32_t epoch;
            uint8_t qn, tn;
            int32_t qpos, tpos;
        };
        static thread_local std::vector<Slot> table;
        static thread_local uint32_t epoch = 0;
        size_t want = 1;   // both sides insert (t-only codes get
        while (want < 2 * (qc.size() + tc.size() + 1)) want <<= 1;
        if (table.size() < want || epoch == 0xFFFFFFFFu) {
            table.assign(std::max(want, table.size()), Slot{});
            epoch = 0;
        }
        epoch++;
        const size_t msk = table.size() - 1;
        auto slot_of = [&](uint64_t code) -> Slot& {
            size_t h = (size_t)(code * MUL) & msk;
            for (;;) {
                Slot& s = table[h];
                if (s.epoch != epoch) {
                    s.epoch = epoch;
                    s.code = code;
                    s.qn = s.tn = 0;
                    return s;
                }
                if (s.code == code) return s;
                h = (h + 1) & msk;
            }
        };
        auto pf = [&](const std::vector<CP>& v, size_t i) {
            if (i + PF < v.size())
                __builtin_prefetch(
                    &table[(size_t)(v[i + PF].code * MUL) & msk]);
        };
        for (size_t i = 0; i < qc.size(); i++) {
            pf(qc, i);
            Slot& s = slot_of(qc[i].code);
            if (s.qn != 255) s.qn++;
            s.qpos = (int32_t)qc[i].pos;
        }
        for (size_t i = 0; i < tc.size(); i++) {
            pf(tc, i);
            Slot& s = slot_of(tc[i].code);
            if (s.qn == 0) continue;   // only track codes seen in q
            if (s.tn != 255) s.tn++;
            s.tpos = (int32_t)tc[i].pos;
        }
        // emit by walking qc in POSITION order: each unique code has
        // exactly one qpos, so the stream comes out already lexsorted
        // by (qpos, tpos) — the global pair sort vanishes
        for (size_t i = 0; i < qc.size(); i++) {
            pf(qc, i);
            Slot& s = slot_of(qc[i].code);
            if (s.qn == 1 && s.tn == 1)
                pairs.push_back({(uint64_t)s.qpos, s.tpos});
        }
        presorted = true;
    } else {
        // rare-kmer hash join: count per-code occurrences and chain up
        // to max_occ positions per side; when the total cartesian pair
        // count stays <= max_pairs the Python spec's mid-stream cutoff
        // can never trigger, so any emission order that ends up
        // lexsorted is identical — walking qc in position order (each
        // code's tpos chain ascending) gives that directly and the
        // global pair sort vanishes.
        struct RSlot {
            uint64_t code;
            uint32_t epoch;
            uint8_t qn, tn;       // saturate at 255 (max_occ <= 64)
            int32_t qhead, thead;
        };
        static thread_local std::vector<RSlot> rtable;
        static thread_local uint32_t repoch = 0;
        size_t want = 1;
        while (want < 2 * (qc.size() + tc.size() + 1)) want <<= 1;
        if (rtable.size() < want || repoch == 0xFFFFFFFFu) {
            rtable.assign(std::max(want, rtable.size()), RSlot{});
            repoch = 0;
        }
        repoch++;
        const size_t rmsk = rtable.size() - 1;
        auto rslot_of = [&](uint64_t code) -> RSlot& {
            size_t h = (size_t)(code * MUL) & rmsk;
            for (;;) {
                RSlot& s = rtable[h];
                if (s.epoch != repoch) {
                    s.epoch = repoch;
                    s.code = code;
                    s.qn = s.tn = 0;
                    s.qhead = s.thead = -1;
                    return s;
                }
                if (s.code == code) return s;
                h = (h + 1) & rmsk;
            }
        };
        auto rpf = [&](const std::vector<CP>& v, size_t i) {
            if (i + PF < v.size())
                __builtin_prefetch(
                    &rtable[(size_t)(v[i + PF].code * MUL) & rmsk]);
        };
        // position chains: (pos, next-index); heads live in the slots
        std::vector<std::pair<int64_t, int32_t>> qch, tch;
        qch.reserve(qc.size());
        std::vector<RSlot*> touched;
        for (size_t i = 0; i < qc.size(); i++) {
            rpf(qc, i);
            const CP& e = qc[i];
            RSlot& s = rslot_of(e.code);
            if (s.qn != 255) s.qn++;
            if (s.qn <= max_occ) {
                qch.push_back({e.pos, s.qhead});
                s.qhead = (int32_t)qch.size() - 1;
            }
        }
        for (size_t i = 0; i < tc.size(); i++) {
            rpf(tc, i);
            const CP& e = tc[i];
            RSlot& s = rslot_of(e.code);
            if (s.qn == 0) continue;
            if (s.tn != 255) s.tn++;
            if (s.tn == 1) touched.push_back(&s);
            if (s.tn <= max_occ) {
                tch.push_back({e.pos, s.thead});
                s.thead = (int32_t)tch.size() - 1;
            }
        }
        int64_t total = 0;
        for (RSlot* s : touched)
            if (s->qn <= max_occ && s->tn <= max_occ)
                total += (int64_t)s->qn * s->tn;
        if (total <= max_pairs && max_occ <= 64) {  // trev bound
            // under the cap: walk qc in position order (qpos strictly
            // ascending across entries) and list each code's tpos
            // chain ascending — already lexsorted, sort skipped
            pairs.reserve((size_t)total);
            int64_t trev[64];
            for (size_t i = 0; i < qc.size(); i++) {
                rpf(qc, i);
                RSlot& s = rslot_of(qc[i].code);
                if (s.qn == 0 || s.qn > max_occ || s.tn == 0 ||
                    s.tn > max_occ)
                    continue;
                int nrev = 0;
                for (int32_t ti = s.thead; ti >= 0; ti = tch[ti].second)
                    trev[nrev++] = tch[ti].first;  // descending tpos
                for (int a2 = nrev - 1; a2 >= 0; a2--)
                    pairs.push_back({(uint64_t)qc[i].pos, trev[a2]});
            }
            presorted = true;
        } else {
            // over-cap: the spec's mid-stream cutoff order matters —
            // code-sorted path
            auto by_code = [](const CP& a, const CP& b) {
                return a.code != b.code ? a.code < b.code : a.pos < b.pos;
            };
            std::sort(qc.begin(), qc.end(), by_code);
            std::sort(tc.begin(), tc.end(), by_code);
            // pair up codes with count <= max_occ on both sides
            size_t i = 0, j = 0;
            bool cut = false;
            while (i < qc.size() && j < tc.size()) {
                uint64_t c = qc[i].code;
                if (c < tc[j].code) { i++; continue; }
                if (c > tc[j].code) { j++; continue; }
                size_t i1 = i, j1 = j;
                while (i1 < qc.size() && qc[i1].code == c) i1++;
                while (j1 < tc.size() && tc[j1].code == c) j1++;
                if ((int64_t)(i1 - i) <= max_occ &&
                    (int64_t)(j1 - j) <= max_occ) {
                    for (size_t a = i; a < i1 && !cut; a++) {
                        for (size_t b = j; b < j1; b++)
                            pairs.push_back(
                                {(uint64_t)qc[a].pos, tc[b].pos});
                        // the Python spec caps the cartesian pairing
                        // only on the rare-kmer (max_occ > 1) path,
                        // checking AFTER appending each query k-mer's
                        // hits (unique matches are never capped there)
                        if (max_occ > 1 &&
                            (int64_t)pairs.size() > max_pairs)
                            cut = true;
                    }
                    if (cut) break;
                }
                i = i1; j = j1;
            }
        }
    }
    g_anchor_prof[1] += anchors_now() - tp0;
    if (pairs.empty()) return;
    tp0 = anchors_now();
    // lexsort by (qpos, tpos) — skipped when the join emitted the
    // stream already lexsorted (the common paths above)
    if (!presorted)
        std::sort(pairs.begin(), pairs.end(),
                  [](const CP& a, const CP& b) {
                      return a.code != b.code ? a.code < b.code
                                              : a.pos < b.pos;
                  });
    int64_t n = (int64_t)pairs.size();
    std::vector<int64_t> tpos_v(n), kept(n);
    for (int64_t a = 0; a < n; a++) tpos_v[a] = pairs[a].pos;
    int64_t m = lis_chain(tpos_v.data(), n, kept.data());
    g_anchor_prof[2] += anchors_now() - tp0;
    // strict-monotone qpos filter
    int64_t last_q = -1;
    for (int64_t a = 0; a < m; a++) {
        int64_t qp = (int64_t)pairs[kept[a]].code;
        int64_t tp = pairs[kept[a]].pos;
        if (a > 0 && qp <= last_q) continue;
        out_q.push_back(qp);
        out_t.push_back(tp);
        last_q = qp;
    }
}

// pick_cuts (segmented.py::pick_cuts spec): greedy cut selection with
// searchsorted jumps; appends cut midpoints to qc/tc.
static void pick_cuts_impl(const std::vector<int64_t>& qpos,
                           const std::vector<int64_t>& tpos,
                           int k, int64_t seg_target,
                           std::vector<int64_t>& qc,
                           std::vector<int64_t>& tc) {
    const int64_t mid = k / 2;
    const int64_t n = (int64_t)qpos.size();
    int64_t last_q = -((int64_t)1 << 30), last_t = -((int64_t)1 << 30);
    int64_t i = 0;
    while (i < n) {
        int64_t cq = qpos[i] + mid, ct = tpos[i] + mid;
        if (cq - last_q < seg_target || ct - last_t < seg_target) {
            auto j1 = std::lower_bound(qpos.begin(), qpos.end(),
                                       last_q + seg_target - mid)
                      - qpos.begin();
            auto j2 = std::lower_bound(tpos.begin(), tpos.end(),
                                       last_t + seg_target - mid)
                      - tpos.begin();
            i = std::max<int64_t>(std::max<int64_t>(j1, j2), i + 1);
            continue;
        }
        qc.push_back(cq);
        tc.push_back(ct);
        last_q = cq;
        last_t = ct;
        i++;
    }
}

extern "C" {

// ctypes wrapper for find_anchors_impl. Returns the number of anchors
// written to out_q/out_t (cap slots each), or -1 on overflow (caller
// falls back to the Python path).
int64_t find_anchors_native(const uint8_t* q, int64_t qlen,
                            const uint8_t* t, int64_t tlen,
                            int k, int max_occ, int64_t max_pairs,
                            int64_t* out_q, int64_t* out_t, int64_t cap) {
    std::vector<int64_t> aq, at;
    find_anchors_impl(q, qlen, t, tlen, k, max_occ, max_pairs, aq, at);
    if ((int64_t)aq.size() > cap) return -1;
    std::copy(aq.begin(), aq.end(), out_q);
    std::copy(at.begin(), at.end(), out_t);
    return (int64_t)aq.size();
}

// plan_block: the FULL per-block segmentation plan in one call
// (segmented.py::_plan_bounds is the Python spec, bit-identical):
// anchor-k ladder (21-unique -> rare 13/occ4 -> rare 11/occ8),
// greedy cut picking, then one recursive re-anchoring pass for
// inter-anchor spans that don't fit the kernel envelope
// (_solver_accepts: dq < lseg && dt < lseg && |dq-dt| < K/2-1).
// Writes the bounds arrays (including the 0 and len endpoints) to
// out_q/out_t. Returns the bounds count, 0 when the block is
// unplannable (fewer than 2 cuts at every rung), or -1 on overflow.
int64_t plan_block(const uint8_t* q, int64_t qlen,
                   const uint8_t* t, int64_t tlen,
                   int64_t seg_target, int64_t lseg, int64_t K,
                   int64_t* out_q, int64_t* out_t, int64_t cap) {
    std::vector<int64_t> aq, at, qc, tc;
    find_anchors_impl(q, qlen, t, tlen, 21, 1, 200000, aq, at);
    pick_cuts_impl(aq, at, 21, seg_target, qc, tc);
    if ((int64_t)qc.size() < std::max<int64_t>(2, qlen / (4 * lseg))) {
        aq.clear(); at.clear(); qc.clear(); tc.clear();
        find_anchors_impl(q, qlen, t, tlen, 13, 4, 200000, aq, at);
        pick_cuts_impl(aq, at, 13, seg_target, qc, tc);
    }
    if ((int64_t)qc.size() < std::max<int64_t>(2, qlen / (8 * lseg))) {
        aq.clear(); at.clear(); qc.clear(); tc.clear();
        find_anchors_impl(q, qlen, t, tlen, 11, 8, 200000, aq, at);
        pick_cuts_impl(aq, at, 11, seg_target, qc, tc);
    }
    if (qc.size() < 2) return 0;
    std::vector<int64_t> bq, bt;
    bq.reserve(qc.size() + 2); bt.reserve(tc.size() + 2);
    bq.push_back(0); bt.push_back(0);
    bq.insert(bq.end(), qc.begin(), qc.end());
    bt.insert(bt.end(), tc.begin(), tc.end());
    bq.push_back(qlen); bt.push_back(tlen);
    // refine pass: re-anchor oversize inter-anchor spans
    std::vector<int64_t> rq, rt;
    rq.push_back(0); rt.push_back(0);
    const int64_t n = (int64_t)bq.size();
    for (int64_t pi = 0; pi + 1 < n; pi++) {
        const int64_t sq0 = bq[pi], sq1 = bq[pi + 1];
        const int64_t st0 = bt[pi], st1 = bt[pi + 1];
        const int64_t dq = sq1 - sq0, dt = st1 - st0;
        const bool fits = (dq < lseg && dt < lseg &&
                           std::llabs(dq - dt) < K / 2 - 1);
        const bool big = !(fits || dq == 0 || dt == 0);
        if (big && dq >= 64 && dt >= 64) {
            aq.clear(); at.clear(); qc.clear(); tc.clear();
            find_anchors_impl(q + sq0, dq, t + st0, dt, 13, 4, 200000,
                              aq, at);
            pick_cuts_impl(aq, at, 13, 128, qc, tc);
            if (qc.empty()) {
                aq.clear(); at.clear();
                find_anchors_impl(q + sq0, dq, t + st0, dt, 11, 8,
                                  200000, aq, at);
                pick_cuts_impl(aq, at, 11, 128, qc, tc);
            }
            for (size_t a = 0; a < qc.size(); a++) {
                rq.push_back(qc[a] + sq0);
                rt.push_back(tc[a] + st0);
            }
        }
        rq.push_back(sq1);
        rt.push_back(st1);
    }
    if ((int64_t)rq.size() > cap) return -1;
    std::copy(rq.begin(), rq.end(), out_q);
    std::copy(rt.begin(), rt.end(), out_t);
    return (int64_t)rq.size();
}

// Best placement offset of `s` inside `l` by rare-k-mer diagonal
// voting — bit-identical port of align/segmented.py:_place_short
// (coarse 32-wide buckets, first-max mode, numpy-median refinement).
// Returns the offset, or -1 when there is no homology signal.
int64_t place_short(const uint8_t* s, int64_t slen, const uint8_t* l,
                    int64_t llen, int k, int max_occ) {
    static const auto B2_tab = []() {
        std::array<int8_t, 256> a;
        a.fill(-1);
        a['A'] = 0; a['C'] = 1; a['G'] = 2; a['T'] = 3;
        return a;
    }();
    const int8_t* B2 = B2_tab.data();

    struct CP {
        uint64_t code;
        int64_t pos;
    };
    auto rare_of = [&](const uint8_t* seq, int64_t len,
                       std::vector<CP>& out_cp) {
        int64_t n = len - k + 1;
        if (n <= 0) return;
        std::vector<CP> cp;
        cp.reserve(n);
        uint64_t code = 0;
        int64_t run = 0;   // consecutive valid bases ending here
        for (int64_t i = 0; i < len; i++) {
            int8_t b = B2[seq[i]];
            if (b < 0) {
                run = 0;
                code = 0;
                continue;
            }
            code = (code << 2) | (uint64_t)b;
            if (k < 32) code &= (1ull << (2 * k)) - 1;
            run++;
            if (run >= k) cp.push_back({code, i - k + 1});
        }
        std::sort(cp.begin(), cp.end(), [](const CP& a, const CP& b) {
            return a.code < b.code || (a.code == b.code && a.pos < b.pos);
        });
        // keep codes occurring <= max_occ times
        int64_t m = (int64_t)cp.size();
        for (int64_t i = 0; i < m;) {
            int64_t j = i;
            while (j < m && cp[j].code == cp[i].code) j++;
            if (j - i <= max_occ)
                for (int64_t a2 = i; a2 < j; a2++) out_cp.push_back(cp[a2]);
            i = j;
        }
    };
    std::vector<CP> cs, cl;
    rare_of(s, slen, cs);
    rare_of(l, llen, cl);
    if (cs.empty() || cl.empty()) return -1;

    std::vector<int64_t> diags;
    size_t i = 0, j = 0;
    while (i < cs.size() && j < cl.size() && diags.size() < 100000) {
        if (cs[i].code < cl[j].code)
            i++;
        else if (cs[i].code > cl[j].code)
            j++;
        else {
            uint64_t c = cs[i].code;
            size_t i2 = i, j2 = j;
            while (i2 < cs.size() && cs[i2].code == c) i2++;
            while (j2 < cl.size() && cl[j2].code == c) j2++;
            for (size_t a2 = i; a2 < i2; a2++)
                for (size_t b2 = j; b2 < j2; b2++)
                    diags.push_back(cl[b2].pos - cs[a2].pos);
            i = i2;
            j = j2;
        }
    }
    if (diags.size() < 5) return -1;
    int64_t lim = llen - slen;
    std::vector<int64_t> d;
    d.reserve(diags.size());
    for (int64_t v : diags)
        if (v >= -32 && v <= lim + 32) d.push_back(v);
    if (d.size() < 5) return -1;
    auto bucket_of = [](int64_t v) -> int64_t {   // floor division by 32
        return v >= 0 ? v / 32 : -((-v + 31) / 32);
    };
    // mode bucket (smallest bucket wins ties, like np.unique+argmax)
    std::vector<int64_t> bs(d.size());
    for (size_t a2 = 0; a2 < d.size(); a2++) bs[a2] = bucket_of(d[a2]);
    std::vector<int64_t> sorted_b = bs;
    std::sort(sorted_b.begin(), sorted_b.end());
    int64_t best_b = sorted_b[0], best_n = 0;
    for (size_t a2 = 0; a2 < sorted_b.size();) {
        size_t b2 = a2;
        while (b2 < sorted_b.size() && sorted_b[b2] == sorted_b[a2]) b2++;
        if ((int64_t)(b2 - a2) > best_n) {
            best_n = (int64_t)(b2 - a2);
            best_b = sorted_b[a2];
        }
        a2 = b2;
    }
    std::vector<int64_t> inb;
    for (size_t a2 = 0; a2 < d.size(); a2++)
        if (bs[a2] == best_b) inb.push_back(d[a2]);
    std::sort(inb.begin(), inb.end());
    size_t m = inb.size();
    double med = (m % 2) ? (double)inb[m / 2]
                         : ((double)inb[m / 2 - 1] + (double)inb[m / 2]) / 2.0;
    if (med < 0) med = 0;
    if (med > (double)lim) med = (double)lim;
    return (int64_t)med;
}

}  // extern "C"
