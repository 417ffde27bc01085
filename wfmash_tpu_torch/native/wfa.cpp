// Native host WFA — gap-affine two-piece wavefront alignment.
//
// Bit-identical C++ port of wfmash_tpu/align/wfa_vec.py (itself the
// vectorized twin of the executable spec wfa_np.py, both DP-oracle
// verified): same recurrences, same live-range growth, same tie-break
// priority (X > I1 > I2 > D1 > D2 at M cells; gap-open before
// gap-extend inside gap states), same ends-free seeding/acceptance
// (smallest accepting diagonal wins), same RLE emission. The Python
// implementations remain the spec and the fallback; equality is
// enforced by tests (tests/test_native.py).
//
// This is the host leaf solver of the alignment engine (reference
// analogue: WFA2-lib's affine2p wavefront aligner, the reference's
// default via wflign.cpp:136-148). The full wavefront history is
// O(score^2) lanes, so the implementation is memory-first:
//
//  * the lane type is TEMPLATED — int16 when both sequences are
//    < 32 kb (offsets fit; halves memory traffic and doubles SIMD
//    width), int32 otherwise. Offsets never exceed m, so the two
//    instantiations compute identical values;
//  * a persistent per-thread bump arena reuses mapped chunks across
//    calls (fresh mallocs re-faulted every page on every alignment —
//    measured ~40% of the LPA align wall);
//  * each level is built by fused single-pass segmented combines (one
//    write per lane, no NEG pre-fill), and the end scan only covers
//    the accepting diagonal window [m-n-qe, m-n+te].

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <unordered_map>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512CD__)
#include <immintrin.h>
#define WFA_SIMD_EXTEND 1
#endif

namespace {

// Env-gated (WFMASH_TPU_WFA_PROF=1) inner-loop accumulators for the
// exact engine: 0 combine_s, 1 mpass_s (max/bounds/extend), 2 find_s,
// 3 n_levels, 4 n_lanes. Read+reset via wfa_prof_times(). The checks
// cost one predictable branch per level when disabled.
thread_local double g_wprof[6] = {0};
inline bool wprof_on() {
    static thread_local int on = -1;
    if (on < 0) {
        const char* e = getenv("WFMASH_TPU_WFA_PROF");
        on = (e && e[0] == '1') ? 1 : 0;
    }
    return on == 1;
}
inline double wnow() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

template <typename T>
struct NegOf;
template <>
struct NegOf<int32_t> {
    static constexpr int32_t v = -(1 << 28);
};
template <>
struct NegOf<int16_t> {
    // INT16_MIN: real offsets are always >= 0, so the sentinel only
    // ever needs to order below them (never incremented — all +inc
    // sites are guarded by v > NEG)
    static constexpr int16_t v = (int16_t)-32768;
};

template <typename T>
struct Level {
    int32_t lo = 0;
    int32_t n = 0;  // lanes; 0 => level absent entirely
    T *M = nullptr, *I1 = nullptr, *I2 = nullptr, *D1 = nullptr,
      *D2 = nullptr;
};

// Persistent per-thread bump arena. A full-history WFA touches
// O(score^2) bytes; fresh malloc each call means re-faulting every page
// on every alignment. Chunks stay mapped across calls and are
// bump-reused; reset() trims residency back to MAX_KEEP so one giant
// divergent record doesn't pin gigabytes.
struct Arena {
    static constexpr size_t CHUNK = 16u << 20;       // 16 MiB
    static constexpr size_t MAX_KEEP = 256u << 20;   // resident cap
    std::vector<std::pair<char *, size_t>> chunks;   // (ptr, size)
    size_t cur = 0;   // active chunk index
    size_t off = 0;   // bump offset in active chunk
    size_t used = 0;  // bytes handed out since reset()
    ~Arena() {
        for (auto &c : chunks) free(c.first);
    }
    void reset() {
        cur = 0;
        off = 0;
        used = 0;
        size_t tot = 0, keep = 0;
        for (; keep < chunks.size() && tot < MAX_KEEP; keep++)
            tot += chunks[keep].second;
        for (size_t i = keep; i < chunks.size(); i++) free(chunks[i].first);
        chunks.resize(keep);
    }
    template <typename T>
    T *alloc_raw(int32_t n) {
        size_t need = (sizeof(T) * (size_t)n + 7u) & ~(size_t)7u;
        used += need;
        while (cur < chunks.size() && chunks[cur].second - off < need) {
            cur++;
            off = 0;
        }
        if (cur == chunks.size()) {
            size_t sz = need > CHUNK ? need : CHUNK;
            chunks.emplace_back((char *)malloc(sz), sz);
            off = 0;
        }
        T *p = (T *)(chunks[cur].first + off);
        off += need;
        return p;
    }
    template <typename T>
    T *alloc_fill(int32_t n, T fill) {
        T *p = alloc_raw<T>(n);
        for (int32_t i = 0; i < n; i++) p[i] = fill;
        return p;
    }
};

thread_local Arena g_arena;

template <typename T>
struct Getter {
    const std::vector<Level<T>> &hist;
    int64_t M(int64_t s, int64_t k) const {
        return getv(s, k, offsetof(Level<T>, M));
    }
    int64_t I1(int64_t s, int64_t k) const {
        return getv(s, k, offsetof(Level<T>, I1));
    }
    int64_t I2(int64_t s, int64_t k) const {
        return getv(s, k, offsetof(Level<T>, I2));
    }
    int64_t D1(int64_t s, int64_t k) const {
        return getv(s, k, offsetof(Level<T>, D1));
    }
    int64_t D2(int64_t s, int64_t k) const {
        return getv(s, k, offsetof(Level<T>, D2));
    }
    int64_t getv(int64_t s, int64_t k, size_t off) const {
        constexpr T NEG = NegOf<T>::v;
        if (s < 0 || s >= (int64_t)hist.size()) return NEG;
        const Level<T> &L = hist[(size_t)s];
        if (L.n == 0) return NEG;
        const T *a = *(T *const *)((const char *)&L + off);
        if (!a) return NEG;
        int64_t idx = k - L.lo;
        if (idx < 0 || idx >= L.n) return NEG;
        return a[idx];
    }
};

struct Emitter {
    // RLE built backwards: ops_rev[i] = (count, op); merged on append
    std::vector<int64_t> counts;
    std::vector<char> ops;
    void emit(int64_t nn, char op) {
        if (nn <= 0) return;
        if (!ops.empty() && ops.back() == op)
            counts.back() += nn;
        else {
            ops.push_back(op);
            counts.push_back(nn);
        }
    }
};

template <typename T>
int64_t wfa_align_impl(const uint8_t *q, int64_t m, const uint8_t *t,
                       int64_t n, int32_t x, int32_t o1, int32_t e1,
                       int32_t o2, int32_t e2, int64_t tb, int64_t te,
                       int64_t qb, int64_t qe, int64_t max_score,
                       int64_t *out, int64_t cap, int64_t *out_score,
                       int64_t mem_cap, int64_t prune_bound = -1) {
    constexpr T NEG = NegOf<T>::v;
    if (m == 0 && n == 0) {
        *out_score = 0;
        return 0;
    }
    Arena &arena = g_arena;
    arena.reset();
    std::vector<Level<T>> hist;

    auto extend = [&](int64_t h, int64_t v) -> int64_t {
        // LCP from (h query, v target). 8-byte XOR/ctz rounds FIRST
        // (at divergent score levels most lanes have LCP < 8, and the
        // 64-byte memcmp reads 2x64B just to fail), escalating to
        // 64-byte memcmp strides (glibc AVX) once 32 clean bytes prove
        // the run is long.
        int64_t lim = (m - h < n - v) ? m - h : n - v;
        int64_t r = 0;
        while (r + 8 <= lim) {
            uint64_t a, b;
            memcpy(&a, q + h + r, 8);
            memcpy(&b, t + v + r, 8);
            if (a != b) {
#if defined(__GNUC__)
                return r + (__builtin_ctzll(a ^ b) >> 3);
#else
                while (q[h + r] == t[v + r]) r++;
                return r;
#endif
            }
            r += 8;
            if (r == 32) {
                while (r + 64 <= lim &&
                       memcmp(q + h + r, t + v + r, 64) == 0)
                    r += 64;
            }
        }
        while (r < lim && q[h + r] == t[v + r]) r++;
        return r;
    };

    // ---- score-0 seeds --------------------------------------------------
    int64_t lo0 = -(tb < n ? tb : n);
    int64_t hi0 = (qb < m ? qb : m);
    {
        Level<T> L;
        L.lo = (int32_t)lo0;
        L.n = (int32_t)(hi0 - lo0 + 1);
        L.M = arena.alloc_fill<T>(L.n, NEG);
        for (int64_t k = lo0; k <= hi0; k++) {
            int64_t h = k > 0 ? k : 0;
            int64_t v = h - k;
            L.M[k - lo0] = (T)(h + extend(h, v));
        }
        hist.push_back(L);
    }

    auto find_end = [&](const Level<T> &L, int64_t *ek,
                        int64_t *eh) -> bool {
        if (L.n == 0 || !L.M) return false;
        // An accepting cell needs h==m (k in [m-n, m-n+te]) or v==n
        // (k in [m-n-qe, m-n]) — scan only that diagonal window, in
        // ascending k like the full scan (same smallest-k tie-break).
        int64_t klo = m - n - qe, khi = m - n + te;
        if (klo < L.lo) klo = L.lo;
        if (khi > L.lo + L.n - 1) khi = L.lo + L.n - 1;
        for (int64_t k = klo; k <= khi; k++) {
            int64_t h = L.M[k - L.lo];
            if (h <= NEG) continue;
            int64_t v = h - k;
            if ((h == m && v >= 0 && v <= n && n - v <= te) ||
                (v == n && h >= 0 && h <= m && m - h <= qe)) {
                *ek = k;
                *eh = h;
                return true;
            }
        }
        return false;
    };

    int64_t end_k = 0, end_h = 0;
    bool done = find_end(hist[0], &end_k, &end_h);
    int64_t s = 0;
    int64_t mx1 = x, mx2 = e1 + o1, mx3 = e2 + o2;
    int64_t mxp = mx1 > mx2 ? mx1 : mx2;
    if (mx3 > mxp) mxp = mx3;
    int64_t score_cap = (m + n) * mxp + o1 + o2 + 10;

    while (!done) {
        s++;
        if (max_score >= 0 && s > max_score) return -1;
        if (prune_bound >= 0 && s > prune_bound) return -5;  // bad bound
        if (s > score_cap) return -3;
        if (mem_cap > 0 && (int64_t)arena.used > mem_cap) return -4;

        // live range from the seven sources
        int64_t lo = INT64_MAX, hi = INT64_MIN;
        struct Src {
            int64_t s;
            size_t off;
        } srcs[7] = {
            {s - x, offsetof(Level<T>, M)},
            {s - o1 - e1, offsetof(Level<T>, M)},
            {s - o2 - e2, offsetof(Level<T>, M)},
            {s - e1, offsetof(Level<T>, I1)},
            {s - e2, offsetof(Level<T>, I2)},
            {s - e1, offsetof(Level<T>, D1)},
            {s - e2, offsetof(Level<T>, D2)},
        };
        for (auto &sc : srcs) {
            if (sc.s < 0 || sc.s >= (int64_t)hist.size()) continue;
            const Level<T> &L = hist[(size_t)sc.s];
            if (L.n == 0) continue;
            const T *a = *(T *const *)((const char *)&L + sc.off);
            if (!a) continue;
            if (L.lo < lo) lo = L.lo;
            if (L.lo + L.n - 1 > hi) hi = L.lo + L.n - 1;
        }
        if (lo == INT64_MAX) {
            hist.push_back(Level<T>{});  // absent level
            continue;
        }
        lo -= 1;
        hi += 1;
        // Known-bound pruning (end-to-end only): a path on diagonal k
        // at score s still has to make a net diagonal change of
        // d = |k_end - k| to finish. From a GAP-state cell the run can
        // continue without re-opening, so the sound shared bound is
        // the weak LB(d) = d*min(e1,e2); from an M-state cell any
        // completion must open a fresh gap, so M lanes tighten to the
        // strong LB(d) = min(o1+e1*d, o2+e2*d). Lanes violating their
        // bound are provably off every <=U path, so clamping them
        // leaves the offsets of all reachable-within-U cells (and the
        // backtrace's winning candidates — see the proof in
        // host_align_blocks' caller notes) bit-identical.
        int64_t m_klo = INT64_MIN / 2, m_khi = INT64_MAX / 2;
        if (prune_bound >= 0) {
            const int64_t rem = prune_bound - s;
            const int64_t emin = e1 < e2 ? e1 : e2;
            const int64_t d_weak = emin > 0 ? rem / emin : rem;
            int64_t d_strong = 0;
            if (rem > o1 && e1 > 0) d_strong = (rem - o1) / e1;
            if (rem > o2 && e2 > 0) {
                const int64_t d2m = (rem - o2) / e2;
                if (d2m > d_strong) d_strong = d2m;
            }
            // acceptance window [m-n-qe, m-n+te] (a point when the
            // ends are pinned); net change needed = distance to it
            const int64_t acc_lo = m - n - qe, acc_hi = m - n + te;
            if (acc_lo - d_weak > lo) lo = acc_lo - d_weak;
            if (acc_hi + d_weak < hi) hi = acc_hi + d_weak;
            if (lo > hi) {
                hist.push_back(Level<T>{});
                continue;
            }
            m_klo = acc_lo - d_strong;
            m_khi = acc_hi + d_strong;
        }
        int64_t nk = hi - lo + 1;

        Level<T> L;
        L.lo = (int32_t)lo;
        L.n = (int32_t)nk;
        // presence mirrors wfa_vec's None-propagation: a state's array
        // exists iff any of its sources exist
        auto level_has = [&](int64_t ss, size_t off) -> bool {
            if (ss < 0 || ss >= (int64_t)hist.size()) return false;
            const Level<T> &P = hist[(size_t)ss];
            if (P.n == 0) return false;
            return *(T *const *)((const char *)&P + off) != nullptr;
        };
        bool has_mx = level_has(s - x, offsetof(Level<T>, M));
        bool has_mo1 = level_has(s - o1 - e1, offsetof(Level<T>, M));
        bool has_mo2 = level_has(s - o2 - e2, offsetof(Level<T>, M));
        bool has_i1e = level_has(s - e1, offsetof(Level<T>, I1));
        bool has_i2e = level_has(s - e2, offsetof(Level<T>, I2));
        bool has_d1e = level_has(s - e1, offsetof(Level<T>, D1));
        bool has_d2e = level_has(s - e2, offsetof(Level<T>, D2));
        bool has_i1 = has_mo1 || has_i1e;
        bool has_i2 = has_mo2 || has_i2e;
        bool has_d1 = has_mo1 || has_d1e;
        bool has_d2 = has_mo2 || has_d2e;
        bool has_m = has_mx || has_i1 || has_i2 || has_d1 || has_d2;
        if (has_i1) L.I1 = arena.alloc_raw<T>(L.n);
        if (has_i2) L.I2 = arena.alloc_raw<T>(L.n);
        if (has_d1) L.D1 = arena.alloc_raw<T>(L.n);
        if (has_d2) L.D2 = arena.alloc_raw<T>(L.n);
        if (has_m) L.M = arena.alloc_raw<T>(L.n);

        // Fused single-pass combines. Same max recurrences as a
        // fill/max/add multi-pass (fill NEG + copy + max + guarded add
        // == max(a,b) > NEG ? +inc : NEG); one write per lane, no NEG
        // pre-fill.
        struct View {
            const T *p = nullptr;
            int64_t lo = 0, n = 0;
        };
        auto view = [&](int64_t ss, size_t off) -> View {
            View v;
            if (ss < 0 || ss >= (int64_t)hist.size()) return v;
            const Level<T> &P = hist[(size_t)ss];
            if (P.n == 0) return v;
            const T *a = *(T *const *)((const char *)&P + off);
            if (!a) return v;
            v.p = a;
            v.lo = P.lo;
            v.n = P.n;
            return v;
        };
        // dst[i] = max(a[k+shift], b[k+shift]) + inc (NEG when both
        // absent/NEG); both sources share the shift, so the [0,nk)
        // range splits into <=5 contiguous segments by which sources
        // cover them — every inner loop is a contiguous vector op.
        auto combine2 = [&](T *dst, View va, View vb, int64_t shift,
                            T inc) {
            int64_t a0 = nk, a1 = -1, b0 = nk, b1 = -1;
            if (va.p) {
                a0 = va.lo - shift - lo;
                a1 = va.lo + va.n - 1 - shift - lo;
                if (a0 < 0) a0 = 0;
                if (a1 > nk - 1) a1 = nk - 1;
            }
            if (vb.p) {
                b0 = vb.lo - shift - lo;
                b1 = vb.lo + vb.n - 1 - shift - lo;
                if (b0 < 0) b0 = 0;
                if (b1 > nk - 1) b1 = nk - 1;
            }
            int64_t cuts[6] = {0, a0, a1 + 1, b0, b1 + 1, nk};
            for (int c = 0; c < 5; c++)       // tiny insertion sort
                for (int d = c + 1; d < 6; d++)
                    if (cuts[d] < cuts[c]) {
                        int64_t tmp = cuts[c];
                        cuts[c] = cuts[d];
                        cuts[d] = tmp;
                    }
            for (int c = 0; c < 5; c++) {
                int64_t s0 = cuts[c] < 0 ? 0 : cuts[c];
                int64_t s1 = cuts[c + 1] > nk ? nk : cuts[c + 1];
                if (s0 >= s1) continue;
                bool ina = s0 >= a0 && s0 <= a1;
                bool inb = s0 >= b0 && s0 <= b1;
                if (ina && inb) {
                    const T *pa = va.p + (lo + s0 + shift - va.lo);
                    const T *pb = vb.p + (lo + s0 + shift - vb.lo);
                    for (int64_t i = s0; i < s1; i++) {
                        T v = pa[i - s0] > pb[i - s0] ? pa[i - s0]
                                                      : pb[i - s0];
                        dst[i] = v > NEG ? (T)(v + inc) : NEG;
                    }
                } else if (ina) {
                    const T *pa = va.p + (lo + s0 + shift - va.lo);
                    for (int64_t i = s0; i < s1; i++) {
                        T v = pa[i - s0];
                        dst[i] = v > NEG ? (T)(v + inc) : NEG;
                    }
                } else if (inb) {
                    const T *pb = vb.p + (lo + s0 + shift - vb.lo);
                    for (int64_t i = s0; i < s1; i++) {
                        T v = pb[i - s0];
                        dst[i] = v > NEG ? (T)(v + inc) : NEG;
                    }
                } else {
                    for (int64_t i = s0; i < s1; i++) dst[i] = NEG;
                }
            }
        };
        View vMx = view(s - x, offsetof(Level<T>, M));
        View vMo1 = view(s - o1 - e1, offsetof(Level<T>, M));
        View vMo2 = view(s - o2 - e2, offsetof(Level<T>, M));
        View vI1 = view(s - e1, offsetof(Level<T>, I1));
        View vI2 = view(s - e2, offsetof(Level<T>, I2));
        View vD1 = view(s - e1, offsetof(Level<T>, D1));
        View vD2 = view(s - e2, offsetof(Level<T>, D2));
        const bool prof = wprof_on();
        double tprof = prof ? wnow() : 0.0;
        if (has_i1) combine2(L.I1, vMo1, vI1, -1, (T)1);
        if (has_i2) combine2(L.I2, vMo2, vI2, -1, (T)1);
        if (has_d1) combine2(L.D1, vMo1, vD1, +1, (T)0);
        if (has_d2) combine2(L.D2, vMo2, vD2, +1, (T)0);
        if (prof) {
            double t1 = wnow();
            g_wprof[0] += t1 - tprof;
            tprof = t1;
            g_wprof[3] += 1;
            g_wprof[4] += (double)nk;
        }
        if (has_m) {
            // best = max(Mx[k]+1, I1, I2, D1, D2) into L.M (in place),
            // branch-free vector passes; then one scalar extend pass.
            T *best = L.M;
            const T *pi1 = L.I1, *pi2 = L.I2, *pd1 = L.D1, *pd2 = L.D2;
            if (pi1 && pi2 && pd1 && pd2) {   // common steady state
                for (int64_t i = 0; i < nk; i++) {
                    T a = pi1[i] > pi2[i] ? pi1[i] : pi2[i];
                    T b = pd1[i] > pd2[i] ? pd1[i] : pd2[i];
                    best[i] = a > b ? a : b;
                }
            } else {
                for (int64_t i = 0; i < nk; i++) best[i] = NEG;
                for (const T *pg : {pi1, pi2, pd1, pd2}) {
                    if (!pg) continue;
                    for (int64_t i = 0; i < nk; i++)
                        if (pg[i] > best[i]) best[i] = pg[i];
                }
            }
            if (vMx.p) {
                int64_t x0 = vMx.lo - lo;
                int64_t x1 = vMx.lo + vMx.n - 1 - lo;
                if (x0 < 0) x0 = 0;
                if (x1 > nk - 1) x1 = nk - 1;
                const T *px = vMx.p + (lo + x0 - vMx.lo);
                for (int64_t i = x0; i <= x1; i++) {
                    T v = px[i - x0];
                    T w = v > NEG ? (T)(v + 1) : NEG;
                    if (w > best[i]) best[i] = w;
                }
            }
            // M lanes outside the strong prune window can never be on
            // a <=U path (completion from M re-opens a gap)
            int64_t i0 = 0, i1 = nk;
            if (m_klo > lo) i0 = m_klo - lo < nk ? m_klo - lo : nk;
            if (m_khi < lo + nk - 1)
                i1 = m_khi - lo + 1 > 0 ? m_khi - lo + 1 : 0;
            for (int64_t i = 0; i < i0; i++) L.M[i] = NEG;
            for (int64_t i = i1; i < nk; i++) L.M[i] = NEG;
            int64_t i = i0;
#if WFA_SIMD_EXTEND
            // Gather-vectorized first-dword extension: at divergent
            // score levels most lanes have LCP < 4, so one pair of
            // 16-lane dword gathers + xor/ctz resolves them without
            // any scalar memory access; only >=4-byte runs and
            // near-boundary lanes fall back to the scalar extend.
            // Values are bit-identical (same LCP arithmetic).
            if (m < INT32_MAX / 2 && n < INT32_MAX / 2) {
                const __m512i vneg32 = _mm512_set1_epi32((int32_t)NEG);
                const __m512i vzero = _mm512_setzero_si512();
                const __m512i vlane =
                    _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                      11, 12, 13, 14, 15);
                const __m512i vm4 =
                    _mm512_set1_epi32((int32_t)m - 4);
                const __m512i vn4 =
                    _mm512_set1_epi32((int32_t)n - 4);
                const __m512i vm = _mm512_set1_epi32((int32_t)m);
                const __m512i vn = _mm512_set1_epi32((int32_t)n);
                alignas(64) int32_t hbuf[16], vbuf[16], obuf[16];
                for (; i + 16 <= i1; i += 16) {
                    __m512i b32;
                    if (sizeof(T) == 2)
                        b32 = _mm512_cvtepi16_epi32(
                            _mm256_loadu_si256(
                                (const __m256i *)(best + i)));
                    else
                        b32 = _mm512_loadu_si512(
                            (const void *)(best + i));
                    __mmask16 alive =
                        _mm512_cmpgt_epi32_mask(b32, vneg32);
                    const __m512i k32 = _mm512_add_epi32(
                        _mm512_set1_epi32((int32_t)(lo + i)), vlane);
                    const __m512i h32 = b32;
                    const __m512i v32 = _mm512_sub_epi32(h32, k32);
                    alive = _mm512_mask_cmpge_epi32_mask(alive, h32,
                                                         vzero);
                    alive = _mm512_mask_cmple_epi32_mask(alive, h32,
                                                         vm);
                    alive = _mm512_mask_cmpge_epi32_mask(alive, v32,
                                                         vzero);
                    alive = _mm512_mask_cmple_epi32_mask(alive, v32,
                                                         vn);
                    // lanes whose 4-byte window stays in bounds
                    __mmask16 safe =
                        _mm512_mask_cmple_epi32_mask(alive, h32, vm4);
                    safe = _mm512_mask_cmple_epi32_mask(safe, v32,
                                                        vn4);
                    __m512i qd = _mm512_mask_i32gather_epi32(
                        vzero, safe, h32, q, 1);
                    __m512i td = _mm512_mask_i32gather_epi32(
                        vzero, safe, v32, t, 1);
                    const __m512i x32 = _mm512_xor_si512(qd, td);
                    const __mmask16 diff =
                        _mm512_mask_test_epi32_mask(safe, x32, x32);
                    // lcp = ctz(x)>>3 via blsi + lzcnt
                    const __m512i blsi = _mm512_and_si512(
                        x32, _mm512_sub_epi32(vzero, x32));
                    const __m512i tz = _mm512_sub_epi32(
                        _mm512_set1_epi32(31),
                        _mm512_lzcnt_epi32(blsi));
                    const __m512i lcp = _mm512_srli_epi32(tz, 3);
                    __m512i res = _mm512_mask_add_epi32(
                        vneg32, diff, h32, lcp);
                    _mm512_store_si512((void *)obuf, res);
                    // scalar continuation for the leftovers: alive
                    // but either window-unsafe or >=4 bytes matched
                    __mmask16 rest = alive & ~diff;
                    if (rest) {
                        _mm512_store_si512((void *)hbuf, h32);
                        _mm512_store_si512((void *)vbuf, v32);
                        unsigned r = rest;
                        while (r) {
                            const int j = __builtin_ctz(r);
                            r &= r - 1;
                            const int64_t h = hbuf[j], v = vbuf[j];
                            if (safe & (1u << j))   // >=4 matched
                                obuf[j] = (int32_t)(h + 4 +
                                                    extend(h + 4,
                                                           v + 4));
                            else
                                obuf[j] = (int32_t)(h + extend(h, v));
                        }
                    }
                    for (int j = 0; j < 16; j++)
                        L.M[i + j] = (alive & (1u << j))
                                         ? (T)obuf[j]
                                         : NEG;
                }
            }
#endif
            for (; i < i1; i++) {
                T b = best[i];
                if (b <= NEG) {
                    L.M[i] = NEG;
                    continue;
                }
                int64_t k = lo + i;
                int64_t h = b;
                int64_t v = h - k;
                if (h < 0 || h > m || v < 0 || v > n) {
                    L.M[i] = NEG;
                    continue;
                }
                L.M[i] = (T)(h + extend(h, v));
            }
        }
        if (prof) {
            double t1 = wnow();
            g_wprof[1] += t1 - tprof;
            tprof = t1;
        }
        hist.push_back(L);
        done = find_end(hist.back(), &end_k, &end_h);
        if (prof) g_wprof[2] += wnow() - tprof;
    }

    // ---- backtrace (identical rules to wfa_vec._backtrace) -------------
    Getter<T> g{hist};
    Emitter em;
    int64_t k = end_k, h = end_h;
    int64_t v = h - k;
    *out_score = s;
    if (h == m && v < n)
        em.emit(n - v, 'D');
    else if (v == n && h < m)
        em.emit(m - h, 'I');

    int state = 0;  // 0=M 1=I1 2=I2 3=D1 4=D2
    for (;;) {
        if (state == 0) {
            int64_t cur = h;
            if (s == 0) {
                int64_t seed_off = k > 0 ? k : 0;
                em.emit(cur - seed_off, '=');
                if (k < 0)
                    em.emit(-k, 'D');
                else if (k > 0)
                    em.emit(k, 'I');
                break;
            }
            int64_t mm = g.M(s - x, k);
            int64_t cx = mm > NEG ? mm + 1 : NEG;
            int64_t ci1 = g.I1(s, k);
            int64_t ci2 = g.I2(s, k);
            int64_t cd1 = g.D1(s, k);
            int64_t cd2 = g.D2(s, k);
            int64_t pre = cx;
            if (ci1 > pre) pre = ci1;
            if (ci2 > pre) pre = ci2;
            if (cd1 > pre) pre = cd1;
            if (cd2 > pre) pre = cd2;
            em.emit(cur - pre, '=');
            h = pre;
            if (cx == pre) {
                em.emit(1, 'X');
                s -= x;
                h -= 1;
            } else if (ci1 == pre) {
                state = 1;
            } else if (ci2 == pre) {
                state = 2;
            } else if (cd1 == pre) {
                state = 3;
            } else {
                state = 4;
            }
        } else if (state == 1 || state == 2) {
            int64_t o = state == 1 ? o1 : o2;
            int64_t e = state == 1 ? e1 : e2;
            em.emit(1, 'I');
            int64_t open_ = g.M(s - o - e, k - 1);
            int64_t ext = state == 1 ? g.I1(s - e, k - 1)
                                     : g.I2(s - e, k - 1);
            if (open_ > NEG && open_ + 1 == h) {
                s -= o + e;
                h -= 1;
                k -= 1;
                state = 0;
            } else if (ext > NEG && ext + 1 == h) {
                s -= e;
                h -= 1;
                k -= 1;
            } else {
                return -3;
            }
        } else {
            int64_t o = state == 3 ? o1 : o2;
            int64_t e = state == 3 ? e1 : e2;
            em.emit(1, 'D');
            int64_t open_ = g.M(s - o - e, k + 1);
            int64_t ext = state == 3 ? g.D1(s - e, k + 1)
                                     : g.D2(s - e, k + 1);
            if (open_ > NEG && open_ == h) {
                s -= o + e;
                k += 1;
                state = 0;
            } else if (ext > NEG && ext == h) {
                s -= e;
                k += 1;
            } else {
                return -3;
            }
        }
    }

    int64_t n_ops = (int64_t)em.ops.size();
    if (n_ops > cap) return -2;
    // ops were built backwards; reverse into out, packed (count<<8)|op
    for (int64_t i = 0; i < n_ops; i++) {
        int64_t j = n_ops - 1 - i;
        out[i] = (em.counts[(size_t)j] << 8) |
                 (int64_t)(uint8_t)em.ops[(size_t)j];
    }
    return n_ops;
}

}  // namespace

extern "C" {

// Read-and-reset the exact engine's inner-loop profile accumulators
// (active only under WFMASH_TPU_WFA_PROF=1): combine_s, mpass_s,
// find_s, n_levels, n_lanes. out must hold 6 doubles.
void wfa_prof_times(double* out6) {
    for (int i = 0; i < 6; i++) {
        out6[i] = g_wprof[i];
        g_wprof[i] = 0;
    }
}

// Returns: number of RLE ops written to out (packed (count<<8)|op_char),
// with *out_score set; -1 if max_score exceeded (caller returns
// (None, None)); -2 if out capacity insufficient (caller falls back);
// -3 on convergence failure (caller raises, matching wfa_vec);
// -4 if the full-history footprint exceeded mem_cap bytes (caller
// reroutes the job to the memory-bounded segmented/recursive path).
int64_t wfa_align_native(const uint8_t *q, int64_t m, const uint8_t *t,
                         int64_t n, int32_t x, int32_t o1, int32_t e1,
                         int32_t o2, int32_t e2, int64_t tb, int64_t te,
                         int64_t qb, int64_t qe, int64_t max_score,
                         int64_t *out, int64_t cap, int64_t *out_score,
                         int64_t mem_cap) {
    // A max_score cap doubles as a known-bound lane prune (see
    // wfa_align_impl): if the optimum is <= cap the pruned sweep finds
    // exactly it (bit-identically), and if not it fails at the same
    // score the capped sweep would. The bound is on the REMAINING path
    // (distance to the acceptance window), so it is seed-agnostic and
    // holds for every ends-free configuration. -5 maps back to the -1
    // cap contract.
    const int64_t prune = max_score;
    // int16 lanes when every stored offset (<= m) fits comfortably;
    // identical arithmetic, half the memory traffic, double SIMD width
    int64_t r;
    if (m < 32000 && n < 32000)
        r = wfa_align_impl<int16_t>(q, m, t, n, x, o1, e1, o2, e2, tb,
                                    te, qb, qe, max_score, out, cap,
                                    out_score, mem_cap, prune);
    else
        r = wfa_align_impl<int32_t>(q, m, t, n, x, o1, e1, o2, e2, tb,
                                    te, qb, qe, max_score, out, cap,
                                    out_score, mem_cap, prune);
    return r == -5 ? -1 : r;
}

// Content-keyed batch memo: one batch frequently carries duplicate
// jobs (boundary patches and rev-comp inversion tries recur across
// overlapping all-vs-all records). Keyed by the FULL problem content —
// sequences, free spans, and the per-piece cap (results depend on all
// three) — so a hit replays a bit-identical (status, score, runs)
// triple. Per-call lifetime; insertion stops at a memory ceiling.
namespace {
struct BatchMemoVal {
    int64_t got;      // run count, or -1 (cap exceeded)
    int64_t score;
    std::vector<int64_t> runs;
};
struct BatchMemo {
    std::unordered_map<std::string, BatchMemoVal> map;
    size_t bytes = 0;
    static constexpr size_t MAX_BYTES = 128u << 20;
    void clear() {
        map.clear();
        bytes = 0;
    }
};
thread_local BatchMemo g_batch_memo;

inline void batch_memo_key(std::string& k, const uint8_t* q, int64_t m,
                           const uint8_t* t, int64_t n, int64_t tb,
                           int64_t te, int64_t qb, int64_t qe,
                           int64_t ms) {
    k.resize((size_t)(56 + m + n));
    char* d = &k[0];
    const int64_t hdr[7] = {m, n, tb, te, qb, qe, ms};
    memcpy(d, hdr, 56);
    memcpy(d + 56, q, (size_t)m);
    memcpy(d + 56 + m, t, (size_t)n);
}
}  // namespace

// Many small end-to-end alignments in ONE call (the segmented host
// path solves ~40 pieces per diverted block; per-piece ctypes glue was
// ~280 us against ~20 us of actual WFA). Sequences are concatenated in
// qbuf/tbuf with n+1 offsets each; ops append into out with
// out_counts[i] runs for piece i. Any per-piece failure aborts the
// whole call (caller falls back to per-piece Python dispatch).
int64_t wfa_align_batch(const uint8_t* qbuf, const int64_t* qoff,
                        const uint8_t* tbuf, const int64_t* toff,
                        int64_t n_pieces, int32_t x, int32_t o1,
                        int32_t e1, int32_t o2, int32_t e2,
                        const int64_t* max_scores,   // nullable; -1 = none
                        int64_t* out, int64_t cap, int64_t* out_counts,
                        int64_t* out_scores, int64_t mem_cap) {
    g_batch_memo.clear();
    std::string key;
    int64_t n_out = 0;
    for (int64_t i = 0; i < n_pieces; i++) {
        const uint8_t* q = qbuf + qoff[i];
        const uint8_t* t = tbuf + toff[i];
        const int64_t m = qoff[i + 1] - qoff[i];
        const int64_t n = toff[i + 1] - toff[i];
        int64_t ms = max_scores ? max_scores[i] : -1;
        const bool memo_ok = m + n <= 16384;
        if (memo_ok) {
            batch_memo_key(key, q, m, t, n, 0, 0, 0, 0, ms);
            auto it = g_batch_memo.map.find(key);
            if (it != g_batch_memo.map.end()) {
                const BatchMemoVal& v = it->second;
                if (v.got == -1) {
                    out_counts[i] = -1;
                    out_scores[i] = -1;
                    continue;
                }
                if (n_out + v.got > cap) return -2;
                std::copy(v.runs.begin(), v.runs.end(), out + n_out);
                out_counts[i] = v.got;
                out_scores[i] = v.score;
                n_out += v.got;
                continue;
            }
        }
        int64_t score = 0;
        int64_t got = wfa_align_native(
            q, m, t, n, x, o1, e1, o2, e2, 0, 0, 0, 0, ms,
            out + n_out, cap - n_out, &score, mem_cap);
        if (got >= 0 || got == -1) {
            if (memo_ok && g_batch_memo.bytes < BatchMemo::MAX_BYTES) {
                BatchMemoVal v;
                v.got = got;
                v.score = got == -1 ? -1 : score;
                if (got > 0)
                    v.runs.assign(out + n_out, out + n_out + got);
                g_batch_memo.bytes +=
                    key.size() + v.runs.size() * 8 + 96;
                g_batch_memo.map.emplace(key, std::move(v));
            }
        }
        if (got == -1) {             // per-piece score cap exceeded
            out_counts[i] = -1;
            out_scores[i] = -1;
            continue;
        }
        if (got < 0) return got;
        out_counts[i] = got;
        out_scores[i] = score;
        n_out += got;
    }
    return n_out;
}

// Ends-free variant: per-piece (tb, te, qb, qe) free spans (the patch
// phase's two engine.align_batch calls collapse to one ctypes call
// each). Same output protocol as wfa_align_batch.
int64_t wfa_align_batch_ef(const uint8_t* qbuf, const int64_t* qoff,
                           const uint8_t* tbuf, const int64_t* toff,
                           int64_t n_pieces, int32_t x, int32_t o1,
                           int32_t e1, int32_t o2, int32_t e2,
                           const int64_t* tb, const int64_t* te,
                           const int64_t* qb, const int64_t* qe,
                           const int64_t* max_scores,  // nullable
                           int64_t* out, int64_t cap,
                           int64_t* out_counts, int64_t* out_scores,
                           int64_t mem_cap) {
    g_batch_memo.clear();
    std::string key;
    int64_t n_out = 0;
    for (int64_t i = 0; i < n_pieces; i++) {
        const uint8_t* q = qbuf + qoff[i];
        const uint8_t* t = tbuf + toff[i];
        const int64_t m = qoff[i + 1] - qoff[i];
        const int64_t n = toff[i + 1] - toff[i];
        int64_t ms = max_scores ? max_scores[i] : -1;
        const bool memo_ok = m + n <= 16384;
        if (memo_ok) {
            batch_memo_key(key, q, m, t, n, tb[i], te[i], qb[i], qe[i],
                           ms);
            auto it = g_batch_memo.map.find(key);
            if (it != g_batch_memo.map.end()) {
                const BatchMemoVal& v = it->second;
                if (v.got == -1) {
                    out_counts[i] = -1;
                    out_scores[i] = -1;
                    continue;
                }
                if (n_out + v.got > cap) return -2;
                std::copy(v.runs.begin(), v.runs.end(), out + n_out);
                out_counts[i] = v.got;
                out_scores[i] = v.score;
                n_out += v.got;
                continue;
            }
        }
        int64_t score = 0;
        int64_t got = wfa_align_native(
            q, m, t, n, x, o1, e1, o2, e2,
            tb[i], te[i], qb[i], qe[i], ms,
            out + n_out, cap - n_out, &score, mem_cap);
        if (got >= 0 || got == -1) {
            if (memo_ok && g_batch_memo.bytes < BatchMemo::MAX_BYTES) {
                BatchMemoVal v;
                v.got = got;
                v.score = got == -1 ? -1 : score;
                if (got > 0)
                    v.runs.assign(out + n_out, out + n_out + got);
                g_batch_memo.bytes +=
                    key.size() + v.runs.size() * 8 + 96;
                g_batch_memo.map.emplace(key, std::move(v));
            }
        }
        if (got == -1) {
            out_counts[i] = -1;
            out_scores[i] = -1;
            continue;
        }
        if (got < 0) return got;
        out_counts[i] = got;
        out_scores[i] = score;
        n_out += got;
    }
    return n_out;
}

}  // extern "C"
