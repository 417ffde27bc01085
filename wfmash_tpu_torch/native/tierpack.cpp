// One tier chunk's fused upload buffer in one call: each job's envelope,
// the byte -> 4-bit code map, the nibble rows and the parameter block
// (align/wfa_seg.py::SegmentSolver.pack_chunk_py is the Python spec;
// byte-identical, tested in tests/test_torch_pack.py).
//
// A row of the B = groups*PB rows is L/2 + L/2 + 64 bytes: the query's
// codes at column S, code 14 elsewhere | the target's codes at column P,
// code 15 elsewhere (two codes a byte, low nibble first) | 16 little-
// endian int32 parameters (S+m, P+n, S, S-P, tb, qb, te, qe, cap, 0..).
// Rows past the jobs are all pad codes with zero parameters.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the parameter block is written as host int32");

namespace {

constexpr int64_t kBandMargin = 16;   // wfa_seg._BAND_MARGIN
constexpr int kCols = 7;              // m, n, tb, qb, te, qe, cap a job

int64_t floor_half(int64_t v) {       // Python's v // 2
    return v >= 0 ? v / 2 : -((1 - v) / 2);
}

bool fits_i32(int64_t v) { return v >= INT32_MIN && v <= INT32_MAX; }

// SegmentSolver._envelope: false when the chunk cannot take the job.
// gap[i] = gap_cost(i) for i in 0..K/2.
bool envelope(int64_t m, int64_t n, int64_t tb, int64_t qb, int64_t te,
              int64_t qe, int64_t K, int64_t lseg, const int64_t* gap,
              int32_t* par, int64_t* cert, uint8_t* always) {
    tb = std::min(tb, n);
    qb = std::min(qb, m);
    const int64_t width = K - 2 * kBandMargin;
    const int64_t s_lo = -tb, s_hi = qb;
    const int64_t a_lo = m - n - qe, a_hi = m - n + te;
    int64_t lo = std::min(s_lo, a_lo), hi = std::max(s_hi, a_hi);
    int64_t times = 2;                 // both hulls in band
    *always = 0;
    if (hi - lo >= width) {
        times = 1;                     // one hull anchors every path
        *always = 1;
        if (a_hi - a_lo < width) {
            lo = a_lo, hi = a_hi;
        } else if (s_hi - s_lo < width) {
            lo = s_lo, hi = s_hi;
        } else {
            return false;
        }
    }
    const int64_t cc = floor_half(lo + hi);
    const int64_t margin = K / 2 - std::max(hi - cc, cc - lo);
    *cert = times * (margin > 0 ? gap[margin] : 0);
    const int64_t S = std::max<int64_t>(0, -cc), P = std::max<int64_t>(0, cc);
    if (S + m >= lseg || P + n >= lseg) return false;
    const int64_t v[8] = {S + m, P + n, S, S - P, tb, qb, te, qe};
    for (int k = 0; k < 8; k++) {
        if (!fits_i32(v[k])) return false;
        par[k] = (int32_t)v[k];
    }
    return true;
}

// codes of src[0..len) at column `at` of an L-code row of `pad`, packed
// two a byte into dst[0..L/2)
void place(uint8_t* dst, uint8_t* row, int64_t L, const uint8_t* src,
           int64_t len, int64_t at, uint8_t pad, const uint8_t* lut) {
    std::memset(row, pad, L);
    for (int64_t i = 0; i < len; i++) row[at + i] = lut[src[i]];
    for (int64_t c = 0; c < L / 2; c++)
        dst[c] = (uint8_t)(row[2 * c] | (row[2 * c + 1] << 4));
}

}  // namespace

extern "C" {

// jobs: (nj, 7) int64 rows (m, n, tb, qb, te, qe, cap; 0 for no ends-free
// span and for no cap); qcat/tcat: the jobs' sequences joined in order;
// sym_lut: wfa_seg._SYM_LUT (0xFF for a byte without a fixed code);
// gap: gap_cost(0..K/2). Writes buf (B, L + 64), cert_b (B) and
// cert_always (B). Returns 0 when packed; 1 when a byte has no fixed
// code and more than 14 distinct bytes are present (the chunk gives up);
// 2 when a job lies outside what this routine packs (no envelope holds
// it, or a parameter leaves int32): the caller runs the Python spec.
int64_t pack_tier_chunk(const uint8_t* qcat, const uint8_t* tcat,
                        const int64_t* jobs, int64_t nj, int64_t B,
                        int64_t L, int64_t K, int64_t smax,
                        const uint8_t* sym_lut, const int64_t* gap,
                        uint8_t* buf, int64_t* cert_b,
                        uint8_t* cert_always) {
    const int64_t W = L + 64;
    std::vector<int32_t> par((size_t)B * 16, 0);
    std::memset(cert_b, 0, sizeof(int64_t) * B);
    std::memset(cert_always, 0, B);
    int64_t qtot = 0, ttot = 0;
    for (int64_t j = 0; j < nj; j++) {
        const int64_t* r = jobs + j * kCols;
        int32_t* pj = par.data() + j * 16;
        if (!envelope(r[0], r[1], r[2], r[3], r[4], r[5], K, L, gap, pj,
                      cert_b + j, cert_always + j))
            return 2;
        const int64_t cap = std::min(r[6], smax);
        if (!fits_i32(cap)) return 2;
        pj[8] = (int32_t)cap;
        qtot += r[0];
        ttot += r[1];
    }
    // a byte without a fixed code: every byte present gets a code in
    // byte order (the kernel only tests equality)
    uint8_t lut[256];
    std::memcpy(lut, sym_lut, 256);
    int64_t seen[256] = {0};
    for (int64_t i = 0; i < qtot; i++) seen[qcat[i]]++;
    for (int64_t i = 0; i < ttot; i++) seen[tcat[i]]++;
    bool unmapped = false;
    int n_present = 0;
    for (int b = 0; b < 256; b++) {
        if (!seen[b]) continue;
        n_present++;
        unmapped |= sym_lut[b] == 0xFF;
    }
    if (unmapped) {
        if (n_present > 14) return 1;
        std::memset(lut, 0xFF, 256);
        uint8_t code = 0;
        for (int b = 0; b < 256; b++)
            if (seen[b]) lut[b] = code++;
    }
    std::vector<uint8_t> row(L);
    const uint8_t* q = qcat;
    const uint8_t* t = tcat;
    for (int64_t j = 0; j < B; j++) {
        uint8_t* out = buf + j * W;
        const int32_t* pj = par.data() + j * 16;
        if (j < nj) {
            const int64_t m = jobs[j * kCols], n = jobs[j * kCols + 1];
            place(out, row.data(), L, q, m, pj[2], 14, lut);
            place(out + L / 2, row.data(), L, t, n, pj[2] - pj[3], 15, lut);
            q += m;
            t += n;
        } else {
            std::memset(out, 0xEE, L / 2);
            std::memset(out + L / 2, 0xFF, L / 2);
        }
        std::memcpy(out + L, pj, 64);
    }
    return 0;
}

}  // extern "C"
