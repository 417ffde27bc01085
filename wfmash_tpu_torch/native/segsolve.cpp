// Native per-block segmented solver — the WHOLE of
// wfmash_tpu/align/segmented.py::segmented_host_align in one ctypes
// call (bit-identical; the Python function remains the executable spec
// and the fallback, equality enforced by tests/test_native.py):
//
//   plan_block (anchor-k ladder + cuts + refinement)
//   -> span classification (gap runs / structural-skew placement via
//      place_short diagonal voting / plain pieces)
//   -> per-piece junk + refine caps, exact WFA per piece
//   -> capped-piece handling (depth-0 re-anchoring recursion at
//      seg_target=128, trivial diagonal alignment for junk)
//   -> stitched RLE runs with junction merging.
//
// Rationale: the per-block Python glue (plan lists, zip loops, numpy
// marshalling, per-batch ctypes calls) was ~40% of the segmented
// path's wall on the LPA all-vs-all benchmark; the compute kernels
// were already native. One call per block leaves only the run-list
// unpack in Python.
//
// Reference analogue: wflign's hierarchical wflambda segmentation
// (src/common/wflign/src/wflign.cpp) — re-designed as anchor-chain
// segmentation (SURVEY.md §2.6 #39); this file is the host engine's
// spelling of it.

#include "wfa.cpp"      // wfa_align_native (+ arena, int16/int32 impls)
#include "anchors.cpp"  // plan_block, place_short (extern "C")

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <string>
#include <unordered_map>
#include <vector>

namespace segsolve {

// Lightweight phase accumulators (per thread; read+reset via
// segsolve_phase_times). Indices: 0 exact_s (probe passed = the solve),
// 1 probe_fail_s (capped probe that hit the cap), 2 plan_s,
// 3 place_s, 4 piece_s (incl. refine recursion), 5 n_exact,
// 6 n_seg, 7 n_pieces. Slot 16: whole-block memo hits.
thread_local double g_phase[18] = {0};

static inline double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

// RLE run list packed like the wfa bindings: (count << 8) | op_char.
struct RunEmit {
    std::vector<int64_t> runs;
    void emit(int64_t cnt, char op) {
        if (cnt <= 0) return;
        if (!runs.empty() && (char)(runs.back() & 0xFF) == op)
            runs.back() += cnt << 8;
        else
            runs.push_back((cnt << 8) | (int64_t)(uint8_t)op);
    }
    // append a packed run list, merging only the junction run (the
    // Python emit_runs contract: solver output is already RLE-merged)
    void emit_packed(const int64_t* p, int64_t k) {
        int64_t i = 0;
        if (k > 0 && !runs.empty() &&
            (runs.back() & 0xFF) == (p[0] & 0xFF)) {
            runs.back() += (p[0] >> 8) << 8;
            i = 1;
        }
        for (; i < k; i++) runs.push_back(p[i]);
    }
};

// Score of the trivial diagonal alignment (per-base =/X + one
// trailing gap run), scanned with early abort at `limit`: any
// end-to-end problem's optimum is <= this, so min(cap, diag_bound) is
// a semantics-preserving max_score that prunes near-identical
// problems' wavefronts hard (see wfa.cpp's known-bound prune).
// Returns >= limit when the bound is not useful.
static int64_t diag_bound(const uint8_t* q, int64_t m, const uint8_t* t,
                          int64_t n, int32_t x, int32_t o1, int32_t e1,
                          int32_t o2, int32_t e2, int64_t limit) {
    const int64_t L = std::min(m, n);
    const int64_t d = m > n ? m - n : n - m;
    int64_t s = d ? std::min((int64_t)o1 + e1 * d, (int64_t)o2 + e2 * d)
                  : 0;
    for (int64_t i = 0; i < L && s < limit; i++)
        if (q[i] != t[i]) s += x;
    return s;
}

// segmented.py::_diag_ops — trivial replayable alignment for
// junk-level pieces: per-base =/X on the main diagonal + the length
// difference as one trailing gap run.
static void diag_ops(const uint8_t* q, int64_t m, const uint8_t* t,
                     int64_t n, RunEmit& em) {
    const int64_t L = std::min(m, n);
    if (L) {
        int64_t start = 0;
        bool cur = q[0] == t[0];
        for (int64_t i = 1; i < L; i++) {
            bool e = q[i] == t[i];
            if (e != cur) {
                em.emit(i - start, cur ? '=' : 'X');
                start = i;
                cur = e;
            }
        }
        em.emit(L - start, cur ? '=' : 'X');
    }
    if (m > n)
        em.emit(m - n, 'I');
    else if (n > m)
        em.emit(n - m, 'D');
}

// Content-keyed piece memo. All-vs-all record sets tile the same
// sequence pairs with overlapping padded extents, so anchor-planned
// pieces with IDENTICAL (query, target) bytes recur across records;
// piece solving is deterministic in (bytes, depth) for fixed penalties
// and caps, so replaying the memoized runs is bit-identical by
// construction. Keyed by the full content (no hash-collision risk),
// cleared at each top-level batch entry (penalties/caps constant
// within a call), insertion stops past a memory ceiling.
struct PieceMemo {
    std::unordered_map<std::string, std::vector<int64_t>> map;
    size_t bytes = 0;
    static constexpr size_t MAX_BYTES = 128u << 20;
    void clear() {
        map.clear();
        bytes = 0;
    }
};
static thread_local PieceMemo g_piece_memo;

// Whole-block content memo for host_align_blocks. All-vs-all record
// sets emit many records whose PADDED (query, target) extents coincide
// exactly (measured on LPA: 1064 of 2259 blocks are byte-duplicates),
// and the per-block result (status + runs) is deterministic in the
// bytes for fixed penalties/caps — so replaying is bit-identical by
// construction. Same design as PieceMemo: full-content key (no
// collision risk), per-call lifetime, insertion ceiling.
struct BlockMemo {
    std::unordered_map<std::string,
                       std::pair<int64_t, std::vector<int64_t>>> map;
    size_t bytes = 0;
    static constexpr size_t MAX_BYTES = 256u << 20;
    void clear() {
        map.clear();
        bytes = 0;
    }
};
static thread_local BlockMemo g_block_memo;

// Core of segmented_host_align for one block. depth 0 applies the
// refine cap and recurses once (seg_target 128) on capped pieces;
// depth 1 applies only the junk cap and emits diagonals on cap hits.
// Returns 1 on success (runs in em), 0 when the block is unplannable
// (caller falls back to its exact path), -3 on a WFA convergence
// failure, -4 when a piece exceeded the memory budget.
static int64_t solve_block(const uint8_t* q, int64_t m, const uint8_t* t,
                           int64_t n, int32_t x, int32_t o1, int32_t e1,
                           int32_t o2, int32_t e2, int64_t seg_target,
                           int64_t refine_cap, int64_t depth,
                           int64_t mem_cap, RunEmit& em) {
    const int64_t lseg = 512, K = 256;
    // plan (growing-buffer retry mirrors the Python wrapper)
    std::vector<int64_t> bq, bt;
    {
        double t0 = now_s();
        int64_t cap = std::max<int64_t>(64, m / 8);
        for (;;) {
            bq.resize(cap);
            bt.resize(cap);
            int64_t got = plan_block(q, m, t, n, seg_target, lseg, K,
                                     bq.data(), bt.data(), cap);
            if (got != -1) g_phase[2] += now_s() - t0;
            if (got == -1) {
                cap *= 4;
                continue;
            }
            if (got == 0) return 0;
            bq.resize(got);
            bt.resize(got);
            break;
        }
    }
    // span classification — mirrors the plan/pieces loop
    struct Ent {
        char type;          // 'P' piece | 'G' placed piece | 'I' | 'D'
        int64_t cnt = 0;    // for I/D entries
        int64_t piece = -1;
        int64_t pre_cnt = 0, post_cnt = 0;
        char gap_op = 0;    // 'I' or 'D' for G pre/post runs
        int64_t q0 = 0, q1 = 0, t0 = 0, t1 = 0;  // piece slices
    };
    std::vector<Ent> plan;
    int64_t n_pieces = 0;
    for (size_t i = 0; i + 1 < bq.size(); i++) {
        const int64_t q0 = bq[i], q1 = bq[i + 1];
        const int64_t t0 = bt[i], t1 = bt[i + 1];
        const int64_t dq = q1 - q0, dt = t1 - t0;
        Ent e;
        if (dq == 0) {
            e.type = 'D';
            e.cnt = dt;
        } else if (dt == 0) {
            e.type = 'I';
            e.cnt = dq;
        } else if (dq - dt > 400 || dt - dq > 400) {
            const int64_t skew = dq - dt;
            const double tp0 = now_s();
            const int64_t off =
                skew > 0 ? place_short(t + t0, dt, q + q0, dq, 13, 8)
                         : place_short(q + q0, dq, t + t0, dt, 13, 8);
            g_phase[3] += now_s() - tp0;
            if (off < 0) {
                e.type = 'P';
                e.piece = n_pieces++;
                e.q0 = q0; e.q1 = q1; e.t0 = t0; e.t1 = t1;
            } else if (skew > 0) {
                e.type = 'G';
                e.gap_op = 'I';
                e.pre_cnt = off;
                e.post_cnt = skew - off;
                e.piece = n_pieces++;
                e.q0 = q0 + off; e.q1 = q0 + off + dt;
                e.t0 = t0; e.t1 = t1;
            } else {
                e.type = 'G';
                e.gap_op = 'D';
                e.pre_cnt = off;
                e.post_cnt = -skew - off;
                e.piece = n_pieces++;
                e.q0 = q0; e.q1 = q1;
                e.t0 = t0 + off; e.t1 = t0 + off + dq;
            }
        } else {
            e.type = 'P';
            e.piece = n_pieces++;
            e.q0 = q0; e.q1 = q1; e.t0 = t0; e.t1 = t1;
        }
        plan.push_back(e);
    }
    // solve pieces (plan order == piece order)
    std::vector<std::vector<int64_t>> solved(n_pieces);
    std::vector<int64_t> scratch;
    std::string ckey;   // content-keyed piece memo key (see g_piece_memo)
    // Exact diagonal fast path: a same-length piece whose mismatch
    // cost is STRICTLY below every gap-pair cost (any path leaving the
    // diagonal must open one I and one D: >= o+e each) has the pure
    // diagonal as its unique optimum — the WFA would return exactly
    // diag_ops' RLE, so emitting it directly is bit-identical. On the
    // LPA benchmark ~half the anchored pieces qualify.
    const int64_t gap2 =
        2 * std::min((int64_t)o1 + e1, (int64_t)o2 + e2);
    const int64_t diag_max_mm = x > 0 ? (gap2 - 1) / x : -1;
    for (const Ent& e : plan) {
        if (e.piece < 0) continue;
        const int64_t pm = e.q1 - e.q0, pn = e.t1 - e.t0;
        if (pm == pn && diag_max_mm >= 0) {
            int64_t cnt = 0;
            const uint8_t* pq = q + e.q0;
            const uint8_t* pt = t + e.t0;
            for (int64_t ii = 0; ii < pm; ii++)
                if (pq[ii] != pt[ii] && ++cnt > diag_max_mm) break;
            if (cnt <= diag_max_mm) {
                RunEmit d;
                diag_ops(pq, pm, pt, pn, d);
                solved[e.piece] = std::move(d.runs);
                g_phase[7] += 1;
                g_phase[8] += 1;   // diag fast-path pieces
                continue;
            }
        }
        // content-keyed memo lookup (see PieceMemo: identical bytes at
        // the same depth solve identically — replay is bit-identical)
        const bool memo_ok = (pm + pn) <= 4096;
        if (memo_ok) {
            ckey.resize((size_t)(17 + pm + pn));
            char* kd = &ckey[0];
            kd[0] = (char)depth;
            memcpy(kd + 1, &pm, 8);
            memcpy(kd + 9, &pn, 8);
            memcpy(kd + 17, q + e.q0, (size_t)pm);
            memcpy(kd + 17 + pm, t + e.t0, (size_t)pn);
            auto it = g_piece_memo.map.find(ckey);
            if (it != g_piece_memo.map.end()) {
                solved[e.piece] = it->second;
                g_phase[7] += 1;
                continue;
            }
        }
        const int64_t junk =
            ((int64_t)x * std::min(pm, pn)) * 55 / 100 + 64;
        const int64_t cap_s =
            (depth == 0 && refine_cap > 0) ? std::min(junk, refine_cap)
                                           : junk;
        scratch.resize((size_t)(pm + pn + 64));
        int64_t score = 0;
        const double tw0 = now_s();
        g_phase[7] += 1;
        // diagonal-score upper bound tightens the cap (identical
        // accept/reject + bit-identical CIGAR, see diag_bound)
        const int64_t db = diag_bound(q + e.q0, pm, t + e.t0, pn, x,
                                      o1, e1, o2, e2, cap_s);
        int64_t got = wfa_align_native(
            q + e.q0, pm, t + e.t0, pn, x, o1, e1, o2, e2, 0, 0, 0, 0,
            std::min(cap_s, db), scratch.data(),
            (int64_t)scratch.size(), &score, mem_cap);
        g_phase[4] += now_s() - tw0;
        if (got == -1) g_phase[9] += 1;          // capped pieces
        g_phase[10] += (double)(pm + pn);        // piece bp solved
        if (score > 0) g_phase[11] += (double)(score * score);
        auto memo_put = [&](const std::vector<int64_t>& runs) {
            if (!memo_ok ||
                g_piece_memo.bytes >= PieceMemo::MAX_BYTES)
                return;
            g_piece_memo.bytes +=
                ckey.size() + runs.size() * 8 + 64;
            g_piece_memo.map.emplace(ckey, runs);
        };
        if (got >= 0) {
            solved[e.piece].assign(scratch.begin(),
                                   scratch.begin() + got);
            memo_put(solved[e.piece]);
            continue;
        }
        if (got == -4 || got == -3 || got == -2) return got;
        // got == -1: piece exceeded its cap
        RunEmit sub;
        int64_t r = 0;
        if (depth == 0 && std::min(pm, pn) >= 96)
            r = solve_block(q + e.q0, pm, t + e.t0, pn, x, o1, e1, o2,
                            e2, 128, refine_cap, 1, mem_cap, sub);
        if (r < 0) return r;
        if (r == 1) {
            solved[e.piece] = std::move(sub.runs);
        } else {
            RunEmit d;
            diag_ops(q + e.q0, pm, t + e.t0, pn, d);
            solved[e.piece] = std::move(d.runs);
        }
        memo_put(solved[e.piece]);
    }
    // stitch
    for (const Ent& e : plan) {
        if (e.type == 'P') {
            em.emit_packed(solved[e.piece].data(),
                           (int64_t)solved[e.piece].size());
        } else if (e.type == 'G') {
            em.emit(e.pre_cnt, e.gap_op);
            em.emit_packed(solved[e.piece].data(),
                           (int64_t)solved[e.piece].size());
            em.emit(e.post_cnt, e.gap_op);
        } else {
            em.emit(e.cnt, e.type);
        }
    }
    return 1;
}

}  // namespace segsolve

extern "C" {

// One-call segmented host alignment for a block. Writes packed RLE
// runs ((count << 8) | op) to out. Returns the run count, 0 when the
// block is unplannable (caller falls back to its exact path), -2 when
// out is too small (caller retries with a bigger buffer), -3 on a WFA
// convergence failure (caller falls back to the Python spec), -4 when
// a piece exceeded mem_cap (caller reroutes — WfaMemoryBudget).
int64_t segmented_solve(const uint8_t* q, int64_t m, const uint8_t* t,
                        int64_t n, int32_t x, int32_t o1, int32_t e1,
                        int32_t o2, int32_t e2, int64_t seg_target,
                        int64_t refine_cap, int64_t* out, int64_t cap,
                        int64_t mem_cap) {
    segsolve::g_piece_memo.clear();   // penalties/caps fixed per call
    segsolve::RunEmit em;
    int64_t r = segsolve::solve_block(q, m, t, n, x, o1, e1, o2, e2,
                                      seg_target, refine_cap, 0,
                                      mem_cap, em);
    if (r <= 0) return r;
    if ((int64_t)em.runs.size() > cap) return -2;
    std::copy(em.runs.begin(), em.runs.end(), out);
    return (int64_t)em.runs.size();
}

// The latency-aware host engine's WHOLE main-block batch in one call:
// per block, the capped exact probe (score_cap, blocks with
// min(m,n) >= min_probe), the segmented reroute on cap hit, and the
// plain exact solve for small blocks — BudgetedHostEngine.align /
// align_batch semantics end to end. Runs append to out with
// out_counts[i] per block; out_status[i] reports the path taken:
//   0 exact (probe pass / small block)   1 segmented
//   2 unplannable (caller runs its exact+reroute path)
//   3 solver fallback (caller re-runs the block in Python)
//   4 memory budget exceeded (caller reroutes, WfaMemoryBudget)
// Returns total runs, or -2 when out is too small (caller grows).
int64_t host_align_blocks(const uint8_t* qbuf, const int64_t* qoff,
                          const uint8_t* tbuf, const int64_t* toff,
                          int64_t n_blocks, int32_t x, int32_t o1,
                          int32_t e1, int32_t o2, int32_t e2,
                          int64_t score_cap, int64_t min_probe,
                          int64_t seg_target, int64_t refine_cap,
                          int64_t* out, int64_t cap,
                          int64_t* out_counts, int64_t* out_status,
                          int64_t mem_cap) {
    const double tcall0 = segsolve::now_s();
    // piece memo lives for the whole batch: overlapping records in an
    // all-vs-all set re-plan identical pieces across blocks
    segsolve::g_piece_memo.clear();
    segsolve::g_block_memo.clear();
    std::string bkey;
    int64_t n_out = 0;
    for (int64_t i = 0; i < n_blocks; i++) {
        const uint8_t* q = qbuf + qoff[i];
        const uint8_t* t = tbuf + toff[i];
        const int64_t m = qoff[i + 1] - qoff[i];
        const int64_t n = toff[i + 1] - toff[i];
        out_counts[i] = 0;
        // whole-block content memo (see BlockMemo): a byte-identical
        // (q, t) pair replays its (status, runs) — plan, probe, piece
        // solves and the exact sweep all skip
        bkey.resize((size_t)(16 + m + n));
        {
            char* kd = &bkey[0];
            memcpy(kd, &m, 8);
            memcpy(kd + 8, &n, 8);
            memcpy(kd + 16, q, (size_t)m);
            memcpy(kd + 16 + m, t, (size_t)n);
        }
        {
            auto bit = segsolve::g_block_memo.map.find(bkey);
            if (bit != segsolve::g_block_memo.map.end()) {
                const auto& pr = bit->second;
                if (n_out + (int64_t)pr.second.size() > cap) return -2;
                std::copy(pr.second.begin(), pr.second.end(),
                          out + n_out);
                out_counts[i] = (int64_t)pr.second.size();
                out_status[i] = pr.first;
                n_out += out_counts[i];
                segsolve::g_phase[16] += 1;
                continue;
            }
        }
        const int64_t n_out0 = n_out;
        auto bmemo_put = [&](int64_t st) {
            if (segsolve::g_block_memo.bytes >=
                segsolve::BlockMemo::MAX_BYTES)
                return;
            std::vector<int64_t> runs(out + n_out0, out + n_out);
            segsolve::g_block_memo.bytes +=
                bkey.size() + runs.size() * 8 + 96;
            segsolve::g_block_memo.map.emplace(
                bkey, std::make_pair(st, std::move(runs)));
        };
        // whole-block exact diagonal fast path (same argument as the
        // piece-level one: mismatch cost strictly below any gap-pair
        // cost => the diagonal is the unique optimum; scan aborts at
        // the first disqualifying mismatch so non-qualifying blocks
        // pay ~a few hundred bytes of compares)
        if (m == n && x > 0) {
            const int64_t gap2 =
                2 * std::min((int64_t)o1 + e1, (int64_t)o2 + e2);
            const int64_t max_mm = (gap2 - 1) / x;
            int64_t cnt = 0;
            for (int64_t ii = 0; ii < m; ii++)
                if (q[ii] != t[ii] && ++cnt > max_mm) break;
            if (cnt <= max_mm) {
                segsolve::RunEmit d;
                segsolve::diag_ops(q, m, t, n, d);
                if (n_out + (int64_t)d.runs.size() > cap) return -2;
                std::copy(d.runs.begin(), d.runs.end(), out + n_out);
                out_counts[i] = (int64_t)d.runs.size();
                out_status[i] = 0;
                n_out += out_counts[i];
                segsolve::g_phase[5] += 1;
                bmemo_put(0);
                continue;
            }
        }
        const bool probe =
            score_cap > 0 && std::min(m, n) >= min_probe;
        // Exact mode (score_cap == 0) on a big block: spend one cheap
        // segmented solve to get a replayable upper bound U, then run
        // the exact solve with known-bound lane pruning (see
        // wfa_align_impl's prune_bound) — the score is provably the
        // true optimum, at roughly a third of the unpruned lane count.
        if (score_cap == 0 && std::min(m, n) >= min_probe) {
            segsolve::RunEmit ub;
            int64_t ur = segsolve::solve_block(q, m, t, n, x, o1, e1,
                                               o2, e2, seg_target,
                                               refine_cap, 0, mem_cap,
                                               ub);
            if (ur == 1) {
                int64_t U = 0;   // score of the segmented CIGAR
                for (int64_t v : ub.runs) {
                    const int64_t cnt = v >> 8;
                    const char op = (char)(v & 0xFF);
                    if (op == 'X') U += (int64_t)x * cnt;
                    else if (op == 'I' || op == 'D')
                        U += std::min((int64_t)o1 + e1 * cnt,
                                      (int64_t)o2 + e2 * cnt);
                }
                int64_t score = 0;
                const double tp0 = segsolve::now_s();
                int64_t got =
                    (m < 32000 && n < 32000)
                        ? wfa_align_impl<int16_t>(
                              q, m, t, n, x, o1, e1, o2, e2, 0, 0, 0,
                              0, -1, out + n_out, cap - n_out, &score,
                              mem_cap, U)
                        : wfa_align_impl<int32_t>(
                              q, m, t, n, x, o1, e1, o2, e2, 0, 0, 0,
                              0, -1, out + n_out, cap - n_out, &score,
                              mem_cap, U);
                segsolve::g_phase[0] += segsolve::now_s() - tp0;
                if (got >= 0) {
                    segsolve::g_phase[5] += 1;
                    out_counts[i] = got;
                    out_status[i] = 0;
                    n_out += got;
                    bmemo_put(0);
                    continue;
                }
                if (got == -2) return -2;
                if (got == -4) { out_status[i] = 4; bmemo_put(4); continue; }
                // -5 (bound violated — cannot happen with a valid U)
                // or -3: fall through to the unpruned exact solve
            }
        }
        int64_t score = 0;
        const double tp0 = segsolve::now_s();
        int64_t ms = probe ? score_cap : -1;
        if (probe) {
            // diagonal-score bound: semantics-preserving cap tightener
            const int64_t db = segsolve::diag_bound(
                q, m, t, n, x, o1, e1, o2, e2, score_cap);
            if (db < ms) ms = db;
        }
        int64_t got = wfa_align_native(
            q, m, t, n, x, o1, e1, o2, e2, 0, 0, 0, 0,
            ms, out + n_out, cap - n_out, &score,
            mem_cap);
        if (got >= 0) {
            segsolve::g_phase[0] += segsolve::now_s() - tp0;
            segsolve::g_phase[5] += 1;
            out_counts[i] = got;
            out_status[i] = 0;
            n_out += got;
            bmemo_put(0);
            continue;
        }
        segsolve::g_phase[1] += segsolve::now_s() - tp0;
        segsolve::g_phase[6] += 1;
        if (got == -2) return -2;
        if (got == -4) { out_status[i] = 4; bmemo_put(4); continue; }
        if (got == -3) { out_status[i] = 3; bmemo_put(3); continue; }
        // got == -1: probe cap exceeded -> segmented reroute
        segsolve::RunEmit em;
        int64_t r = segsolve::solve_block(q, m, t, n, x, o1, e1, o2,
                                          e2, seg_target, refine_cap,
                                          0, mem_cap, em);
        if (r == 1) {
            if (n_out + (int64_t)em.runs.size() > cap) return -2;
            std::copy(em.runs.begin(), em.runs.end(), out + n_out);
            out_counts[i] = (int64_t)em.runs.size();
            out_status[i] = 1;
            n_out += out_counts[i];
            bmemo_put(1);
        } else if (r == 0) {
            out_status[i] = 2;
            bmemo_put(2);
        } else if (r == -4) {
            out_status[i] = 4;
            bmemo_put(4);
        } else if (r == -2) {
            return -2;
        } else {
            out_status[i] = 3;
            bmemo_put(3);
        }
    }
    segsolve::g_phase[12] += segsolve::now_s() - tcall0;  // total call
    return n_out;
}

// Read-and-reset the per-thread phase accumulators (see g_phase docs).
// out must hold 8 doubles. Diagnostic only — used by the perf report
// (WFMASH_TPU_PERF) and bench.py's phase table.
void segsolve_phase_times(double* out8) {
    for (int i = 0; i < 13; i++) {
        out8[i] = segsolve::g_phase[i];
        segsolve::g_phase[i] = 0;
    }
    for (int i = 0; i < 3; i++) {
        out8[13 + i] = g_anchor_prof[i];
        g_anchor_prof[i] = 0;
    }
    out8[16] = segsolve::g_phase[16];
    segsolve::g_phase[16] = 0;
}

}  // extern "C"
