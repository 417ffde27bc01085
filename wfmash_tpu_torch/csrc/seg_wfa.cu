// Full-history segment WFA for Hopper (sm_90a).
//
// Replaces the TPU kernel wfmash_tpu/align/wfa_pallas_seg.py::_make_seg_kernel
// together with its two XLA companions in the same launch, _eq_bits (the
// per-diagonal match bitstreams) and the run-compaction epilogue of
// _run_seg_impl. It computes the same function: a 2-piece gap-affine WFA
// over the five states M, I1, I2, D1, D2 for many small problems, every
// score level kept as int16 history, ends-free by placement (par cols 0-7),
// a per-problem score cap (par col 8), the band-edge contact flag, and the
// score-synchronous backtrace emitting RLE runs (op << 13) | n written
// backwards from maxr - 1.
//
// Design. One block per problem, one thread per diagonal lane (blockDim =
// K). The forward sweep reads M at lags x, o1+e1, o2+e2 and each gap state
// at lag e1 or e2, never deeper, so it keeps a ring of the last
// Rm = max(x, o1+e1, o2+e2) + 1 M rows and Rg = max(e1, e2) + 1 rows of each
// gap state, int16, in dynamic shared memory ((2 * Rm + 8 * Rg) bytes a
// lane, 76 with the default penalties, and two dead columns) and reads
// only that ring: no global load is on a level's critical path. The full
// history, (5, smax, K) int16 per problem in global scratch, is written by
// the sweep and read by the backtrace alone. Reads at k +- 1 are reads of ring rows
// stored at earlier levels, the row written at level s is read at no lag
// of level s, and the row of the deepest lag is rewritten only at level
// s + 1: one __syncthreads() per level orders them. The accepted cell
// (smallest accepting lane) comes from an atomicMin over a packed (lane,
// offset) key in shared memory, triple-buffered by level so that a single
// barrier per level suffices. Each problem stops at its own finish or cap
// (the TPU kernel swept a group of problems in lockstep).
//
// The sequences stay packed, two 4-bit codes a byte, in shared memory, so
// the eq bitstreams are never built. Match extension compares eight codes a
// step through unaligned 32-bit windows at nibble granularity (two aligned
// shared-memory words and a funnel shift). Both rows are followed by pad
// codes (query 14, target 15) that match nothing of the other row.
//
// Warp 0 then runs the backtrace over global history: a step's five
// candidates are loaded by five lanes at once and combined by shuffle, and
// the lanes left load the next five steps' candidates on the guess that
// the steps are mismatches, so a run of mismatch steps costs one round
// trip to L2. All threads then compact the runs into the int16 readback
// row. blockDim = K must be a multiple of 32.
//
// What bounds it on this card: instruction issue. Several blocks share
// an SM, so one block's barrier and shared-memory latency hide behind the
// others' work; the backtrace is a tenth of a block's lifetime, a serial
// chain on one warp that issues between the other blocks' sweeps. Not
// bytes moved.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int16_t NEG16 = -2048;
constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_SENTINEL = 15;
constexpr int RUNS_CAP = 128;
constexpr int NTERM = 16;
constexpr int M_ = 0, I1_ = 1, I2_ = 2, D1_ = 3, D2_ = 4;
constexpr int BT_CHAIN = 6;  // backtrace steps loaded at once (5 lanes each)

struct Pen {
  int x, o1, e1, o2, e2;
};

// One problem's history, hist[state][level][lane], as the backtrace reads
// it (the sweep stores through a pointer it steps itself).
struct Hist {
  int16_t* base;
  int smax, K;

  __device__ int get(int st, int s, int lane) const {
    if (s < 0 || lane < 0 || lane >= K) return NEG;
    const int16_t v = base[((size_t)st * smax + s) * K + lane];
    return v == NEG16 ? NEG : (int)v;
  }
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// 32-bit words of one packed sequence row in shared memory: L / 2 bytes
// rounded up to words, and one word of pad codes for the last window.
__host__ __device__ inline int seq_words(int L) { return (L / 2 + 3) / 4 + 1; }

struct RingDepth {
  int Rm, Rg;
};

__host__ __device__ inline RingDepth ring_depth(const Pen& p) {
  int rm = p.x > p.o1 + p.e1 ? p.x : p.o1 + p.e1;
  rm = rm > p.o2 + p.e2 ? rm : p.o2 + p.e2;
  return RingDepth{rm + 1, (p.e1 > p.e2 ? p.e1 : p.e2) + 1};
}

// Eight codes of packed row `w` (aligned 32-bit words, low nibble first)
// starting at code position `pos`.
__device__ __forceinline__ uint32_t window(const uint32_t* w, int pos) {
  const int i = pos >> 3;
  return __funnelshift_r(w[i], w[i + 1], (pos & 7) << 2);
}

// Extend offset h along diagonal kv while query and target codes agree,
// eight codes a step. Positions outside [0, L) never match; the placement
// pads (query 14, target 15) never match each other, so a run stops at the
// placed ends. The rows are padded by at least one word past L, so the
// windows stay inside them.
__device__ __forceinline__ int extend(int h, int kv, const uint32_t* qw,
                                      const uint32_t* tw, int L, int qlen,
                                      int tlen) {
  if (h < 0) return h;  // none
  int v = h - kv;
  const int room = L - (h > v ? h : v);
  if (h >= 0 && v >= 0 && room > 0) {
    int run = 0;
    while (run < room) {
      const uint32_t x = window(qw, h + run) ^ window(tw, v + run);
      if (x) {
        run += (__ffs((int)x) - 1) >> 2;
        break;
      }
      run += 8;
    }
    run = run < room ? run : room;
    h += run;
    v += run;
  }
  const int over = imax(imax(h - qlen, v - tlen), 0);
  return h - over;
}

// Ring row of the level `lag` below the one in row `slot` (lag < depth).
__device__ __forceinline__ int back(int slot, int lag, int depth) {
  const int r = slot - lag;
  return r < 0 ? r + depth : r;
}

// wfa_np.is_done: the query end with the target tail inside its free span,
// or the target end with the query tail inside its free span.
__device__ bool accepts(int m, int kv, int qlen, int tlen, int te, int qe) {
  if (m < 0) return false;  // none
  const int v = m - kv;
  const bool c1 = m == qlen && tlen - v <= te && v >= 0;
  const bool c2 = v == tlen && qlen - m <= qe && m >= 0;
  return c1 || c2;
}

__device__ int load_le32(const uint8_t* p) {
  return (int)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
               ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

// Append run (op, n) backwards at *cur, merged with the entry written last.
// *last is that entry, runs[*cur + 1], kept in a register so that a merge
// does not wait for a load of what this thread has just stored.
__device__ void emit(int32_t* runs, int maxr, int* cur, int* last, int op,
                     int n) {
  if (n <= 0) return;
  const int p = *cur + 1;
  if (p >= 0 && p < maxr && (*last >> 13) == op) {
    *last += n;
    runs[p] = *last;
    return;
  }
  if (*cur >= 0 && *cur < maxr) {
    *last = (op << 13) | n;
    runs[*cur] = *last;
  }
  *cur -= 1;
}

__global__ void __launch_bounds__(1024)
seg_wfa_kernel(const uint8_t* __restrict__ buf, int L, int K, int smax,
               int maxr, int cap_runs, Pen p, int16_t* __restrict__ hist,
               int32_t* __restrict__ runs_full, int16_t* __restrict__ out16) {
  // packed query row, packed target row (seq_words words each), M ring,
  // gap rings
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int key[3];   // accepted (lane << 16) | offset, INT_MAX = none
  __shared__ int edge[3];  // band-edge contact at this level
  __shared__ int s_cur;

  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const int Lh = L / 2;
  const int nw = seq_words(L);
  uint8_t* q8 = smem;
  uint8_t* t8 = smem + 4 * nw;
  const uint32_t* qw = (const uint32_t*)q8;
  const uint32_t* tw = (const uint32_t*)t8;
  // The rings: rows of KW = K + 2 int16 cells, lane l in column l + 1. The
  // two outer columns and every row no level has written yet hold "none",
  // so a read at k - 1 or k + 1, or of a level before 0, needs no test.
  // In the rings and in the sweep's registers "none" is NEG16 itself: an
  // offset is never negative, so cells load and store without conversion.
  const RingDepth rd = ring_depth(p);
  const int KW = K + 2;
  int16_t* ring_m = (int16_t*)(smem + 8 * nw);  // (Rm, KW)
  int16_t* ring_g = ring_m + rd.Rm * KW;        // (4, Rg, KW): I1 I2 D1 D2
  for (int i = l; i < (rd.Rm + 4 * rd.Rg) * KW; i += K) ring_m[i] = NEG16;
  const uint8_t* row = buf + (size_t)b * (L + 64);
  for (int i = l; i < 4 * nw; i += K) {
    q8[i] = i < Lh ? row[i] : 0xEE;        // pad code 14
    t8[i] = i < Lh ? row[Lh + i] : 0xFF;   // pad code 15
  }
  // par: 0 Qk = S + qlen, 1 Tk = P + tlen, 2 S, 3 c = S - P, 4 tb, 5 qb,
  // 6 te, 7 qe, 8 score cap (0 = none)
  const uint8_t* pr = row + L;
  const int qlen = load_le32(pr + 0), tlen = load_le32(pr + 4);
  const int S = load_le32(pr + 8), c = load_le32(pr + 12);
  const int tb = load_le32(pr + 16), qb = load_le32(pr + 20);
  const int te = load_le32(pr + 24), qe = load_le32(pr + 28);
  const int cap = load_le32(pr + 32);
  if (l < 3) {
    key[l] = INT_MAX;
    edge[l] = 0;
  }
  __syncthreads();

  const Hist H{hist + (size_t)b * 5 * smax * K, smax, K};
  const int kv = l - K / 2;

  // ---- level 0: seeds on the begin-free diagonals, then extension ----
  constexpr int NONE = NEG16;
  const int ktrue = kv - c;
  int seed = (ktrue <= 0 && -ktrue <= tb) ? S : NONE;
  if (ktrue > 0 && ktrue <= qb) seed = S + ktrue;
  const int m0 = extend(seed, kv, qw, tw, L, qlen, tlen);
  // this lane's history cell of state st at level s is hcell[st * hstate]
  const size_t hstate = (size_t)smax * K;
  int16_t* hcell = H.base + l;
  hcell[0] = (int16_t)m0;
  for (int st = I1_; st <= D2_; ++st) hcell[st * hstate] = NEG16;
  const int col = l + 1;
  ring_m[col] = (int16_t)m0;
  if (accepts(m0, kv, qlen, tlen, te, qe)) atomicMin(&key[0], (l << 16) | m0);
  __syncthreads();

  bool done = key[0] != INT_MAX;
  int s_final = 0, lane_a = 0, h_a = 0, edge_f = 0, levels = 1;
  if (done) {
    lane_a = key[0] >> 16;
    h_a = key[0] & 0xFFFF;
  }

  // ---- forward sweep over the ring: one barrier per level ----------------
  const int lag_o1 = p.o1 + p.e1, lag_o2 = p.o2 + p.e2;
  const int gstate = rd.Rg * KW;  // cells of one gap state's ring
  int slot_m = 0, slot_g = 0;     // ring rows of level s
  for (int s = 1; !done && s < smax; ++s) {
    const int slot = s % 3;
    if (l == 0) {  // slot (s+1)%3 was last read before the previous barrier
      key[(s + 1) % 3] = INT_MAX;
      edge[(s + 1) % 3] = 0;
    }
    slot_m = slot_m + 1 == rd.Rm ? 0 : slot_m + 1;
    slot_g = slot_g + 1 == rd.Rg ? 0 : slot_g + 1;
    const int16_t* m_x_row = ring_m + back(slot_m, p.x, rd.Rm) * KW + col;
    const int16_t* m_o1 = ring_m + back(slot_m, lag_o1, rd.Rm) * KW + col;
    const int16_t* m_o2 = ring_m + back(slot_m, lag_o2, rd.Rm) * KW + col;
    const int16_t* g_e1 = ring_g + back(slot_g, p.e1, rd.Rg) * KW + col;
    const int16_t* g_e2 = ring_g + back(slot_g, p.e2, rd.Rg) * KW + col;
    const int m_x = m_x_row[0];
    const int i1b = imax(m_o1[-1], g_e1[-1]);
    const int i2b = imax(m_o2[-1], g_e2[gstate - 1]);
    const int i1 = i1b > NONE ? i1b + 1 : NONE;
    const int i2 = i2b > NONE ? i2b + 1 : NONE;
    const int d1 = imax(m_o1[1], g_e1[2 * gstate + 1]);
    const int d2 = imax(m_o2[1], g_e2[3 * gstate + 1]);
    const int mm = m_x > NONE ? m_x + 1 : NONE;
    int m_off = imax(imax(imax(mm, i1), imax(i2, d1)), d2);
    const int v = m_off - kv;
    if (!(m_off >= 0 && m_off <= qlen && v >= 0 && v <= tlen)) m_off = NONE;
    const int m_ext = extend(m_off, kv, qw, tw, L, qlen, tlen);
    // the ring for the next levels, the history for the backtrace
    int16_t* g_new = ring_g + slot_g * KW + col;
    ring_m[slot_m * KW + col] = (int16_t)m_ext;
    g_new[0] = (int16_t)i1;
    g_new[gstate] = (int16_t)i2;
    g_new[2 * gstate] = (int16_t)d1;
    g_new[3 * gstate] = (int16_t)d2;
    hcell += K;
    hcell[0] = (int16_t)m_ext;
    hcell[hstate] = (int16_t)i1;
    hcell[2 * hstate] = (int16_t)i2;
    hcell[3 * hstate] = (int16_t)d1;
    hcell[4 * hstate] = (int16_t)d2;
    if ((l == 0 || l == K - 1) && m_ext >= 0) edge[slot] = 1;
    if (accepts(m_ext, kv, qlen, tlen, te, qe))
      atomicMin(&key[slot], (l << 16) | m_ext);
    __syncthreads();
    // every thread reads the same shared values: the branch is uniform
    edge_f |= edge[slot];
    levels = s + 1;
    const int k_acc = key[slot];
    if (k_acc != INT_MAX) {
      done = true;
      s_final = s;
      lane_a = k_acc >> 16;
      h_a = k_acc & 0xFFFF;
    } else if (cap > 0 && s >= cap) {
      break;
    }
  }

  // ---- backtrace (warp 0) over global history ---------------------------
  // Every lane of the warp keeps the same state and takes the same
  // branches; lane 0 alone writes runs. A step's five candidates are
  // loaded by five lanes at once, and BT_CHAIN steps ahead with them, each
  // on the guess that the steps before it are mismatches (same lane, x
  // levels down): a run of mismatch steps costs one round trip to the
  // history instead of one a step.
  int32_t* runs = runs_full + (size_t)b * maxr;
  for (int i = l; i < maxr; i += K) runs[i] = OP_SENTINEL << 13;
  __syncthreads();
  int16_t* orow = out16 + (size_t)b * (NTERM + cap_runs);
  int cur = maxr - 1;  // meaningful in thread 0
  int last = OP_SENTINEL << 13;
  int clean = 1;
  if (l < 32 && done) {
    constexpr unsigned FULL = 0xFFFFFFFFu;
    const bool w0 = l == 0;
    int bts = s_final, btk = lane_a, bth = h_a, btst = M_;
    bool act = true;
    // trailing free gap: the accepted cell may sit short of the corner
    const int v_acc = bth - (btk - K / 2);
    if (w0) {
      if (bth == qlen && v_acc < tlen)
        emit(runs, maxr, &cur, &last, OP_D, tlen - v_acc);
      else if (v_acc == tlen && bth < qlen)
        emit(runs, maxr, &cur, &last, OP_I, qlen - bth);
    }
    while (act && bts >= 0) {
      if (btst == M_) {
        const int s = bts;
        if (s == 0) {
          // leading extension down to the seed, then the free begin gap
          const int kt_s = (btk - K / 2) - c;
          if (w0) {
            emit(runs, maxr, &cur, &last, OP_EQ, bth - S - imax(kt_s, 0));
            if (kt_s < 0) emit(runs, maxr, &cur, &last, OP_D, -kt_s);
            if (kt_s > 0) emit(runs, maxr, &cur, &last, OP_I, kt_s);
          }
          act = false;
          break;
        }
        // lane 5 * j + cand loads candidate cand (X, I1, I2, D1, D2) of
        // the step at level s - j * x
        const int j = l / 5, cand = l - 5 * j;
        const int sj = s - j * p.x;
        int val = NEG;
        if (j < BT_CHAIN && sj >= 1) {
          if (cand == 0) {
            val = H.get(M_, sj - p.x, btk);
            val = val > NEG ? val + 1 : NEG;
          } else {
            val = H.get(cand, sj, btk);
          }
        }
        bool to_gap = false;
        for (int jj = 0; jj < BT_CHAIN && bts >= 1; ++jj) {
          const int cx = __shfl_sync(FULL, val, 5 * jj);
          const int ci1 = __shfl_sync(FULL, val, 5 * jj + 1);
          const int ci2 = __shfl_sync(FULL, val, 5 * jj + 2);
          const int cd1 = __shfl_sync(FULL, val, 5 * jj + 3);
          const int cd2 = __shfl_sync(FULL, val, 5 * jj + 4);
          const int pre = imax(imax(imax(cx, ci1), imax(ci2, cd1)), cd2);
          if (pre <= NEG) {
            act = false;
            clean = 0;
            break;
          }
          if (w0) emit(runs, maxr, &cur, &last, OP_EQ, bth - pre);
          // priority X > I1 > I2 > D1 > D2
          if (cx == pre) {
            if (w0) emit(runs, maxr, &cur, &last, OP_X, 1);
            bts -= p.x;
            bth = pre - 1;
            continue;
          }
          bth = pre;
          btst = ci1 == pre ? I1_ : ci2 == pre ? I2_ : cd1 == pre ? D1_ : D2_;
          to_gap = true;
          break;
        }
        if (!to_gap) continue;
      }
      // gap state at level s: open before extend
      const int s = bts;
      const bool ins = btst == I1_ || btst == I2_;
      const bool one = btst == I1_ || btst == D1_;
      const int o_ = one ? p.o1 : p.o2, e_ = one ? p.e1 : p.e2;
      const int kd = btk + (ins ? -1 : 1);
      int src = NEG;  // lane 0: the gap-open source, lane 1: the extension's
      if (l == 0) src = H.get(M_, s - o_ - e_, kd);
      if (l == 1) src = H.get(btst, s - e_, kd);
      const int open_ = __shfl_sync(FULL, src, 0);
      const int ext = __shfl_sync(FULL, src, 1);
      const int want = ins ? bth - 1 : bth;
      if (w0) emit(runs, maxr, &cur, &last, ins ? OP_I : OP_D, 1);
      if (open_ > NEG && open_ == want) {
        bts = s - o_ - e_;
        btst = M_;
      } else if (ext > NEG && ext == want) {
        bts = s - e_;
      } else {
        act = false;
        clean = 0;
        break;
      }
      if (ins) bth -= 1;
      btk = kd;
    }
    if (act) clean = 0;
  }
  if (l == 0) {
    orow[0] = done ? 1 : 0;
    orow[1] = done ? s_final : 0;
    orow[2] = done ? 0 : 1;
    orow[3] = edge_f;
    orow[4] = cur;
    orow[5] = clean;
    orow[6] = done ? lane_a : 0;
    orow[7] = done ? h_a : 0;
    orow[8] = levels;  // swept levels of THIS problem
    for (int j = 9; j < NTERM; ++j) orow[j] = 0;
    s_cur = cur;
  }
  __syncthreads();

  // ---- compact the used runs to cap_runs int16 entries -------------------
  const int first = s_cur + 1;
  for (int j = l; j < cap_runs; j += K) {
    int idx = first + j;
    idx = idx < maxr - 1 ? idx : maxr - 1;
    idx = idx > 0 ? idx : 0;
    orow[NTERM + j] = (int16_t)runs[idx];
  }
}

}  // namespace

extern "C" {

// buf (B, L + 64) u8 chunk rows; hist (B, 5, smax, K) i16 scratch;
// runs_full (B, maxr) i32; out16 (B, 16 + min(maxr, 128)) i16. Launches on
// `stream` and returns the first CUDA error of the launch.
int seg_wfa_launch(const void* buf, int B, int L, int K, int smax, int maxr,
                   int x, int o1, int e1, int o2, int e2, void* hist,
                   void* runs_full, void* out16, void* stream) {
  if (B <= 0) return 0;
  const Pen p{x, o1, e1, o2, e2};
  const int cap_runs = maxr < RUNS_CAP ? maxr : RUNS_CAP;
  const RingDepth rd = ring_depth(p);
  // two packed sequence rows, then the lag rings
  const int smem = 8 * seq_words(L) + 2 * (K + 2) * (rd.Rm + 4 * rd.Rg);
  const cudaError_t err = cudaFuncSetAttribute(
      seg_wfa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  seg_wfa_kernel<<<B, K, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, L, K, smax, maxr, cap_runs, p, (int16_t*)hist,
      (int32_t*)runs_full, (int16_t*)out16);
  return (int)cudaGetLastError();
}

const char* seg_wfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
