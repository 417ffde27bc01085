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
// Design. One CTA per problem, one thread per diagonal lane (blockDim = K).
// Sequences are unpacked from their nibbles into shared memory and match
// extension compares codes directly, so the eq bitstreams are never built.
// History lives in global scratch, (5, smax, K) int16 per problem: only the
// smallest tier would fit shared memory. Reads at k +- 1 are reads of rows
// stored at earlier levels; one __syncthreads() per level orders them. The
// accepted cell (smallest accepting lane) comes from an atomicMin over a
// packed (lane, offset) key in shared memory, triple-buffered by level so
// that a single barrier per level suffices. Each problem stops at its own
// finish or cap (the TPU kernel swept a group of problems in lockstep).
// Thread 0 then runs the backtrace over global history and all threads
// compact the runs into the int16 readback row.
//
// What bounds it on this card: the per-level barrier and the divergent,
// byte-serial extension loops, not bytes moved (history traffic is a few
// int16 reads per lane per level and stays mostly in L2). Warp-level lanes,
// shared-memory history for the small tier and persistent CTAs are the
// later work that addresses that.

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

struct Pen {
  int x, o1, e1, o2, e2;
};

// One problem's history: hist[state][level][lane].
struct Hist {
  int16_t* base;
  int smax, K;

  __device__ int get(int st, int s, int lane) const {
    if (s < 0 || lane < 0 || lane >= K) return NEG;
    const int16_t v = base[((size_t)st * smax + s) * K + lane];
    return v == NEG16 ? NEG : (int)v;
  }
  __device__ void put(int st, int s, int lane, int v) const {
    base[((size_t)st * smax + s) * K + lane] =
        v <= NEG / 2 ? NEG16 : (int16_t)v;
  }
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Extend offset h along diagonal kv while query and target codes agree.
// Positions outside [0, L) never match; the placement pads (query 14,
// target 15) never match each other, so a run stops at the placed ends.
__device__ int extend(int h, int kv, const uint8_t* q, const uint8_t* t,
                      int L, int qlen, int tlen) {
  if (h <= NEG) return h;
  int v = h - kv;
  while (h >= 0 && h < L && v >= 0 && v < L && q[h] == t[v]) {
    ++h;
    ++v;
  }
  const int over = imax(imax(h - qlen, v - tlen), 0);
  return h - over;
}

// wfa_np.is_done: the query end with the target tail inside its free span,
// or the target end with the query tail inside its free span.
__device__ bool accepts(int m, int kv, int qlen, int tlen, int te, int qe) {
  if (m <= NEG) return false;
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
__device__ void emit(int32_t* runs, int maxr, int* cur, int op, int n) {
  if (n <= 0) return;
  const int p = *cur + 1;
  if (p >= 0 && p < maxr && (runs[p] >> 13) == op) {
    runs[p] += n;
    return;
  }
  if (*cur >= 0 && *cur < maxr) runs[*cur] = (op << 13) | n;
  *cur -= 1;
}

__global__ void __launch_bounds__(1024)
seg_wfa_kernel(const uint8_t* __restrict__ buf, int L, int K, int smax,
               int maxr, int cap_runs, Pen p, int16_t* __restrict__ hist,
               int32_t* __restrict__ runs_full, int16_t* __restrict__ out16) {
  extern __shared__ uint8_t seqs[];
  uint8_t* q = seqs;
  uint8_t* t = seqs + L;
  __shared__ int key[3];   // accepted (lane << 16) | offset, INT_MAX = none
  __shared__ int edge[3];  // band-edge contact at this level
  __shared__ int s_cur;

  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const int Lh = L / 2;
  const uint8_t* row = buf + (size_t)b * (L + 64);
  for (int i = l; i < Lh; i += K) {
    const uint8_t a = row[i];
    const uint8_t c = row[Lh + i];
    q[2 * i] = a & 15;
    q[2 * i + 1] = a >> 4;
    t[2 * i] = c & 15;
    t[2 * i + 1] = c >> 4;
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
  const int ktrue = kv - c;
  int seed = (ktrue <= 0 && -ktrue <= tb) ? S : NEG;
  if (ktrue > 0 && ktrue <= qb) seed = S + ktrue;
  const int m0 = extend(seed, kv, q, t, L, qlen, tlen);
  H.put(M_, 0, l, m0);
  H.put(I1_, 0, l, NEG);
  H.put(I2_, 0, l, NEG);
  H.put(D1_, 0, l, NEG);
  H.put(D2_, 0, l, NEG);
  if (accepts(m0, kv, qlen, tlen, te, qe)) atomicMin(&key[0], (l << 16) | m0);
  __syncthreads();

  bool done = key[0] != INT_MAX;
  int s_final = 0, lane_a = 0, h_a = 0, edge_f = 0, levels = 1;
  if (done) {
    lane_a = key[0] >> 16;
    h_a = key[0] & 0xFFFF;
  }

  // ---- forward sweep: one barrier per level -----------------------------
  for (int s = 1; !done && s < smax; ++s) {
    const int slot = s % 3;
    if (l == 0) {  // slot (s+1)%3 was last read before the previous barrier
      key[(s + 1) % 3] = INT_MAX;
      edge[(s + 1) % 3] = 0;
    }
    const int m_x = H.get(M_, s - p.x, l);
    const int m_o1 = s - p.o1 - p.e1, m_o2 = s - p.o2 - p.e2;
    const int i1b = imax(H.get(M_, m_o1, l - 1), H.get(I1_, s - p.e1, l - 1));
    const int i2b = imax(H.get(M_, m_o2, l - 1), H.get(I2_, s - p.e2, l - 1));
    const int i1 = i1b > NEG ? i1b + 1 : NEG;
    const int i2 = i2b > NEG ? i2b + 1 : NEG;
    const int d1 = imax(H.get(M_, m_o1, l + 1), H.get(D1_, s - p.e1, l + 1));
    const int d2 = imax(H.get(M_, m_o2, l + 1), H.get(D2_, s - p.e2, l + 1));
    const int mm = m_x > NEG ? m_x + 1 : NEG;
    int m_off = imax(imax(imax(mm, i1), imax(i2, d1)), d2);
    const int v = m_off - kv;
    if (!(m_off >= 0 && m_off <= qlen && v >= 0 && v <= tlen)) m_off = NEG;
    const int m_ext = extend(m_off, kv, q, t, L, qlen, tlen);
    H.put(M_, s, l, m_ext);
    H.put(I1_, s, l, i1);
    H.put(I2_, s, l, i2);
    H.put(D1_, s, l, d1);
    H.put(D2_, s, l, d2);
    if ((l == 0 || l == K - 1) && m_ext > NEG) edge[slot] = 1;
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

  // ---- backtrace (thread 0) over global history --------------------------
  int32_t* runs = runs_full + (size_t)b * maxr;
  for (int i = l; i < maxr; i += K) runs[i] = OP_SENTINEL << 13;
  __syncthreads();
  int16_t* orow = out16 + (size_t)b * (NTERM + cap_runs);
  if (l == 0) {
    int cur = maxr - 1;
    int clean = 1;
    if (done) {
      int bts = s_final, btk = lane_a, bth = h_a, btst = M_;
      bool act = true;
      // trailing free gap: the accepted cell may sit short of the corner
      const int v_acc = bth - (btk - K / 2);
      if (bth == qlen && v_acc < tlen)
        emit(runs, maxr, &cur, OP_D, tlen - v_acc);
      else if (v_acc == tlen && bth < qlen)
        emit(runs, maxr, &cur, OP_I, qlen - bth);
      while (act && bts >= 0) {
        const int s = bts;
        if (btst == M_) {
          if (s == 0) {
            // leading extension down to the seed, then the free begin gap
            const int kt_s = (btk - K / 2) - c;
            emit(runs, maxr, &cur, OP_EQ, bth - S - imax(kt_s, 0));
            if (kt_s < 0) emit(runs, maxr, &cur, OP_D, -kt_s);
            if (kt_s > 0) emit(runs, maxr, &cur, OP_I, kt_s);
            act = false;
            break;
          }
          int cx = H.get(M_, s - p.x, btk);
          cx = cx > NEG ? cx + 1 : NEG;
          const int ci1 = H.get(I1_, s, btk), ci2 = H.get(I2_, s, btk);
          const int cd1 = H.get(D1_, s, btk), cd2 = H.get(D2_, s, btk);
          const int pre = imax(imax(imax(cx, ci1), imax(ci2, cd1)), cd2);
          if (pre <= NEG) {
            act = false;
            clean = 0;
            break;
          }
          emit(runs, maxr, &cur, OP_EQ, bth - pre);
          // priority X > I1 > I2 > D1 > D2
          if (cx == pre) {
            emit(runs, maxr, &cur, OP_X, 1);
            bts = s - p.x;
            bth = pre - 1;
            continue;
          }
          bth = pre;
          btst = ci1 == pre ? I1_ : ci2 == pre ? I2_ : cd1 == pre ? D1_ : D2_;
        }
        // gap state at level s: open before extend
        const bool ins = btst == I1_ || btst == I2_;
        const bool one = btst == I1_ || btst == D1_;
        const int o_ = one ? p.o1 : p.o2, e_ = one ? p.e1 : p.e2;
        const int kd = btk + (ins ? -1 : 1);
        const int open_ = H.get(M_, s - o_ - e_, kd);
        const int ext = H.get(btst, s - e_, kd);
        const int want = ins ? bth - 1 : bth;
        emit(runs, maxr, &cur, ins ? OP_I : OP_D, 1);
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
  const int cur = s_cur;
  for (int j = l; j < cap_runs; j += K) {
    int idx = cur + 1 + j;
    idx = idx < maxr - 1 ? idx : maxr - 1;
    idx = idx > 0 ? idx : 0;
    orow[NTERM + j] = (int16_t)runs[idx];
  }
}

}  // namespace

extern "C" {

// buf (B, L + 64) u8 chunk rows; hist (B, 5, smax, K) i16 scratch;
// runs_full (B, maxr) i32; out16 (B, 16 + min(maxr, 128)) i16. Launches on
// `stream` and returns cudaGetLastError() of the launch.
int seg_wfa_launch(const void* buf, int B, int L, int K, int smax, int maxr,
                   int x, int o1, int e1, int o2, int e2, void* hist,
                   void* runs_full, void* out16, void* stream) {
  if (B <= 0) return 0;
  const Pen p{x, o1, e1, o2, e2};
  const int cap_runs = maxr < RUNS_CAP ? maxr : RUNS_CAP;
  seg_wfa_kernel<<<B, K, 2 * L, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, L, K, smax, maxr, cap_runs, p, (int16_t*)hist,
      (int32_t*)runs_full, (int16_t*)out16);
  return (int)cudaGetLastError();
}

const char* seg_wfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
