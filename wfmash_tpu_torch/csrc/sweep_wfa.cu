// Exact crossing-payload WFA sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel wfmash_tpu/align/wfa_pallas.py::_make_kernel and
// the chunked relaunch loop of PallasSweeps.sweep around it. It computes
// the same function: for a batch of end-to-end problems, the score-serial
// 2-piece gap-affine wavefront recursion over the five states M, I1, I2,
// D1, D2, banded to K diagonals, keeping only a ring of the last score
// levels. Every wavefront cell carries the packed cell (v << 16) | h at
// which its path crossed the problem's split line (row v == mid or column
// h == mid); a crossing inside a gap run is pinned to the run's gap-open
// cell. Per problem it returns the finish score, the anchor on the end
// diagonal, whether it finished, whether a live cell touched the band
// edge, the number of levels swept and the number of wavefront lanes those
// levels computed.
//
// Design. One CTA per problem, lanes (diagonals) strided over up to 1024
// threads. The rings live in global scratch, per problem
//   off_m, anc_m            (Rm, K)      Rm = max(x, o1+e1, o2+e2) + 1
//   off_g, anc_g, open_g    (4, Rg, K)   Rg = max(e1, e2) + 1
// because they do not fit shared memory at the wide spans (K = 4096: the M
// ring alone is 832 KiB); a problem's rings are under 1.5 MiB and stay in
// L2. The kernel fills its rings itself (scratch comes dirty from the
// caching allocator) and seeds slot 0. Reads at k - 1 and k + 1 are reads
// of slots stored at earlier levels; the slot written at level s is read at
// no lag of level s, and the slot of the deepest lag is rewritten only at
// level s + 1, so one barrier per level orders everything. That barrier is
// __syncthreads_or over "the end diagonal finished", which also tells every
// thread to stop. Only lanes the wavefront can have reached are computed:
// it widens by one lane a side per level from the seeded lanes.
//
// Match extension compares the padded sequence bytes themselves, four at a
// time through unaligned 32-bit windows (two aligned loads and a funnel
// shift), bounded by the true lengths: no 4-bit codes, no eq-bit cache, no
// one-hot matmul fetch as on the TPU.
//
// Each problem stops at its own finish (the TPU kernel stepped a group of
// problems while any was alive), so `clipped` means "touched the band edge
// at or before its finish", and a problem unfinished after level max_s
// reports finished = 0.
//
// What bounds it on this card: ring traffic. A lane loads 22 ring words and
// stores 14 per level; at K = 4096 a batch of 128 problems holds 184 MB of
// rings, more than the 50 MB L2, so a level costs about 20 us against
// about 2.3 us at K = 256 (chip_smoke.py's sweep phase on one NVIDIA H100
// 80GB HBM3 at 700 W), where the barrier and the chain of dependent L2
// round trips are what is left. Shared-memory rings for K <= 512, narrower
// ring words and several problems per CTA are the later work that
// addresses that.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr uint32_t UNS = 0xFFFFFFFFu;
constexpr int NPAR = 8;    // qlen, tlen, axis_is_query, mid, done0, 0, 0, 0
// finished, score, anchor, clipped, levels, lanes (low 31 bits), lanes >> 31, 0
constexpr int NTERM = 8;
constexpr int MAX_THREADS = 1024;

struct Pen {
  int x, o1, e1, o2, e2, Rm, Rg;
};

struct Gap {
  int off;
  uint32_t anc;
  int open;
};

__device__ __forceinline__ uint32_t pack(int v, int h) {
  return ((uint32_t)v << 16) | ((uint32_t)h & 0xFFFFu);
}

// One problem's rings in global scratch.
struct Rings {
  int* off_m;
  uint32_t* anc_m;
  int* off_g;
  uint32_t* anc_g;
  int* open_g;
  int K, Rm, Rg;

  __device__ void land_m(int s, int lane, int& w, uint32_t& a) const {
    if (s < 0 || lane < 0 || lane >= K) {
      w = NEG;
      a = UNS;
      return;
    }
    const size_t i = (size_t)(s % Rm) * K + lane;
    w = off_m[i];
    a = anc_m[i];
  }
  __device__ void land_g(int g, int s, int lane, int& w, uint32_t& a,
                         int& o) const {
    if (s < 0 || lane < 0 || lane >= K) {
      w = NEG;
      a = UNS;
      o = -1;
      return;
    }
    const size_t i = ((size_t)g * Rg + s % Rg) * K + lane;
    w = off_g[i];
    a = anc_g[i];
    o = open_g[i];
  }
  __device__ void put_m(int s, int lane, int w, uint32_t a) const {
    const size_t i = (size_t)(s % Rm) * K + lane;
    off_m[i] = w;
    anc_m[i] = a;
  }
  __device__ void put_g(int g, int s, int lane, const Gap& c) const {
    const size_t i = ((size_t)g * Rg + s % Rg) * K + lane;
    off_g[i] = c.off;
    anc_g[i] = c.anc;
    open_g[i] = c.open;
  }
};

// One gap state's new cell on diagonal kv from the M source (gap open) and
// the same gap state's source (gap extend), both already taken from lane
// k - 1 (insertion) or k + 1 (deletion). A tie goes to open.
template <bool INS>
__device__ __forceinline__ Gap gap_wave(int m_s, uint32_t am_s, int g_s,
                                        uint32_t ag_s, int go_s, int kv,
                                        bool axis_q, int mid) {
  const bool use_open = m_s >= g_s;
  const int base = use_open ? m_s : g_s;
  const bool valid = base > NEG;
  Gap r;
  r.off = valid ? base + (INS ? 1 : 0) : NEG;
  r.anc = use_open ? am_s : ag_s;
  // gap-open anchor: h of the M cell for I, v of the M cell for D
  const int opened = INS ? m_s : m_s - (kv + 1);
  r.open = valid ? (use_open ? opened : go_s) : -1;
  if (INS) {
    if (axis_q && r.anc == UNS && valid && r.off == mid + 1)
      r.anc = pack(r.off - kv, r.open);
  } else {
    if (!axis_q && r.anc == UNS && valid && r.off - kv == mid + 1)
      r.anc = pack(r.open, r.off);
  }
  return r;
}

// Four bytes of row `w` (as aligned 32-bit words) starting at byte `pos`.
__device__ __forceinline__ uint32_t window(const uint32_t* w, int pos) {
  const int i = pos >> 2;
  return __funnelshift_r(w[i], w[i + 1], (pos & 3) << 3);
}

// Advance offset h on diagonal kv while query[h] == target[h - kv], never
// past either true length. Rows are padded by at least 8 bytes beyond the
// lengths, so the windows stay inside the row.
__device__ __forceinline__ int extend(const uint32_t* qw, const uint32_t* tw,
                                      int h, int kv, int qlen, int tlen) {
  int v = h - kv;
  const int room_q = qlen - h, room_t = tlen - v;
  const int room = room_q < room_t ? room_q : room_t;
  int run = 0;
  while (run < room) {
    const uint32_t x = window(qw, h + run) ^ window(tw, v + run);
    if (x) {
      run += (__ffs((int)x) - 1) >> 3;
      break;
    }
    run += 4;
  }
  return h + (run < room ? run : room);
}

__global__ void __launch_bounds__(MAX_THREADS)
sweep_wfa_kernel(const uint8_t* __restrict__ query,
                 const uint8_t* __restrict__ target, int L,
                 const int* __restrict__ par,
                 const int* __restrict__ seed_off,
                 const uint32_t* __restrict__ seed_anc, int K, int max_s,
                 Pen p, int* scratch, int* term) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int* pr = par + (size_t)b * NPAR;
  int* tr = term + (size_t)b * NTERM;
  const int qlen = pr[0], tlen = pr[1];
  const bool axis_q = pr[2] != 0;
  const int mid = pr[3];
  if (pr[4]) {  // solved before the sweep: nothing to do
    if (tid < NTERM) tr[tid] = 0;
    return;
  }

  const size_t nm = (size_t)p.Rm * K, ng = (size_t)4 * p.Rg * K;
  int* base = scratch + (size_t)b * (2 * nm + 3 * ng);
  Rings r;
  r.off_m = base;
  r.anc_m = (uint32_t*)(base + nm);
  r.off_g = base + 2 * nm;
  r.anc_g = (uint32_t*)(base + 2 * nm + ng);
  r.open_g = base + 2 * nm + 2 * ng;
  r.K = K;
  r.Rm = p.Rm;
  r.Rg = p.Rg;

  __shared__ int s_lo, s_hi, s_edge;
  if (tid == 0) {
    s_lo = K;
    s_hi = -1;
    s_edge = 0;
  }
  __syncthreads();

  // ---- fill the rings, seed slot 0, find the seeded lanes -----------------
  for (size_t i = tid; i < nm; i += T) {
    r.off_m[i] = NEG;
    r.anc_m[i] = UNS;
  }
  for (size_t i = tid; i < ng; i += T) {
    r.off_g[i] = NEG;
    r.anc_g[i] = UNS;
    r.open_g[i] = -1;
  }
  int lo = K, hi = -1;
  for (int k = tid; k < K; k += T) {
    const int w = seed_off[(size_t)b * K + k];
    r.off_m[k] = w;
    r.anc_m[k] = seed_anc[(size_t)b * K + k];
    if (w > NEG) {
      lo = k < lo ? k : lo;
      hi = k > hi ? k : hi;
    }
  }
  if (hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const int lo0 = s_lo, hi0 = s_hi;

  const uint32_t* qw = (const uint32_t*)(query + (size_t)b * L);
  const uint32_t* tw = (const uint32_t*)(target + (size_t)b * L);
  int d_end = qlen - tlen + K / 2;
  d_end = d_end < 0 ? 0 : (d_end > K - 1 ? K - 1 : d_end);

  int levels = 0;
  long long lanes = 0;  // sum over swept levels of the wavefront's width
  bool finished = false;
  if (hi0 >= lo0) {
    for (int s = 1; s <= max_s; ++s) {
      int k_lo = lo0 - s, k_hi = hi0 + s;
      k_lo = k_lo < 0 ? 0 : k_lo;
      k_hi = k_hi > K - 1 ? K - 1 : k_hi;
      int done = 0;
      for (int k = k_lo + tid; k <= k_hi; k += T) {
        const int kv = k - K / 2;
        int m_x, m_o1l, m_o2l, m_o1r, m_o2r;
        uint32_t a_mx, a_o1l, a_o2l, a_o1r, a_o2r;
        r.land_m(s - p.x, k, m_x, a_mx);
        r.land_m(s - p.o1 - p.e1, k - 1, m_o1l, a_o1l);
        r.land_m(s - p.o2 - p.e2, k - 1, m_o2l, a_o2l);
        r.land_m(s - p.o1 - p.e1, k + 1, m_o1r, a_o1r);
        r.land_m(s - p.o2 - p.e2, k + 1, m_o2r, a_o2r);
        int g_off, g_open;
        uint32_t g_anc;
        r.land_g(0, s - p.e1, k - 1, g_off, g_anc, g_open);
        const Gap i1 = gap_wave<true>(m_o1l, a_o1l, g_off, g_anc, g_open, kv,
                                      axis_q, mid);
        r.land_g(1, s - p.e2, k - 1, g_off, g_anc, g_open);
        const Gap i2 = gap_wave<true>(m_o2l, a_o2l, g_off, g_anc, g_open, kv,
                                      axis_q, mid);
        r.land_g(2, s - p.e1, k + 1, g_off, g_anc, g_open);
        const Gap d1 = gap_wave<false>(m_o1r, a_o1r, g_off, g_anc, g_open,
                                       kv, axis_q, mid);
        r.land_g(3, s - p.e2, k + 1, g_off, g_anc, g_open);
        const Gap d2 = gap_wave<false>(m_o2r, a_o2r, g_off, g_anc, g_open,
                                       kv, axis_q, mid);

        // mismatch candidate and its crossing
        int m_off = m_x > NEG ? m_x + 1 : NEG;
        uint32_t m_anc = a_mx;
        if (m_off > NEG && a_mx == UNS &&
            (axis_q ? m_off == mid + 1 : m_off - kv == mid + 1))
          m_anc = pack(m_off - kv - 1, m_off - 1);
        // M = first strict maximum in the order X, I1, I2, D1, D2
        if (i1.off > m_off) { m_off = i1.off; m_anc = i1.anc; }
        if (i2.off > m_off) { m_off = i2.off; m_anc = i2.anc; }
        if (d1.off > m_off) { m_off = d1.off; m_anc = d1.anc; }
        if (d2.off > m_off) { m_off = d2.off; m_anc = d2.anc; }
        const int v = m_off - kv;
        if (!(m_off >= 0 && m_off <= qlen && v >= 0 && v <= tlen)) {
          m_off = NEG;
          m_anc = UNS;
        }
        int m_ext = m_off;
        if (m_off > NEG) {
          m_ext = extend(qw, tw, m_off, kv, qlen, tlen);
          if (k == 0 || k == K - 1) s_edge = 1;
          // crossings inside the extension run
          if (!axis_q && m_anc == UNS && m_off - kv <= mid &&
              m_ext - kv > mid)
            m_anc = pack(mid, mid + kv);
          if (axis_q && m_anc == UNS && m_off <= mid && m_ext > mid)
            m_anc = pack(mid - kv, mid);
        }
        r.put_m(s, k, m_ext, m_anc);
        r.put_g(0, s, k, i1);
        r.put_g(1, s, k, i2);
        r.put_g(2, s, k, d1);
        r.put_g(3, s, k, d2);
        if (k == d_end && m_ext >= qlen) {
          done = 1;
          tr[1] = s;
          tr[2] = (int)m_anc;
        }
      }
      ++levels;
      lanes += k_hi - k_lo + 1;
      if (__syncthreads_or(done)) {
        finished = true;
        break;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    tr[0] = finished ? 1 : 0;
    if (!finished) {
      tr[1] = 0;
      tr[2] = (int)UNS;
    }
    tr[3] = s_edge;
    tr[4] = levels;
    tr[5] = (int)(lanes & 0x7FFFFFFF);
    tr[6] = (int)(lanes >> 31);
    tr[7] = 0;
  }
}

}  // namespace

extern "C" {

// query/target (B, L) u8 rows, L a multiple of 4, padded at least 8 bytes
// past the lengths; par (B, 8) i32; seed_off (B, K) i32; seed_anc (B, K)
// u32; scratch (B, (2 * Rm + 12 * Rg) * K) i32; term (B, 8) i32. Launches
// on `stream` and returns cudaGetLastError() of the launch.
int sweep_wfa_launch(const void* query, const void* target, int B, int L,
                     const void* par, const void* seed_off,
                     const void* seed_anc, int K, int max_s, int x, int o1,
                     int e1, int o2, int e2, void* scratch, void* term,
                     void* stream) {
  if (B <= 0) return 0;
  Pen p{x, o1, e1, o2, e2, 0, 0};
  int rm = x > o1 + e1 ? x : o1 + e1;
  rm = rm > o2 + e2 ? rm : o2 + e2;
  p.Rm = rm + 1;
  p.Rg = (e1 > e2 ? e1 : e2) + 1;
  int threads = (K + 31) / 32 * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  sweep_wfa_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)query, (const uint8_t*)target, L, (const int*)par,
      (const int*)seed_off, (const uint32_t*)seed_anc, K, max_s, p,
      (int*)scratch, (int*)term);
  return (int)cudaGetLastError();
}

const char* sweep_wfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
