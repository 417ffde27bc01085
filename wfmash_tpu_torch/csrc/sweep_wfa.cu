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
// Design. A problem's rings hold, per lane, Rm M slots and Rg slots of each
// gap state (Rm = max(x, o1+e1, o2+e2) + 1, Rg = max(e1, e2) + 1). Lengths
// are below 65535, so a ring word is stored narrow and widened on load; the
// recurrence itself stays in int:
//   M offset      uint16, 0xFFFF = none          anchor  uint32
//   D offset      uint16, 0xFFFF = none          open    uint16, 0xFFFF = -1
//   I offset - 1  uint16, 0xFFFF = none, saturated at 0xFFFE
// An M or D offset never exceeds the query length. An I offset can (gap
// cells are not bounds-tested until they become M candidates), but an I
// offset of 65535 or more exceeds every query length, so that cell and
// all it extends into are out of bounds whatever its exact value: M's
// bounds test clears them, and such a cell beats every in-bounds M source
// at the tie test as it did before. 6 bytes an M cell, 8 a gap cell (its
// anchor, offset and gap-open coordinate are one 64-bit load):
// (6 * Rm + 32 * Rg) bytes a lane, 252 with the default penalties.
//
// sweep_wfa_shared_kernel keeps those rings in dynamic shared memory and
// nothing of them in global memory, one thread a lane, one
// __syncthreads() a level: the slot written at level s is read at no lag
// of level s, and the slot of the deepest lag is rewritten only at level
// s + 1, after the barrier that every reader of level s has passed. Up to
// K = 512 a problem is one block (with one dead column either side of its
// lanes, so that the k - 1 / k + 1 reads need no bounds test). At K = 1024,
// 2048, 4096 it is a thread-block cluster of K / 512 blocks, each owning
// 512 consecutive lanes. A cluster barrier costs about as much as half a
// level, so the blocks do not meet every level: each block also holds and
// computes HALO = 16 lanes of either neighbour, sweeps 16 levels alone
// (a halo lane at distance d from the owned lanes is exact for the first
// 16 - d of them, which is as long as an owned lane needs it), and then
// all meet: cluster.sync(), each block copies its outermost 16 owned
// lanes, every ring slot of them, into its neighbours' halo columns
// through distributed shared memory (map_shared_rank), cluster.sync().
// The first barrier says that every block has read its halo for the last
// time, the second that the copies have landed; the second is also the
// last thing a block does with another's memory before it may return. The
// lane on the end diagonal stores the level of its finish into every
// block's shared memory; the blocks see it at the next meeting, and the
// up to 15 levels swept after the finish count for nothing: the term row
// is written once, by block 0, from the finish level, the first levels at
// which lanes 0 and K - 1 went live (stored into block 0 by their owners)
// and the lane count cut back to the finish. The seeded-lane range is
// reduced over the cluster after the seeding barrier. Only lanes the
// wavefront can have reached are computed: it widens by one lane a side
// per level from the seeded lanes.
//
// sweep_wfa_global_kernel is the earlier design, kept for shapes the
// cluster layout does not take (K above 512 and not 1024, 2048 or 4096,
// or penalties whose rings exceed a block's 227 KB): one block a problem,
// lanes strided over up to 1024 threads, rings as 32-bit words in global
// scratch that the kernel fills itself, __syncthreads_or a level. The
// caller chooses between the two from K and the penalties alone
// (wfa_sweep.kernel_choice) and says so in `cluster`.
//
// Match extension compares the padded sequence bytes themselves through
// unaligned 32-bit windows (aligned loads and funnel shifts), four bytes
// first and then sixteen a step, bounded by the true lengths: no 4-bit
// codes, no eq-bit cache, no one-hot matmul fetch as on the TPU. The
// sequences stay in global memory, read-only.
//
// Each problem stops at its own finish (the TPU kernel stepped a group of
// problems while any was alive), so `clipped` means "touched the band edge
// at or before its finish", and a problem unfinished after level max_s
// reports finished = 0.
//
// What bounds it on this card: with the rings in global memory, ring
// traffic (a lane loads 22 ring words and stores 14 per level; 128
// problems at K = 4096 hold 184 MB of rings, more than the 50 MB L2).
// With the rings in shared memory a block of 512 lanes fills its SM's
// shared memory, so an SM runs one block's 16 or 17 warps: about 380
// instructions a lane and level, issued at four warps a cycle, are half
// of a level's time; the rest is the latency of the longest match
// extension of the level (sequence reads from L1/L2) and the barrier. A
// cluster of 8 blocks holds 8 SMs, so 15 such problems run at once. A long
// run of matches is walked by one thread, sixteen bytes a step, and again
// by every score class that reaches the run (a wavefront does not drop a
// level that an earlier one has overtaken): a few long near-identical
// problems cost what those walks cost, and they cost less from the L1
// (shared_config).

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// One problem's rings in global scratch (sweep_wfa_global_kernel).
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
  return __funnelshift_r(__ldg(w + i), __ldg(w + i + 1), (pos & 3) << 3);
}

// Advance offset h on diagonal kv while query[h] == target[h - kv], never
// past either true length. Rows are padded by at least 8 bytes beyond the
// lengths, so the windows stay inside the row. Most cells stop within four
// bytes; a cell on a matching stretch then goes sixteen bytes a step (five
// aligned words a row, loaded together), and a level waits for its longest
// run.
__device__ __forceinline__ int extend(const uint32_t* qw, const uint32_t* tw,
                                      int h, int kv, int qlen, int tlen) {
  const int v = h - kv;
  const int room_q = qlen - h, room_t = tlen - v;
  const int room = room_q < room_t ? room_q : room_t;
  if (room <= 0) return h;
  uint32_t x = window(qw, h) ^ window(tw, v);
  if (x) {
    const int run = (__ffs((int)x) - 1) >> 3;
    return h + (run < room ? run : room);
  }
  int run = 4;
  while (room - run >= 16) {
    const int pq = h + run, pt = v + run;
    const uint32_t* q = qw + (pq >> 2);
    const uint32_t* t = tw + (pt >> 2);
    const uint32_t q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
                   q3 = __ldg(q + 3), q4 = __ldg(q + 4);
    const uint32_t t0 = __ldg(t), t1 = __ldg(t + 1), t2 = __ldg(t + 2),
                   t3 = __ldg(t + 3), t4 = __ldg(t + 4);
    const int sq = (pq & 3) << 3, st = (pt & 3) << 3;
    const uint32_t x0 =
        __funnelshift_r(q0, q1, sq) ^ __funnelshift_r(t0, t1, st);
    const uint32_t x1 =
        __funnelshift_r(q1, q2, sq) ^ __funnelshift_r(t1, t2, st);
    const uint32_t x2 =
        __funnelshift_r(q2, q3, sq) ^ __funnelshift_r(t2, t3, st);
    const uint32_t x3 =
        __funnelshift_r(q3, q4, sq) ^ __funnelshift_r(t3, t4, st);
    if (x0 | x1 | x2 | x3) {
      const int word = x0 ? 0 : x1 ? 1 : x2 ? 2 : 3;
      x = x0 ? x0 : x1 ? x1 : x2 ? x2 : x3;
      return h + run + 4 * word + ((__ffs((int)x) - 1) >> 3);
    }
    run += 16;
  }
  while (run < room) {
    x = window(qw, h + run) ^ window(tw, v + run);
    if (x) {
      run += (__ffs((int)x) - 1) >> 3;
      break;
    }
    run += 4;
  }
  return h + (run < room ? run : room);
}

__global__ void __launch_bounds__(MAX_THREADS)
sweep_wfa_global_kernel(const uint8_t* __restrict__ query,
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


// ---- rings in shared memory ----------------------------------------------

constexpr int BLOCK_LANES = 512;  // lanes one block owns
constexpr int HALO = 16;          // halo lanes a side in a cluster's block
constexpr int MAX_COLS = BLOCK_LANES + 2 * HALO;  // threads of one block
constexpr uint32_t NONE16 = 0xFFFFu;
constexpr int I_SAT = 0xFFFE;     // stored I offsets saturate here
constexpr int NO_LEVEL = 0x7FFFFFFF;

// One block's ring slices in its dynamic shared memory, as byte offsets
// (anc_m at 0); the same in every block of a cluster. W columns: the KB
// lanes the block owns and H columns on either side, which in a cluster
// are the neighbours' lanes (halo) and in a single block one dead column
// that stays "none", so that no k - 1 / k + 1 read needs a bounds test.
// anc_m (Rm, W) u32; gap (4, Rg, W) of 8 bytes: the anchor, then offset
// (low half) and gap-open coordinate (high half) in one word; off_m
// (Rm, W) u16: W * (6 * Rm + 32 * Rg) bytes. "None" is all bits set in
// every field, so the rings are cleared by storing 0xFFFFFFFF words. A
// slot that no level has written yet reads as none, which is what a
// source before level 0 is.
struct Lay {
  int KB, H, W, Rm, Rg;
  int gap, off_m;
};

Lay layout(int KB, int H, int Rm, int Rg) {
  Lay y;
  y.KB = KB;
  y.H = H;
  y.W = KB + 2 * H;
  y.Rm = Rm;
  y.Rg = Rg;
  y.gap = 4 * Rm * y.W;
  y.off_m = y.gap + 32 * Rg * y.W;
  return y;
}

int layout_bytes(const Lay& y) { return y.off_m + 2 * y.Rm * y.W; }

// Loads widen, stores narrow.
__device__ __forceinline__ void ld_m(const uint8_t* base, const Lay& y,
                                     int slot, int j, int& w, uint32_t& a) {
  const int i = slot * y.W + j;
  const uint32_t o = ((const uint16_t*)(base + y.off_m))[i];
  w = o == NONE16 ? NEG : (int)o;
  a = ((const uint32_t*)base)[i];
}

template <bool INS>
__device__ __forceinline__ void ld_g(const uint8_t* base, const Lay& y, int g,
                                     int slot, int j, int& w, uint32_t& a,
                                     int& o) {
  const uint2 c = ((const uint2*)(base + y.gap))[(g * y.Rg + slot) * y.W + j];
  const uint32_t f = c.y & 0xFFFFu, q = c.y >> 16;
  w = f == NONE16 ? NEG : (int)f + (INS ? 1 : 0);
  a = c.x;
  o = q == NONE16 ? -1 : (int)q;
}

__device__ __forceinline__ void st_m(uint8_t* base, const Lay& y, int slot,
                                     int j, int w, uint32_t a) {
  const int i = slot * y.W + j;
  ((uint16_t*)(base + y.off_m))[i] = (uint16_t)(w > NEG ? (uint32_t)w : NONE16);
  ((uint32_t*)base)[i] = a;
}

template <bool INS>
__device__ __forceinline__ void st_g(uint8_t* base, const Lay& y, int g,
                                     int slot, int j, const Gap& c) {
  uint32_t f = NONE16;
  if (c.off > NEG) {
    const int v = c.off - (INS ? 1 : 0);
    f = (uint32_t)(INS && v > I_SAT ? I_SAT : v);
  }
  const uint32_t q = c.open < 0 ? NONE16 : (uint32_t)c.open;
  ((uint2*)(base + y.gap))[(g * y.Rg + slot) * y.W + j] =
      make_uint2(c.anc, f | (q << 16));
}

// Copy H columns of every ring row from this block's columns starting at
// `src_col` into block `to`'s columns starting at `dst_col`.
__device__ void push_columns(cg::cluster_group& cluster, uint8_t* smem,
                             const Lay& y, int src_col, int to, int dst_col) {
  uint8_t* far = cluster.map_shared_rank(smem, to);
  const int tid = threadIdx.x, T = blockDim.x;
  const int n_anc = y.Rm * y.H, n_gap = 4 * y.Rg * y.H;
  for (int i = tid; i < n_anc; i += T) {
    const int r = i / y.H, c = i - r * y.H;
    ((uint32_t*)far)[r * y.W + dst_col + c] =
        ((const uint32_t*)smem)[r * y.W + src_col + c];
    ((uint16_t*)(far + y.off_m))[r * y.W + dst_col + c] =
        ((const uint16_t*)(smem + y.off_m))[r * y.W + src_col + c];
  }
  for (int i = tid; i < n_gap; i += T) {
    const int r = i / y.H, c = i - r * y.H;
    ((uint2*)(far + y.gap))[r * y.W + dst_col + c] =
        ((const uint2*)(smem + y.gap))[r * y.W + src_col + c];
  }
}

// Lanes of the wavefront at level s: the seeded lanes widened by s a side,
// inside the band.
__device__ __forceinline__ int width_at(int lo0, int hi0, int s, int K) {
  const int k_lo = lo0 - s < 0 ? 0 : lo0 - s;
  const int k_hi = hi0 + s > K - 1 ? K - 1 : hi0 + s;
  return k_hi - k_lo + 1;
}

// MULTI: the problem is a cluster of blocks that meet every HALO levels;
// else one block.
template <bool MULTI>
__global__ void __launch_bounds__(MAX_COLS)
sweep_wfa_shared_kernel(const uint8_t* __restrict__ query,
                        const uint8_t* __restrict__ target, int L,
                        const int* __restrict__ par,
                        const int* __restrict__ seed_off,
                        const uint32_t* __restrict__ seed_anc, int K,
                        int max_s, Pen p, Lay y, int* term) {
  extern __shared__ __align__(16) uint8_t smem[];
  // s_fin: the level at which the end diagonal finished; s_edge: the first
  // levels at which lanes 0 and K - 1 went live (read in block 0)
  __shared__ int s_lo, s_hi, s_fin, s_edge[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = MULTI ? (int)cluster.num_blocks() : 1;
  const int rank = MULTI ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, T = blockDim.x;
  const int KB = y.KB, H = y.H, W = y.W;
  // a cluster's block has a thread for every column, a single block one
  // for every lane it owns
  const int col = MULTI ? tid : tid + H;
  const int k = rank * KB - H + col;  // the lane of this thread's column
  const bool own = col >= H && col < H + KB;
  const bool in_band = col < W && k >= 0 && k < K;
  const int* pr = par + (size_t)b * NPAR;
  int* tr = term + (size_t)b * NTERM;
  const int qlen = pr[0], tlen = pr[1];
  const bool axis_q = pr[2] != 0;
  const int mid = pr[3];
  if (pr[4]) {  // solved before the sweep; the same in every block
    if (rank == 0 && tid < NTERM) tr[tid] = 0;
    return;
  }

  // ---- fill the rings, seed slot 0, find the seeded lanes -----------------
  {
    const int n_words = (y.off_m + 2 * y.Rm * W) / 4;  // W is even
    for (int i = tid; i < n_words; i += T) ((uint32_t*)smem)[i] = UNS;
  }
  if (tid == 0) {
    s_lo = K;
    s_hi = -1;
    s_fin = 0;
    s_edge[0] = NO_LEVEL;
    s_edge[1] = NO_LEVEL;
  }
  __syncthreads();
  if (in_band) {  // halo lanes are seeded like owned ones
    const int w = seed_off[(size_t)b * K + k];
    st_m(smem, y, 0, col, w, seed_anc[(size_t)b * K + k]);
    if (own && w > NEG) {
      atomicMin(&s_lo, k);
      atomicMax(&s_hi, k);
    }
  }
  if (MULTI) cluster.sync(); else __syncthreads();
  int lo0 = s_lo, hi0 = s_hi;
  if (MULTI) {
    for (int r = 0; r < C; ++r) {
      const int lo_r = *cluster.map_shared_rank(&s_lo, r);
      const int hi_r = *cluster.map_shared_rank(&s_hi, r);
      lo0 = lo_r < lo0 ? lo_r : lo0;
      hi0 = hi_r > hi0 ? hi_r : hi0;
    }
  }

  const uint32_t* qw = (const uint32_t*)(query + (size_t)b * L);
  const uint32_t* tw = (const uint32_t*)(target + (size_t)b * L);
  int d_end = qlen - tlen + K / 2;
  d_end = d_end < 0 ? 0 : (d_end > K - 1 ? K - 1 : d_end);
  const int kv = k - K / 2;
  const int lag_o1 = p.o1 + p.e1, lag_o2 = p.o2 + p.e2;
  // Levels after a meeting for which this column is computed: an owned
  // column always; a halo column at distance d from the owned ones for the
  // first HALO - d, while its sources are exact (col in the left halo,
  // W - 1 - col in the right one). Halo columns outside the band, which
  // the first and the last block have, fail in_band.
  const int reach = own ? INT_MAX : (col < H ? col : W - 1 - col);

  int s = 0;
  long long lanes = 0;  // sum over swept levels of the wavefront's width
  bool touched = false, finished_here = false;
  int slot_m = 0, slot_g = 0;  // ring slots of level s
  if (hi0 >= lo0) {
    while (s < max_s) {
      const int tile = MULTI ? (max_s - s < H ? max_s - s : H) : max_s - s;
      bool stop = false;
      for (int t = 1; t <= tile; ++t) {
        ++s;
        slot_m = slot_m + 1 == y.Rm ? 0 : slot_m + 1;
        slot_g = slot_g + 1 == y.Rg ? 0 : slot_g + 1;
        int k_lo = lo0 - s, k_hi = hi0 + s;
        k_lo = k_lo < 0 ? 0 : k_lo;
        k_hi = k_hi > K - 1 ? K - 1 : k_hi;
        lanes += k_hi - k_lo + 1;
        if (in_band && k >= k_lo && k <= k_hi && t <= reach) {
          // slot of level s - lag (lag < ring depth)
          int sm_x = slot_m - p.x, sm_o1 = slot_m - lag_o1,
              sm_o2 = slot_m - lag_o2;
          sm_x += sm_x < 0 ? y.Rm : 0;
          sm_o1 += sm_o1 < 0 ? y.Rm : 0;
          sm_o2 += sm_o2 < 0 ? y.Rm : 0;
          int sg_e1 = slot_g - p.e1, sg_e2 = slot_g - p.e2;
          sg_e1 += sg_e1 < 0 ? y.Rg : 0;
          sg_e2 += sg_e2 < 0 ? y.Rg : 0;
          int m_x, m_o1l, m_o2l, m_o1r, m_o2r;
          uint32_t a_mx, a_o1l, a_o2l, a_o1r, a_o2r;
          ld_m(smem, y, sm_x, col, m_x, a_mx);
          ld_m(smem, y, sm_o1, col - 1, m_o1l, a_o1l);
          ld_m(smem, y, sm_o2, col - 1, m_o2l, a_o2l);
          ld_m(smem, y, sm_o1, col + 1, m_o1r, a_o1r);
          ld_m(smem, y, sm_o2, col + 1, m_o2r, a_o2r);
          int g_off, g_open;
          uint32_t g_anc;
          ld_g<true>(smem, y, 0, sg_e1, col - 1, g_off, g_anc, g_open);
          const Gap i1 = gap_wave<true>(m_o1l, a_o1l, g_off, g_anc, g_open,
                                        kv, axis_q, mid);
          ld_g<true>(smem, y, 1, sg_e2, col - 1, g_off, g_anc, g_open);
          const Gap i2 = gap_wave<true>(m_o2l, a_o2l, g_off, g_anc, g_open,
                                        kv, axis_q, mid);
          ld_g<false>(smem, y, 2, sg_e1, col + 1, g_off, g_anc, g_open);
          const Gap d1 = gap_wave<false>(m_o1r, a_o1r, g_off, g_anc, g_open,
                                         kv, axis_q, mid);
          ld_g<false>(smem, y, 3, sg_e2, col + 1, g_off, g_anc, g_open);
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
            if (own && !touched && (k == 0 || k == K - 1)) {
              touched = true;  // one thread owns the lane: no race
              int* at = &s_edge[k == 0 ? 0 : 1];
              if (MULTI) at = cluster.map_shared_rank(at, 0);
              *at = s;
            }
            // crossings inside the extension run
            if (!axis_q && m_anc == UNS && m_off - kv <= mid &&
                m_ext - kv > mid)
              m_anc = pack(mid, mid + kv);
            if (axis_q && m_anc == UNS && m_off <= mid && m_ext > mid)
              m_anc = pack(mid - kv, mid);
          }
          st_m(smem, y, slot_m, col, m_ext, m_anc);
          st_g<true>(smem, y, 0, slot_g, col, i1);
          st_g<true>(smem, y, 1, slot_g, col, i2);
          st_g<false>(smem, y, 2, slot_g, col, d1);
          st_g<false>(smem, y, 3, slot_g, col, d2);
          if (own && k == d_end && m_ext >= qlen && !finished_here) {
            finished_here = true;  // later levels of this run do not count
            tr[1] = s;
            tr[2] = (int)m_anc;
            if (MULTI) {
              for (int r = 0; r < C; ++r)
                *cluster.map_shared_rank(&s_fin, r) = s;
            } else {
              s_fin = s;
            }
          }
        }
        __syncthreads();
        if (!MULTI && s_fin) {
          stop = true;
          break;
        }
      }
      if (MULTI) {
        // the meeting: every block has swept this run of levels and read
        // its halo for the last time; then each hands its outermost owned
        // lanes, exact at every level, to its neighbours' halos
        cluster.sync();
        if (rank > 0) push_columns(cluster, smem, y, H, rank - 1, H + KB);
        if (rank + 1 < C) push_columns(cluster, smem, y, KB, rank + 1, 0);
        cluster.sync();
        stop = s_fin != 0;
      }
      if (stop) break;
    }
  }
  if (rank == 0 && tid == 0) {
    // levels swept after the finish, to the end of a run, count for nothing
    const int fin = s_fin;
    int levels = s;
    if (fin) {
      for (int u = fin + 1; u <= s; ++u) lanes -= width_at(lo0, hi0, u, K);
      levels = fin;
    }
    const int edge = s_edge[0] < s_edge[1] ? s_edge[0] : s_edge[1];
    tr[0] = fin ? 1 : 0;
    if (!fin) {
      tr[1] = 0;
      tr[2] = (int)UNS;
    }
    tr[3] = edge <= levels ? 1 : 0;
    tr[4] = levels;
    tr[5] = (int)(lanes & 0x7FFFFFFF);
    tr[6] = (int)(lanes >> 31);
    tr[7] = 0;
  }
}

void ring_depths(Pen& p) {
  int rm = p.x > p.o1 + p.e1 ? p.x : p.o1 + p.e1;
  rm = rm > p.o2 + p.e2 ? rm : p.o2 + p.e2;
  p.Rm = rm + 1;
  p.Rg = (p.e1 > p.e2 ? p.e1 : p.e2) + 1;
}

constexpr int SM_SHARED_BYTES = 228 * 1024;  // shared memory of one SM
constexpr int BLOCK_RESERVED_BYTES = 1024;   // taken from it for each block

// Launch attributes of the shared-memory kernel for B problems of K lanes,
// each a cluster of `cluster` blocks. The kernel's shared-memory limit is
// raised to the rings' size. An SM's shared memory and L1 cache are one
// 256 KB array: the split asked for leaves the L1 all that the blocks an
// SM must hold at once (all the blocks over the card's SMs, at most as
// many as fit) do not need, because the match extension reads a long run
// of matches once for every score class that reaches it, and those reads
// hit the L1 only if it holds the problem's sequences.
cudaError_t shared_config(int B, int K, int cluster, const Pen& p,
                          cudaStream_t stream, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr, Lay* y) {
  const bool fits = cluster == 1 || cluster == 2 || cluster == 4 ||
                    cluster == 8;
  if (!fits || K % cluster || K / cluster > BLOCK_LANES)
    return cudaErrorInvalidValue;
  *y = layout(K / cluster, cluster > 1 ? HALO : 1, p.Rm, p.Rg);
  const int smem = layout_bytes(*y);
  const auto kernel = cluster > 1 ? sweep_wfa_shared_kernel<true>
                                  : sweep_wfa_shared_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long per_block = smem + BLOCK_RESERVED_BYTES;
  const long long fit = (SM_SHARED_BYTES - BLOCK_RESERVED_BYTES) / per_block;
  long long held = ((long long)B * cluster + n_sm - 1) / n_sm;
  held = held > fit ? fit : held;
  held = held < 1 ? 1 : held;
  const long long pct =
      (held * per_block * 100 + SM_SHARED_BYTES - 1) / SM_SHARED_BYTES;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)(pct > 100 ? 100 : pct));
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * cluster);
  cfg->blockDim = dim3(((cluster > 1 ? y->W : y->KB) + 31) / 32 * 32);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// query/target (B, L) u8 rows, L a multiple of 4, padded at least 8 bytes
// past the lengths; par (B, 8) i32; seed_off (B, K) i32, each none (NEG) or
// in [0, 65534]; seed_anc (B, K) u32; term (B, 8) i32. cluster = 1, 2, 4 or
// 8 launches the shared-memory kernel with K / cluster lanes a block and
// ignores scratch; cluster = 0 launches the global-ring kernel with scratch
// (B, (2 * Rm + 12 * Rg) * K) i32. Launches on `stream` and returns the
// first CUDA error of the launch.
int sweep_wfa_launch(const void* query, const void* target, int B, int L,
                     const void* par, const void* seed_off,
                     const void* seed_anc, int K, int max_s, int x, int o1,
                     int e1, int o2, int e2, int cluster, void* scratch,
                     void* term, void* stream) {
  if (B <= 0) return 0;
  Pen p{x, o1, e1, o2, e2, 0, 0};
  ring_depths(p);
  if (cluster == 0) {
    int threads = (K + 31) / 32 * 32;
    threads = threads > MAX_THREADS ? MAX_THREADS : threads;
    sweep_wfa_global_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)query, (const uint8_t*)target, L, (const int*)par,
        (const int*)seed_off, (const uint32_t*)seed_anc, K, max_s, p,
        (int*)scratch, (int*)term);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Lay y;
  cudaError_t err =
      shared_config(B, K, cluster, p, (cudaStream_t)stream, &cfg, &attr, &y);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(
      &cfg,
      cluster > 1 ? sweep_wfa_shared_kernel<true>
                  : sweep_wfa_shared_kernel<false>,
      (const uint8_t*)query, (const uint8_t*)target, L, (const int*)par,
      (const int*)seed_off, (const uint32_t*)seed_anc, K, max_s, p, y,
      (int*)term);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of the shared-memory kernel the card can hold at once for this
// shape (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int sweep_wfa_active_clusters(int K, int x, int o1, int e1, int o2, int e2,
                              int cluster) {
  Pen p{x, o1, e1, o2, e2, 0, 0};
  ring_depths(p);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Lay y;
  // a batch large enough that every SM holds all the blocks that fit
  cudaError_t err = shared_config(1 << 16, K, cluster, p, 0, &cfg, &attr, &y);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cluster > 1
            ? cudaOccupancyMaxActiveClusters(
                  &n, sweep_wfa_shared_kernel<true>, &cfg)
            : cudaOccupancyMaxActiveClusters(
                  &n, sweep_wfa_shared_kernel<false>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

const char* sweep_wfa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
