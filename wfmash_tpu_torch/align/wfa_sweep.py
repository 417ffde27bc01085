"""Exact crossing-payload WFA sweep on PyTorch and CUDA: kernel wrapper,
plain version and batch front end.

Counterpart of wfmash_tpu/align/wfa_pallas.py. A batch of end-to-end
problems is swept score by score over a band of K diagonals; every
wavefront cell carries the packed cell `(v << 16) | h` at which its path
crossed the problem's split line, so the sweep returns each problem's
exact score and a Hirschberg split anchor in O(K) memory:

* `run_sweep` takes padded sequence rows, per-problem parameters and the
  score-0 M wavefront as tensors and returns `term (B, 8) int32`
  (finished, score, packed anchor, clipped, swept levels, wavefront
  lanes in two words). On a CUDA
  tensor it launches the hand-written kernel csrc/sweep_wfa.cu; on a CPU
  tensor it runs `sweep_torch`.
* `sweep_torch` is the plain PyTorch version of the same function: a loop
  over scores of tensor ops on (B, K), following wfa_jax._advance /
  _sweep / _extend.
* `ExactSweeps` is the numpy-facing front end with PallasSweeps' `sweep`
  signature and its five returns.
* `advance_torch` is one level on explicit state in wfa_jax._advance's
  layout (int32 rings of every state, an optional lane-to-diagonal map):
  the unit that parallel/mesh.py shards, a torch program as the
  reference's is an XLA one.

Two deliberate differences from the TPU kernel and its host loop:

* Each problem stops at its own finish. The TPU kernel stepped a group of
  problems while any was alive and kept raising the band-edge flag of
  problems already finished, so its `clipped` depended on group peers.
  Here `clipped` is "a live cell touched the band edge at or before the
  finish": port-clipped implies reference-clipped, and score, anchor and
  finished are always equal. A sweep whose edge lanes never went live
  before the finish computed the unbanded values, so this can only save a
  span escalation, never change a result.
* `max_s` follows wfa_jax._sweep: levels 1..max_s are swept and a problem
  still open then returns finished = False. PallasSweeps ran whole chunks
  and could overshoot by up to chunk_steps - 1 levels. One launch per
  batch replaces its chunked relaunches.

Sequences are compared as raw bytes (pads 0x01 / 0x02), so no alphabet
guard and no 4-bit encoding are needed.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import _build
from ..utils import perf
from .wfa_np import Penalties

NEG_I = -(1 << 28)
UNSET32 = 0xFFFFFFFF
M_, I1_, I2_, D1_, D2_ = 0, 1, 2, 3, 4     # states of advance_torch's rings

NPAR = 8     # par columns: qlen, tlen, axis_is_query, mid, done0, 0, 0, 0
# term columns: finished, score, anchor, clipped, levels, wavefront lanes
# (low 31 bits), lanes >> 31, 0. A level computes only the lanes the
# wavefront can have reached: the seeded lanes widened by one a side per
# level, inside the band.
NTERM = 8
SEQ_PAD = 8  # bytes of padding the rows keep beyond the longest sequence

# kernel launches made by run_sweep (plain-version calls are not counted)
LAUNCHES = 0
_launch_lock = threading.Lock()


def ring_sizes(p: Penalties) -> tuple[int, int]:
    rm = max(p.mismatch, p.gap_opening1 + p.gap_extension1,
             p.gap_opening2 + p.gap_extension2) + 1
    rg = max(p.gap_extension1, p.gap_extension2) + 1
    return rm, rg


def scratch_words(p: Penalties, K: int) -> int:
    """int32 words of ring scratch one problem needs under the global-ring
    kernel."""
    rm, rg = ring_sizes(p)
    return (2 * rm + 12 * rg) * K


BLOCK_LANES = 512           # lanes one block of the shared-memory kernel owns
HALO = 16                   # halo lanes a side that a cluster's block adds
SMEM_LIMIT = 227 * 1024     # dynamic shared memory one block can be given
_SMEM_STATIC = 64           # room kept for the kernel's few static words


def ring_bytes_per_lane(p: Penalties) -> int:
    """Bytes of narrow ring words a lane holds: an M cell is a uint16
    offset and a 32-bit anchor, a gap cell a uint16 offset, a uint16
    gap-open coordinate and a 32-bit anchor, for each of four gap states."""
    rm, rg = ring_sizes(p)
    return 6 * rm + 32 * rg


def kernel_choice(p: Penalties, K: int) -> int:
    """Which kernel of csrc/sweep_wfa.cu a sweep of K lanes under
    penalties p takes, decided from these two alone: the number of blocks
    of the cluster that holds one problem's rings in shared memory (1 up
    to K = 512; 2, 4, 8 at K = 1024, 2048, 4096), or 0 for the kernel with
    rings in global scratch (K above 512 and not one of those, or rings
    larger than a block's shared memory: a block holds its K / cluster
    lanes and, either side, HALO lanes of its neighbours in a cluster or
    one dead column alone)."""
    if K <= BLOCK_LANES:
        cluster = 1
    elif K in (2 * BLOCK_LANES, 4 * BLOCK_LANES, 8 * BLOCK_LANES):
        cluster = K // BLOCK_LANES
    else:
        return 0
    lanes = K // cluster + 2 * (HALO if cluster > 1 else 1)
    if ring_bytes_per_lane(p) * lanes + _SMEM_STATIC > SMEM_LIMIT:
        return 0
    return cluster


def kernel_name(cluster: int) -> str:
    """The words chip_smoke.py prints for a `kernel_choice`."""
    if cluster == 0:
        return "global rings"
    return "shared rings, one block" if cluster == 1 else \
        f"shared rings, cluster of {cluster}"


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

_EXT_WINDOW = 32      # positions compared per step of the plain extension


def _pack(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(v, h) -> packed (v << 16) | h as a non-negative int64 < 2**32."""
    return (((v.to(torch.int64) & 0xFFFF) << 16)
            | (h.to(torch.int64) & 0xFFFF))


def _extend(h, q, t, kv, qlen, tlen):
    """Match extension of offsets h (B, K) over byte rows q/t (B, L):
    advance while query[h] == target[h - k], never past either length."""
    window = _EXT_WINDOW
    L = q.shape[1]
    out = h.clone()
    r, k = torch.nonzero(h > NEG_I, as_tuple=True)
    hh = h[r, k]
    kk = kv[k]
    ar = torch.arange(window, device=h.device, dtype=h.dtype)
    while r.numel():
        pos = hh[:, None] + ar
        vpos = pos - kk[:, None]
        inb = ((pos >= 0) & (pos < qlen[r][:, None]) & (vpos >= 0)
               & (vpos < tlen[r][:, None]))
        qv = q[r[:, None], pos.clamp(0, L - 1)]
        tv = t[r[:, None], vpos.clamp(0, L - 1)]
        run = (inb & (qv == tv)).to(torch.int32).cumprod(1).sum(
            1, dtype=torch.int32)
        hh = hh + run
        out[r, k] = hh
        full = run == window
        r, k, hh, kk = r[full], k[full], hh[full], kk[full]
    return out


_NONE16 = 0xFFFF      # a ring word that holds no offset / no gap-open cell
_I_SAT = 0xFFFE       # stored insertion offsets saturate here


def _narrow16(v: torch.Tensor, ins: bool) -> torch.Tensor:
    """int32 offsets (none <= NEG_I) or gap-open coordinates (none < 0)
    -> the kernel's uint16 ring word. Insertion offsets are stored less
    one, saturated at _I_SAT."""
    w = (v - 1).clamp(max=_I_SAT) if ins else v
    return torch.where(v < 0, _NONE16, w).to(torch.uint16)


def _widen16(w: torch.Tensor, none: int, ins: bool) -> torch.Tensor:
    v = w.to(torch.int32)
    return torch.where(v == _NONE16, none, v + 1 if ins else v)


def _narrow32(a: torch.Tensor) -> torch.Tensor:
    """Packed anchors (int64 values below 2**32) -> their 32-bit words."""
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


def _widen32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int64) & UNSET32


def sweep_torch(query: torch.Tensor, target: torch.Tensor,
                par: torch.Tensor, seed_off: torch.Tensor,
                seed_anc: torch.Tensor, *, penalties: Penalties, K: int,
                max_s: int) -> torch.Tensor:
    """Plain PyTorch version of the sweep kernel on any device: same
    inputs and output as `run_sweep`. All problems step together; a
    problem's outputs freeze at its own finish."""
    p = penalties
    x, o1, e1, o2, e2 = (p.mismatch, p.gap_opening1, p.gap_extension1,
                         p.gap_opening2, p.gap_extension2)
    Rm, Rg = ring_sizes(p)
    dev = query.device
    i32, i64 = torch.int32, torch.int64
    B = query.shape[0]
    qlen, tlen = par[:, 0], par[:, 1]
    axis_q = (par[:, 2] != 0)[:, None]
    mid = par[:, 3][:, None]
    done0 = par[:, 4] != 0
    lane = torch.arange(K, device=dev, dtype=i32)
    kv = lane - K // 2
    kvb = kv[None, :]
    d_end = (qlen - tlen + K // 2).clamp(0, K - 1).to(i64)[:, None]

    neg = torch.full((B, K), NEG_I, dtype=i32, device=dev)
    uns = torch.full((B, K), UNSET32, dtype=i64, device=dev)
    minus1 = torch.full((B, K), -1, dtype=i32, device=dev)
    # The rings hold the kernel's narrow words and are widened on read.
    # Gap state g < 2 is an insertion: its offset is stored less one and
    # saturated (an insertion offset of 65535 or more is out of bounds
    # whatever its exact value).
    none16 = _narrow16(neg, False)
    off_m = [none16] * Rm
    anc_m = [_narrow32(uns)] * Rm
    off_g = [[none16] * Rg for _ in range(4)]
    anc_g = [[_narrow32(uns)] * Rg for _ in range(4)]
    open_g = [[none16] * Rg for _ in range(4)]
    off_m[0] = _narrow16(seed_off.to(i32), False)
    anc_m[0] = _narrow32(seed_anc.to(i64) & UNSET32)

    def land_m(s):
        if s < 0:
            return neg, uns
        return _widen16(off_m[s % Rm], NEG_I, False), _widen32(anc_m[s % Rm])

    def land_g(g, s):
        if s < 0:
            return neg, uns, minus1
        return (_widen16(off_g[g][s % Rg], NEG_I, g < 2),
                _widen32(anc_g[g][s % Rg]),
                _widen16(open_g[g][s % Rg], -1, False))

    def sr(a, fill):   # value at k-1
        return torch.cat([fill[:, :1], a[:, :-1]], dim=1)

    def sl(a, fill):   # value at k+1
        return torch.cat([a[:, 1:], fill[:, :1]], dim=1)

    def gap_wave(m_src, a_m, g_src, a_g, g_open, is_ins):
        sh = sr if is_ins else sl
        m_s, g_s = sh(m_src, neg), sh(g_src, neg)
        am_s, ag_s = sh(a_m, uns), sh(a_g, uns)
        go_s = sh(g_open, minus1)
        use_open = m_s >= g_s                      # tie -> open
        base = torch.maximum(m_s, g_s)
        valid = base > NEG_I
        new_off = torch.where(valid, base + (1 if is_ins else 0), neg)
        new_anc = torch.where(use_open, am_s, ag_s)
        opened = m_s if is_ins else m_s - (kvb + 1)
        new_open = torch.where(valid, torch.where(use_open, opened, go_s),
                               minus1)
        if is_ins:
            crossed = (axis_q & (new_anc == UNSET32) & valid
                       & (new_off == mid + 1))
            new_anc = torch.where(crossed, _pack(new_off - kvb, new_open),
                                  new_anc)
        else:
            crossed = (~axis_q & (new_anc == UNSET32) & valid
                       & (new_off - kvb == mid + 1))
            new_anc = torch.where(crossed, _pack(new_open, new_off),
                                  new_anc)
        return new_off, new_anc, new_open

    active = ~done0
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    f_score = torch.zeros(B, dtype=i32, device=dev)
    f_anc = torch.full((B,), UNSET32, dtype=i64, device=dev)
    clipped = torch.zeros(B, dtype=torch.bool, device=dev)
    levels = torch.zeros(B, dtype=i32, device=dev)
    lanes = torch.zeros(B, dtype=i64, device=dev)
    seeded = seed_off > NEG_I
    has_seed = seeded.any(1)
    lo0 = seeded.to(i32).argmax(1)
    hi0 = K - 1 - seeded.flip(1).to(i32).argmax(1)

    s = 0
    while s < max_s and bool(active.any()):
        s += 1
        m_x, a_mx = land_m(s - x)
        m_o1, a_mo1 = land_m(s - o1 - e1)
        m_o2, a_mo2 = land_m(s - o2 - e2)
        i1 = gap_wave(m_o1, a_mo1, *land_g(0, s - e1), True)
        i2 = gap_wave(m_o2, a_mo2, *land_g(1, s - e2), True)
        d1 = gap_wave(m_o1, a_mo1, *land_g(2, s - e1), False)
        d2 = gap_wave(m_o2, a_mo2, *land_g(3, s - e2), False)

        mm = torch.where(m_x > NEG_I, m_x + 1, neg)
        crossed = ((mm > NEG_I) & (a_mx == UNSET32)
                   & ((axis_q & (mm == mid + 1))
                      | (~axis_q & (mm - kvb == mid + 1))))
        m_off = mm
        m_anc = torch.where(crossed, _pack(mm - kvb - 1, mm - 1), a_mx)
        for c_off, c_anc, _ in (i1, i2, d1, d2):   # first strict maximum
            better = c_off > m_off
            m_off = torch.where(better, c_off, m_off)
            m_anc = torch.where(better, c_anc, m_anc)
        v = m_off - kvb
        okb = ((m_off >= 0) & (m_off <= qlen[:, None]) & (v >= 0)
               & (v <= tlen[:, None]))
        m_off = torch.where(okb, m_off, neg)
        m_anc = torch.where(okb, m_anc, uns)

        m_ext = _extend(m_off, query, target, kv, qlen, tlen)
        live = m_off > NEG_I
        edge = live[:, 0] | live[:, K - 1]
        cr_t = (~axis_q & (m_anc == UNSET32) & live
                & (m_off - kvb <= mid) & (m_ext - kvb > mid))
        m_anc = torch.where(cr_t, _pack(mid.expand(B, K), mid + kvb), m_anc)
        cr_q = (axis_q & (m_anc == UNSET32) & live & (m_off <= mid)
                & (m_ext > mid))
        m_anc = torch.where(cr_q, _pack(mid - kvb, mid.expand(B, K)), m_anc)

        off_m[s % Rm] = _narrow16(m_ext, False)
        anc_m[s % Rm] = _narrow32(m_anc)
        for g, (o, a, op) in enumerate((i1, i2, d1, d2)):
            off_g[g][s % Rg] = _narrow16(o, g < 2)
            anc_g[g][s % Rg] = _narrow32(a)
            open_g[g][s % Rg] = _narrow16(op, False)

        fin_off = m_ext.gather(1, d_end)[:, 0]
        fin_anc = m_anc.gather(1, d_end)[:, 0]
        newly = active & (fin_off >= qlen)
        clipped |= active & edge
        levels += active.to(i32)
        width = (hi0 + s).clamp(max=K - 1) - (lo0 - s).clamp(min=0) + 1
        lanes += torch.where(active & has_seed, width, 0)
        f_score = torch.where(newly, s, f_score)
        f_anc = torch.where(newly, fin_anc, f_anc)
        finished |= newly
        active = active & ~newly

    term = torch.zeros((B, NTERM), dtype=i32, device=dev)
    term[:, 0] = finished.to(i32)
    term[:, 1] = f_score
    term[:, 2] = torch.where(f_anc >= 1 << 31, f_anc - (1 << 32),
                             f_anc).to(i32)
    term[:, 3] = clipped.to(i32)
    term[:, 4] = levels
    term[:, 5] = (lanes & 0x7FFFFFFF).to(i32)
    term[:, 6] = (lanes >> 31).to(i32)
    term[done0] = 0
    return term


# ---------------------------------------------------------------------------
# One level on explicit state (the sharded paths' unit)
# ---------------------------------------------------------------------------


def ring_size(p: Penalties) -> int:
    """Score levels the explicit-state rings of `advance_torch` hold (the
    reference's wfa_jax.ring_size): every state keeps the M ring's depth."""
    return ring_sizes(p)[0]


def advance_torch(off, anc_v, anc_h, open_a, s: int, query, target, qlen,
                  tlen, axis_is_query, mid, K: int, R: int,
                  penalties: Penalties, kvec=None):
    """One score level on explicit state: the counterpart of
    wfa_jax._advance, in its layout and with its results bit for bit.

    off, anc_v, anc_h: (B, R, 5, K) int32 rings of offsets (NEG_I: none)
    and crossing anchors (-1: none) of the states M, I1, I2, D1, D2;
    open_a: (B, R, 4, K) int32 gap-open anchors (-1: none); slot s % R is
    level s. query/target: (B, L) uint8 byte rows (they stand where the
    reference has the `make_blocks` words; bytes past a length are never
    compared). qlen, tlen, mid: (B,) int32; axis_is_query: (B,) bool.
    kvec: optional (1, K) int32 diagonal of each lane (default lane - K//2);
    a diagonal-sharded shard passes its own window, halo lanes included.
    Returns (off, anc_v, anc_h, open_a, done, final_pv, final_ph): new
    rings (the inputs are not written) and, per problem, whether the M
    offset on the end diagonal reached qlen, with that cell's anchor.
    Lanes past the band's ends read as none. `sweep_torch` is the sweep
    kernel's plain version and keeps the kernel's narrow ring words; this
    keeps the reference's int32 words."""
    p = penalties
    x, o1, e1, o2, e2 = (p.mismatch, p.gap_opening1, p.gap_extension1,
                         p.gap_opening2, p.gap_extension2)
    i32 = torch.int32
    B = off.shape[0]
    dev = off.device
    if kvec is None:
        kvec = (torch.arange(K, dtype=i32, device=dev) - K // 2)[None, :]
    neg = torch.full((B, K), NEG_I, dtype=i32, device=dev)
    uns = torch.full((B, K), -1, dtype=i32, device=dev)
    axis_q = axis_is_query[:, None]
    midc = mid[:, None]

    def land(score, state, arr, fill):
        return fill if score < 0 else arr[:, score % R, state, :]

    def sr(a, fill):      # value at k-1
        return torch.cat([fill[:, :1], a[:, :-1]], dim=1)

    def sl(a, fill):      # value at k+1
        return torch.cat([a[:, 1:], fill[:, :1]], dim=1)

    def gap_wave(open_score, ext_score, ext_state, gslot, is_ins):
        sh = sr if is_ins else sl
        m_src = sh(land(open_score, M_, off, neg), neg)
        g_src = sh(land(ext_score, ext_state, off, neg), neg)
        mp_v = sh(land(open_score, M_, anc_v, uns), uns)
        mp_h = sh(land(open_score, M_, anc_h, uns), uns)
        gp_v = sh(land(ext_score, ext_state, anc_v, uns), uns)
        gp_h = sh(land(ext_score, ext_state, anc_h, uns), uns)
        g_open = sh(land(ext_score, gslot, open_a, uns), uns)
        use_open = m_src >= g_src                  # tie -> open
        base = torch.maximum(m_src, g_src)
        valid = base > NEG_I
        new_off = torch.where(valid, base + (1 if is_ins else 0), neg)
        new_pv = torch.where(use_open, mp_v, gp_v)
        new_ph = torch.where(use_open, mp_h, gp_h)
        opened = m_src if is_ins else m_src - (kvec + 1)
        new_open = torch.where(valid, torch.where(use_open, opened, g_open),
                               uns)
        if is_ins:
            crossed = (axis_q & (new_pv == -1) & valid
                       & (new_off == midc + 1))
            new_pv = torch.where(crossed, new_off - kvec, new_pv)
            new_ph = torch.where(crossed, new_open, new_ph)
        else:
            crossed = (~axis_q & (new_pv == -1) & valid
                       & (new_off - kvec == midc + 1))
            new_pv = torch.where(crossed, new_open, new_pv)
            new_ph = torch.where(crossed, new_off, new_ph)
        return new_off, new_pv, new_ph, new_open

    i1 = gap_wave(s - o1 - e1, s - e1, I1_, 0, True)
    i2 = gap_wave(s - o2 - e2, s - e2, I2_, 1, True)
    d1 = gap_wave(s - o1 - e1, s - e1, D1_, 2, False)
    d2 = gap_wave(s - o2 - e2, s - e2, D2_, 3, False)

    mm = land(s - x, M_, off, neg)
    mm = torch.where(mm > NEG_I, mm + 1, neg)
    mx_pv = land(s - x, M_, anc_v, uns)
    crossed = ((mx_pv == -1) & (mm > NEG_I)
               & ((axis_q & (mm == midc + 1))
                  | (~axis_q & (mm - kvec == midc + 1))))
    m_off = mm
    m_pv = torch.where(crossed, mm - kvec - 1, mx_pv)
    m_ph = torch.where(crossed, mm - 1, land(s - x, M_, anc_h, uns))
    for c_off, c_pv, c_ph, _ in (i1, i2, d1, d2):   # first strict maximum
        better = c_off > m_off
        m_off = torch.where(better, c_off, m_off)
        m_pv = torch.where(better, c_pv, m_pv)
        m_ph = torch.where(better, c_ph, m_ph)
    v = m_off - kvec
    okb = ((m_off >= 0) & (m_off <= qlen[:, None]) & (v >= 0)
           & (v <= tlen[:, None]))
    m_off = torch.where(okb, m_off, neg)
    m_pv = torch.where(okb, m_pv, uns)
    m_ph = torch.where(okb, m_ph, uns)

    m_ext = _extend(m_off, query, target, kvec[0], qlen, tlen)
    live = m_off > NEG_I
    cr_t = (~axis_q & (m_pv == -1) & live & (m_off - kvec <= midc)
            & (m_ext - kvec > midc))
    m_pv = torch.where(cr_t, midc.expand(B, K), m_pv)
    m_ph = torch.where(cr_t, midc + kvec, m_ph)
    cr_q = axis_q & (m_pv == -1) & live & (m_off <= midc) & (m_ext > midc)
    m_pv = torch.where(cr_q, midc - kvec, m_pv)
    m_ph = torch.where(cr_q, midc.expand(B, K), m_ph)

    slot = s % R
    off, anc_v, anc_h, open_a = (a.clone() for a in (off, anc_v, anc_h,
                                                     open_a))
    off[:, slot] = torch.stack([m_ext, i1[0], i2[0], d1[0], d2[0]], dim=1)
    anc_v[:, slot] = torch.stack([m_pv, i1[1], i2[1], d1[1], d2[1]], dim=1)
    anc_h[:, slot] = torch.stack([m_ph, i1[2], i2[2], d1[2], d2[2]], dim=1)
    open_a[:, slot] = torch.stack([i1[3], i2[3], d1[3], d2[3]], dim=1)

    # the end diagonal's lane in this window (clipped into it)
    d_end = (qlen - tlen - kvec[0, 0]).clamp(0, K - 1).to(torch.int64)[:,
                                                                       None]
    final_off = m_ext.gather(1, d_end)[:, 0]
    done = final_off >= qlen
    return (off, anc_v, anc_h, open_a, done, m_pv.gather(1, d_end)[:, 0],
            m_ph.gather(1, d_end)[:, 0])


def term_lanes(term: np.ndarray) -> np.ndarray:
    """Per problem, the wavefront lanes its swept levels computed (term
    cols 5-6 of a `run_sweep` result brought to numpy) as int64."""
    return term[:, 5].astype(np.int64) + (term[:, 6].astype(np.int64) << 31)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("sweep_wfa")
    if not _lib_ready:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sweep_wfa_launch.restype = ci
        lib.sweep_wfa_launch.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci, ci,
                                         ci, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.sweep_wfa_active_clusters.restype = ci
        lib.sweep_wfa_active_clusters.argtypes = [ci] * 7
        lib.sweep_wfa_error_string.restype = ctypes.c_char_p
        lib.sweep_wfa_error_string.argtypes = [ci]
        _lib_ready = True
    return lib


def run_sweep(query: torch.Tensor, target: torch.Tensor, par: torch.Tensor,
              seed_off: torch.Tensor, seed_anc: torch.Tensor, *,
              penalties: Penalties, K: int, max_s: int) -> torch.Tensor:
    """One batched sweep. query/target (B, L) uint8 rows padded with 0x01 /
    0x02 at least SEQ_PAD bytes past the lengths, L a multiple of 4; par
    (B, 8) int32 (qlen, tlen, axis_is_query, mid, done0; lengths below
    65535); seed_off / seed_anc (B, K) int32 score-0 M wavefront (each
    offset NEG_I or in [0, 65534]) and its packed anchors (the uint32 bit
    patterns). Returns term (B, 8) int32: finished, score,
    packed anchor, clipped, swept levels, wavefront lanes (`term_lanes`).

    CUDA tensors launch the hand-written kernel that `kernel_choice`
    names on the current stream (asynchronously) and raise if the launch
    is refused; CPU tensors run the plain version."""
    B, L = query.shape
    for name, ten, dt, shape in (
            ("query", query, torch.uint8, (B, L)),
            ("target", target, torch.uint8, (B, L)),
            ("par", par, torch.int32, (B, NPAR)),
            ("seed_off", seed_off, torch.int32, (B, K)),
            ("seed_anc", seed_anc, torch.int32, (B, K))):
        if ten.dtype != dt or tuple(ten.shape) != shape:
            raise ValueError(f"{name} must be {dt} {shape}, got {ten.dtype} "
                             f"{tuple(ten.shape)}")
        if ten.device != query.device:
            raise ValueError(f"{name} lies on {ten.device}, query on "
                             f"{query.device}")
    if L % 4 or K < 2 or K % 2 or max_s < 0:
        raise ValueError(f"unsupported shape L={L} K={K} max_s={max_s}")
    if query.device.type == "cpu":
        return sweep_torch(query, target, par, seed_off, seed_anc,
                           penalties=penalties, K=K, max_s=max_s)
    if query.device.type != "cuda":
        raise ValueError(f"run_sweep: no kernel for device {query.device}")
    return _launch(query, target, par, seed_off, seed_anc, penalties, K,
                   max_s, kernel_choice(penalties, K))


def _launch(query, target, par, seed_off, seed_anc, p: Penalties, K: int,
            max_s: int, cluster: int) -> torch.Tensor:
    """Launch the kernel `cluster` names (`kernel_choice`) on checked CUDA
    tensors. chip_smoke.py also calls it with cluster = 0 at shapes that
    take the shared-memory kernel, to time the global-ring kernel beside
    it."""
    global LAUNCHES
    B, L = query.shape
    dev = query.device
    query, target, par, seed_off, seed_anc = (
        a.contiguous() for a in (query, target, par, seed_off, seed_anc))
    term = torch.empty((B, NTERM), dtype=torch.int32, device=dev)
    scratch = None
    if cluster == 0:
        # ring scratch is freed to the caching allocator on return;
        # launches on one stream run in order, so the next sweep reuses it
        scratch = torch.empty((B, scratch_words(p, K)), dtype=torch.int32,
                              device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sweep_wfa_launch(
            query.data_ptr(), target.data_ptr(), B, L, par.data_ptr(),
            seed_off.data_ptr(), seed_anc.data_ptr(), K, max_s, p.mismatch,
            p.gap_opening1, p.gap_extension1, p.gap_opening2,
            p.gap_extension2, cluster,
            None if scratch is None else scratch.data_ptr(),
            term.data_ptr(), stream)
    if err:
        msg = lib.sweep_wfa_error_string(err).decode()
        raise RuntimeError(f"sweep_wfa launch failed (B={B} K={K} L={L}, "
                           f"{kernel_name(cluster)}): {msg}")
    with _launch_lock:
        LAUNCHES += 1
    return term


def active_clusters(p: Penalties, K: int, cluster: int | None = None) -> int:
    """Clusters (problems) of the shared-memory kernel the current card
    holds at once at this shape when a batch is large enough to fill it,
    as cudaOccupancyMaxActiveClusters says; for the cluster size
    `kernel_choice` names, or a given one."""
    if cluster is None:
        cluster = kernel_choice(p, K)
    if cluster == 0:
        raise ValueError(f"K={K} takes the global-ring kernel")
    lib = _lib()
    n = lib.sweep_wfa_active_clusters(
        K, p.mismatch, p.gap_opening1, p.gap_extension1, p.gap_opening2,
        p.gap_extension2, cluster)
    if n < 0:
        raise RuntimeError("sweep_wfa occupancy query failed: "
                           + lib.sweep_wfa_error_string(-n).decode())
    return n


# ---------------------------------------------------------------------------
# Batch front end (numpy in, numpy out)
# ---------------------------------------------------------------------------


class ExactSweeps:
    """Batched sweeps on one device: PallasSweeps' `sweep` with one
    launch per batch."""

    def __init__(self, penalties: Penalties, device):
        self.p = penalties
        self.device = torch.device(device)
        self.levels = 0      # swept levels of all sweeps so far
        self.lanes = 0       # wavefront lanes those levels computed

    @classmethod
    def from_reference(cls, ref, device):
        """The port's sweeps with the penalties of a reference
        wfmash_tpu PallasSweeps."""
        return cls(ref.p, device)

    def sweep(self, query: np.ndarray, target: np.ndarray,
              qlen: np.ndarray, tlen: np.ndarray,
              axis_is_query: np.ndarray, mid: np.ndarray,
              seed_off: np.ndarray, seed_anc: np.ndarray,
              done0: np.ndarray, max_s: int, K: int):
        """query/target: (B, L) u8, padded with sentinel bytes 0x01/0x02.
        seed_off/seed_anc: (B, K) score-0 M wavefront (+packed anchors).
        Returns (f_score, f_pv, f_ph, finished, clipped) as numpy arrays;
        `clipped` marks problems whose live cells touched the diagonal
        band edge at or before their finish (span-escalation signal)."""
        B = query.shape[0]
        if np.any(qlen >= 65535) or np.any(tlen >= 65535):
            raise ValueError("the sweep requires lengths < 65535")
        seed_off = np.asarray(seed_off)
        if np.any((seed_off > NEG_I) & ((seed_off < 0) | (seed_off > 65534))):
            raise ValueError("seed offsets must be NEG_I or in [0, 65534]")
        done0 = np.asarray(done0, bool)
        # problems swept at this span (the span ladder's reach)
        perf.add(f"align.sweep_problems.K{K}", int((~done0).sum()))
        if done0.all():
            return (np.zeros(B, np.int32), np.full(B, -1, np.int32),
                    np.full(B, -1, np.int32), done0.copy(),
                    np.zeros(B, bool))
        need = int(max(qlen.max(), tlen.max())) + SEQ_PAD
        query, target = _pad_rows(query, need, 0x01), \
            _pad_rows(target, need, 0x02)
        par = np.zeros((B, NPAR), np.int32)
        par[:, 0] = qlen
        par[:, 1] = tlen
        par[:, 2] = np.asarray(axis_is_query, bool)
        par[:, 3] = mid
        par[:, 4] = done0
        dev = self.device
        # align.sweep: host wall from upload to readback (the readback
        # waits for the kernel)
        with perf.span("align.sweep"):
            term = run_sweep(
                torch.from_numpy(query).to(dev),
                torch.from_numpy(target).to(dev),
                torch.from_numpy(par).to(dev),
                torch.from_numpy(np.ascontiguousarray(seed_off, np.int32))
                .to(dev),
                torch.from_numpy(np.ascontiguousarray(seed_anc, np.uint32)
                                 .view(np.int32)).to(dev),
                penalties=self.p, K=K, max_s=int(max_s)).cpu().numpy()
        lanes = int(term_lanes(term).sum())
        self.levels += int(term[:, 4].astype(np.int64).sum())
        self.lanes += lanes
        # run_sweep calls (a kernel launch on the card) and the lanes the
        # kernel counted: with the launches' device time, the share of its
        # operations bound
        perf.add("align.sweep.launches", 1)
        perf.add("align.sweep.lanes", lanes)
        fin = term[:, 0] != 0
        finished = done0 | fin
        clipped = term[:, 3] != 0
        f_score = np.where(fin, term[:, 1], 0).astype(np.int32)
        f_anc = np.where(fin, term[:, 2].view(np.uint32),
                         np.uint32(UNSET32)).astype(np.uint32)
        unset = f_anc == np.uint32(UNSET32)
        f_pv = np.where(unset, -1, (f_anc >> 16).astype(np.int64))
        f_ph = np.where(unset, -1, (f_anc & 0xFFFF).astype(np.int64))
        return (f_score, f_pv.astype(np.int32), f_ph.astype(np.int32),
                finished, clipped)


def _pad_rows(a: np.ndarray, need: int, pad: int) -> np.ndarray:
    """(B, L) u8 rows widened with `pad` to at least `need` columns and a
    multiple of 4 (rows already wide enough are returned as they are)."""
    L = a.shape[1]
    if L >= need and L % 4 == 0:
        return np.ascontiguousarray(a)
    out = np.full((a.shape[0], -(-max(L, need) // 4) * 4), pad, np.uint8)
    out[:, :L] = a
    return out
