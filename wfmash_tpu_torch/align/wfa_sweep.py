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
import time

import numpy as np
import torch

from .. import _build
from ..utils import perf
from .wfa_np import Penalties

NEG_I = -(1 << 28)
UNSET32 = 0xFFFFFFFF

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
    """int32 words of ring scratch one problem needs."""
    rm, rg = ring_sizes(p)
    return (2 * rm + 12 * rg) * K


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
    off_m = [neg] * Rm
    anc_m = [uns] * Rm
    off_g = [[neg] * Rg for _ in range(4)]
    anc_g = [[uns] * Rg for _ in range(4)]
    open_g = [[minus1] * Rg for _ in range(4)]
    off_m[0] = seed_off.to(i32)
    anc_m[0] = seed_anc.to(i64) & UNSET32

    def land_m(s):
        return (off_m[s % Rm], anc_m[s % Rm]) if s >= 0 else (neg, uns)

    def land_g(g, s):
        if s < 0:
            return neg, uns, minus1
        return off_g[g][s % Rg], anc_g[g][s % Rg], open_g[g][s % Rg]

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

        off_m[s % Rm], anc_m[s % Rm] = m_ext, m_anc
        for g, (o, a, op) in enumerate((i1, i2, d1, d2)):
            off_g[g][s % Rg], anc_g[g][s % Rg], open_g[g][s % Rg] = o, a, op

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
                                         ci, ci, ci, ci, ci, vp, vp, vp]
        lib.sweep_wfa_error_string.restype = ctypes.c_char_p
        lib.sweep_wfa_error_string.argtypes = [ci]
        _lib_ready = True
    return lib


def run_sweep(query: torch.Tensor, target: torch.Tensor, par: torch.Tensor,
              seed_off: torch.Tensor, seed_anc: torch.Tensor, *,
              penalties: Penalties, K: int, max_s: int) -> torch.Tensor:
    """One batched sweep. query/target (B, L) uint8 rows padded with 0x01 /
    0x02 at least SEQ_PAD bytes past the lengths, L a multiple of 4; par
    (B, 8) int32 (qlen, tlen, axis_is_query, mid, done0); seed_off /
    seed_anc (B, K) int32 score-0 M wavefront and its packed anchors
    (the uint32 bit patterns). Returns term (B, 8) int32: finished, score,
    packed anchor, clipped, swept levels, wavefront lanes (`term_lanes`).

    CUDA tensors launch the hand-written kernel on the current stream
    (asynchronously) and raise if the launch is refused; CPU tensors run
    the plain version."""
    global LAUNCHES
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
    dev = query.device
    query, target, par, seed_off, seed_anc = (
        a.contiguous() for a in (query, target, par, seed_off, seed_anc))
    term = torch.empty((B, NTERM), dtype=torch.int32, device=dev)
    # ring scratch is freed to the caching allocator on return; launches
    # on one stream run in order, so the next sweep reuses it safely
    scratch = torch.empty((B, scratch_words(penalties, K)),
                          dtype=torch.int32, device=dev)
    p = penalties
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sweep_wfa_launch(
            query.data_ptr(), target.data_ptr(), B, L, par.data_ptr(),
            seed_off.data_ptr(), seed_anc.data_ptr(), K, max_s, p.mismatch,
            p.gap_opening1, p.gap_extension1, p.gap_opening2,
            p.gap_extension2, scratch.data_ptr(), term.data_ptr(), stream)
    if err:
        msg = lib.sweep_wfa_error_string(err).decode()
        raise RuntimeError(f"sweep_wfa launch failed (B={B} K={K} L={L}): "
                           f"{msg}")
    with _launch_lock:
        LAUNCHES += 1
    return term


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
        done0 = np.asarray(done0, bool)
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
        t0 = time.monotonic()
        term = run_sweep(
            torch.from_numpy(query).to(dev), torch.from_numpy(target).to(dev),
            torch.from_numpy(par).to(dev),
            torch.from_numpy(np.ascontiguousarray(seed_off, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(seed_anc, np.uint32)
                             .view(np.int32)).to(dev),
            penalties=self.p, K=K, max_s=int(max_s)).cpu().numpy()
        lanes = int(term_lanes(term).sum())
        self.levels += int(term[:, 4].astype(np.int64).sum())
        self.lanes += lanes
        # host wall from upload to readback (the readback waits for the
        # kernel), and the swept cells: wavefront lanes x 5 states
        perf.add("align.sweep_s", time.monotonic() - t0)
        perf.add("align.sweep_calls", 1)
        perf.add("align.sweep_cells", lanes * 5)
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
