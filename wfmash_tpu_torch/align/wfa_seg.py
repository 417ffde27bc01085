"""Full-history segment WFA on PyTorch and CUDA: kernel wrapper, plain
version and host solver.

Counterpart of wfmash_tpu/align/wfa_pallas_seg.py. Thousands of small
alignment problems (<= lseg bp a side, score < smax) are solved to a
complete CIGAR in one launch, with the same recurrences, tie-breaks and
I/O contract as the TPU kernel:

* `run_seg` takes the fused uint8 chunk buffer that `SegmentSolver.
  pack_chunk` builds (query nibbles | target nibbles | 16 little-endian
  int32 params per row) and returns `runs_full (B, maxr) int32` and
  `out16 (B, 16 + RUNS_CAP) int16` (term columns, then the runs compacted
  from each row's cursor). On a CUDA tensor it launches the hand-written
  kernel csrc/seg_wfa.cu; on a CPU tensor it runs `seg_sweep_torch`. The
  kernel keeps the sweep's lag window (the last max(x, o1+e1, o2+e2) + 1
  levels) in shared memory and writes the full int16 history to global
  scratch for its backtrace, which one warp runs; K must be a multiple
  of 32 there.
* `seg_sweep_torch` is the plain PyTorch version of the same function,
  vectorised over problems and diagonals level by level.
* `SegmentSolver`, `TieredSegmentSolver` and `_StreamSolve` are the
  reference's numpy host side (envelopes, certificates, tier cascade,
  streaming) with the launch replaced and each chunk packed in one
  native call (native/tierpack.cpp; `pack_chunk_py` is its spec); given
  a parallel.mesh.Mesh, a tier splits each chunk over its devices
  (`_run_seg_sharded`).

Two deliberate differences from the TPU kernel, both outside the PAF:

* Each problem stops at its own finish or score cap. The TPU kernel swept
  a group of problems in lockstep, so a capped problem whose peers were
  still running could finish above its cap there; here it reports
  `scorecap`. Every caller passes a cap the banded optimum cannot exceed
  or re-checks the score, so results are unchanged.
* term col 8 (swept levels) counts this problem's levels, not its group's.
  It feeds only the `align.device_cells` counter.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .. import _build
from ..native import pack_tier_chunk_native
from ..utils import perf
from .wfa_np import Penalties

NEG_I = -(1 << 28)
NEG16 = -2048          # int16 history sentinel for "unreachable"

OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3
OP_SENTINEL = 15
OP_CHARS = "=XID"

M_, I1_, I2_, D1_, D2_ = 0, 1, 2, 3, 4

NTERM = 16             # term columns at the head of each out16 row
RUNS_CAP = 128         # compacted runs per out16 row

# kernel launches made by run_seg (plain-version calls are not counted)
LAUNCHES = 0
_launch_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _unpack(x4: torch.Tensor, L: int) -> torch.Tensor:
    """(B, L//2) nibble-packed u8 -> (B, L) 4-bit codes (low nibble first)."""
    return torch.stack([x4 & 15, x4 >> 4], dim=-1).reshape(x4.shape[0], L)


def _params(pb: torch.Tensor) -> torch.Tensor:
    """(B, 64) little-endian bytes -> (B, 16) int32."""
    w = pb.to(torch.int64).reshape(-1, 16, 4)
    u = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _to16(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v <= NEG_I // 2, NEG16, v).to(torch.int16)


def _from16(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int32)
    return torch.where(v == NEG16, NEG_I, v)


_EXT_WINDOW = 32      # positions compared per step of the plain extension


def _extend(h, rows, q, t, kv, qlen, tlen, L):
    """Match extension of offsets h (n, K) on rows `rows` of the (B, L)
    code arrays q/t: advance while codes agree, _EXT_WINDOW positions per
    step, then clamp to the placed ends (as the TPU kernel's `extend`)."""
    window = _EXT_WINDOW
    out = h.clone()
    r, k = torch.nonzero(h > NEG_I, as_tuple=True)
    hh = h[r, k]
    g = rows[r]
    kk = kv[k]
    ar = torch.arange(window, device=h.device, dtype=h.dtype)
    while r.numel():
        pos = hh[:, None] + ar
        vpos = pos - kk[:, None]
        inb = (pos >= 0) & (pos < L) & (vpos >= 0) & (vpos < L)
        qv = q[g[:, None], pos.clamp(0, L - 1)]
        tv = t[g[:, None], vpos.clamp(0, L - 1)]
        run = (inb & (qv == tv)).to(torch.int32).cumprod(1).sum(
            1, dtype=torch.int32)
        hh = hh + run
        out[r, k] = hh
        full = run == window
        r, k, hh, g, kk = r[full], k[full], hh[full], g[full], kk[full]
    v = out - kv
    over = torch.clamp_min(
        torch.maximum(out - qlen[:, None], v - tlen[:, None]), 0)
    return torch.where(out > NEG_I, out - over, out)


def _accept(m, kv, lane, qlen, tlen, te, qe):
    """(done, lane*, h*) per row: the smallest accepting diagonal
    (wfa_np.is_done scans k ascending) and its offset."""
    K = m.shape[1]
    v = m - kv
    ok = m > NEG_I
    c1 = ok & (m == qlen[:, None]) & (tlen[:, None] - v <= te[:, None]) \
        & (v >= 0)
    c2 = ok & (v == tlen[:, None]) & (qlen[:, None] - m <= qe[:, None]) \
        & (m >= 0)
    lane_a = torch.where(c1 | c2, lane, K).min(dim=1).values
    done = lane_a < K
    h_a = m.gather(1, lane_a.clamp(max=K - 1)[:, None])[:, 0]
    return done, torch.where(done, lane_a, 0), torch.where(done, h_a, 0)


def seg_sweep_torch(buf: torch.Tensor, *, penalties: Penalties, K: int,
                    smax: int, maxr: int):
    """Plain PyTorch version of the segment kernel on any device: same
    inputs and outputs as `run_seg`. Vectorised over (problems, lanes);
    each problem freezes once it finishes or reaches its cap."""
    p = penalties
    x, o1, e1, o2, e2 = (p.mismatch, p.gap_opening1, p.gap_extension1,
                         p.gap_opening2, p.gap_extension2)
    dev = buf.device
    i32 = torch.int32
    B, W = buf.shape
    L = W - 64
    Lh = L // 2
    q = _unpack(buf[:, :Lh], L)
    t = _unpack(buf[:, Lh:L], L)
    par = _params(buf[:, L:])
    qlen, tlen, S, c, tb, qb, te, qe, cap = (par[:, j] for j in range(9))
    lane = torch.arange(K, device=dev, dtype=i32)
    kv = lane - K // 2
    rows = torch.arange(B, device=dev)

    # ---- level 0: seeds on the begin-free diagonals ----------------------
    ktrue = kv[None, :] - c[:, None]
    seed = torch.where((ktrue <= 0) & (-ktrue <= tb[:, None]), S[:, None],
                       NEG_I)
    seed = torch.where((ktrue > 0) & (ktrue <= qb[:, None]),
                       S[:, None] + ktrue, seed)
    m0 = _extend(seed, rows, q, t, kv, qlen, tlen, L)
    done, lane_a, h_a = _accept(m0, kv, lane, qlen, tlen, te, qe)
    s_final = torch.zeros(B, dtype=i32, device=dev)
    edge = torch.zeros(B, dtype=torch.bool, device=dev)
    levels = torch.ones(B, dtype=i32, device=dev)

    # History only for the rows that sweep past level 0 (hidx maps a row
    # to its history slot): a row done at level 0 backtraces through the
    # seed branch alone, which reads no history.
    act = rows[~done]
    hidx = torch.full((B,), -1, dtype=torch.int64, device=dev)
    hidx[act] = torch.arange(act.numel(), device=dev)
    hist = torch.full((5, smax, act.numel(), K), NEG16, dtype=torch.int16,
                      device=dev)
    hist[M_, 0] = _to16(m0[act])

    # ---- forward sweep over the rows still running ------------------------
    for s in range(1, smax):
        n = act.numel()
        if n == 0:
            break
        hact = hidx[act]
        negcol = torch.full((n, 1), NEG_I, dtype=i32, device=dev)

        def hr(st, lvl):
            if lvl < 0:
                return torch.full((n, K), NEG_I, dtype=i32, device=dev)
            return _from16(hist[st, lvl].index_select(0, hact))

        def sr(a):  # value at k-1
            return torch.cat([negcol, a[:, :-1]], dim=1)

        def sl(a):  # value at k+1
            return torch.cat([a[:, 1:], negcol], dim=1)

        m_x = hr(M_, s - x)
        m_o1 = hr(M_, s - o1 - e1)
        m_o2 = hr(M_, s - o2 - e2)
        i1b = torch.maximum(sr(m_o1), sr(hr(I1_, s - e1)))
        i1 = torch.where(i1b > NEG_I, i1b + 1, NEG_I)
        i2b = torch.maximum(sr(m_o2), sr(hr(I2_, s - e2)))
        i2 = torch.where(i2b > NEG_I, i2b + 1, NEG_I)
        d1 = torch.maximum(sl(m_o1), sl(hr(D1_, s - e1)))
        d2 = torch.maximum(sl(m_o2), sl(hr(D2_, s - e2)))
        mm = torch.where(m_x > NEG_I, m_x + 1, NEG_I)
        m_off = torch.maximum(torch.maximum(torch.maximum(mm, i1),
                                            torch.maximum(i2, d1)), d2)
        ql, tl = qlen[act], tlen[act]
        v = m_off - kv
        okb = (m_off >= 0) & (m_off <= ql[:, None]) & (v >= 0) \
            & (v <= tl[:, None])
        m_off = torch.where(okb, m_off, NEG_I)
        m_ext = _extend(m_off, act, q, t, kv, ql, tl, L)
        for st, val in ((M_, m_ext), (I1_, i1), (I2_, i2), (D1_, d1),
                        (D2_, d2)):
            hist[st, s].index_copy_(0, hact, _to16(val))
        edge[act] |= (m_ext[:, 0] > NEG_I) | (m_ext[:, K - 1] > NEG_I)
        d, la, ha = _accept(m_ext, kv, lane, ql, tl, te[act], qe[act])
        levels[act] = s + 1
        fin = act[d]
        done[fin] = True
        s_final[fin] = s
        lane_a[fin] = la[d]
        h_a[fin] = ha[d]
        ca = cap[act]
        act = act[~d & ~((ca > 0) & (ca <= s))]

    # ---- backtrace: the done rows, by descending score level --------------
    runs = torch.full((B, maxr), OP_SENTINEL << 13, dtype=i32, device=dev)
    cur = torch.full((B,), maxr - 1, dtype=i32, device=dev)
    clean = torch.ones(B, dtype=torch.bool, device=dev)
    dr = rows[done]
    if dr.numel():
        nd = dr.numel()
        ones = torch.ones(nd, dtype=i32, device=dev)
        bcur = cur[dr]

        def emit(mask, op, cnt):
            nonlocal bcur
            m2 = mask & (cnt > 0)
            p1 = bcur + 1
            prev = runs[dr, p1.clamp(0, maxr - 1)]
            same = m2 & (p1 >= 0) & (p1 < maxr) & ((prev >> 13) == op)
            new = m2 & ~same
            i = torch.nonzero(same, as_tuple=True)[0]
            runs[dr[i], p1[i]] = prev[i] + cnt[i]
            i = torch.nonzero(new & (bcur >= 0) & (bcur < maxr),
                              as_tuple=True)[0]
            runs[dr[i], bcur[i]] = (op << 13) | cnt[i]
            bcur = bcur - new.to(i32)

        hdr = hidx[dr]

        def pick(st, lvl, lanes):
            if lvl < 0 or hist.shape[2] == 0:
                return torch.full((nd,), NEG_I, dtype=i32, device=dev)
            val = _from16(hist[st, lvl, hdr.clamp(min=0),
                               lanes.clamp(0, K - 1)])
            return torch.where((lanes >= 0) & (lanes < K) & (hdr >= 0), val,
                               NEG_I)

        qc, tc, cc, sc = qlen[dr], tlen[dr], c[dr], S[dr]
        bts, btk, bth = s_final[dr], lane_a[dr], h_a[dr]
        btst = torch.zeros(nd, dtype=i32, device=dev)
        bact = torch.ones(nd, dtype=torch.bool, device=dev)
        btok = torch.ones(nd, dtype=torch.bool, device=dev)
        # trailing free gap: the accepted cell may sit short of the corner
        v_acc = bth - (btk - K // 2)
        trail_d = (bth == qc) & (v_acc < tc)
        emit(trail_d, OP_D, tc - v_acc)
        emit(~trail_d & (v_acc == tc) & (bth < qc), OP_I, qc - bth)
        while bool(bact.any()):
            srev = int(bts[bact].max())
            if srev < 0:
                break
            at = bact & (bts == srev)
            # -- M resolution: priority X > I1 > I2 > D1 > D2 --
            mM = at & (btst == M_)
            cx = pick(M_, srev - x, btk)
            cx = torch.where(cx > NEG_I, cx + 1, NEG_I)
            ci1, ci2 = pick(I1_, srev, btk), pick(I2_, srev, btk)
            cd1, cd2 = pick(D1_, srev, btk), pick(D2_, srev, btk)
            pre = torch.maximum(torch.maximum(torch.maximum(cx, ci1),
                                              torch.maximum(ci2, cd1)), cd2)
            mM_seed = mM if srev == 0 else torch.zeros_like(mM)
            mM_in = torch.zeros_like(mM) if srev == 0 else mM
            bad_m = mM_in & (pre <= NEG_I)
            mM_in = mM_in & ~bad_m
            emit(mM_in, OP_EQ, bth - pre)
            wx = mM_in & (cx == pre)
            wi1 = mM_in & ~wx & (ci1 == pre)
            wi2 = mM_in & ~wx & ~wi1 & (ci2 == pre)
            wd1 = mM_in & ~wx & ~wi1 & ~wi2 & (cd1 == pre)
            wd2 = mM_in & ~wx & ~wi1 & ~wi2 & ~wd1 & (cd2 == pre)
            emit(wx, OP_X, ones)
            bts = torch.where(wx, srev - x, bts)
            bth = torch.where(wx, pre - 1, bth)
            bth = torch.where(wi1 | wi2 | wd1 | wd2, pre, bth)
            for w_, st in ((wi1, I1_), (wi2, I2_), (wd1, D1_), (wd2, D2_)):
                btst = torch.where(w_, st, btst)
            # leading: extension down to the seed, then the free begin gap
            kt_s = (btk - K // 2) - cc
            emit(mM_seed, OP_EQ, bth - sc - torch.clamp_min(kt_s, 0))
            emit(mM_seed & (kt_s < 0), OP_D, -kt_s)
            emit(mM_seed & (kt_s > 0), OP_I, kt_s)
            bact = bact & ~(mM_seed | bad_m)
            btok = btok & ~bad_m
            # -- gap resolution at the same level: open before extend --
            atg = bact & (bts == srev)
            for st, ins, o_, e_ in ((I1_, True, o1, e1), (I2_, True, o2, e2),
                                    (D1_, False, o1, e1),
                                    (D2_, False, o2, e2)):
                mG = atg & (btst == st)
                kd = btk + (-1 if ins else 1)
                want = bth - 1 if ins else bth
                open_ = pick(M_, srev - o_ - e_, kd)
                ext = pick(st, srev - e_, kd)
                use_open = (open_ > NEG_I) & (open_ == want)
                use_ext = (ext > NEG_I) & (ext == want)
                emit(mG, OP_I if ins else OP_D, ones)
                g_open = mG & use_open
                g_ext = mG & ~use_open & use_ext
                g_bad = mG & ~use_open & ~use_ext
                bts = torch.where(g_open, srev - o_ - e_, bts)
                bts = torch.where(g_ext, srev - e_, bts)
                if ins:
                    bth = torch.where(g_open | g_ext, bth - 1, bth)
                btk = torch.where(g_open | g_ext, kd, btk)
                btst = torch.where(g_open, M_, btst)
                bact = bact & ~g_bad
                btok = btok & ~g_bad
        cur[dr] = bcur
        clean[dr] = btok & ~bact

    term = torch.zeros((B, NTERM), dtype=i32, device=dev)
    term[:, 0] = done.to(i32)
    term[:, 1] = torch.where(done, s_final, 0)
    term[:, 2] = (~done).to(i32)
    term[:, 3] = edge.to(i32)
    term[:, 4] = cur
    term[:, 5] = clean.to(i32)
    term[:, 6] = lane_a
    term[:, 7] = h_a
    term[:, 8] = levels
    ncap = min(maxr, RUNS_CAP)
    idx = (cur[:, None] + 1 + torch.arange(ncap, device=dev, dtype=i32))
    idx = idx.clamp(0, maxr - 1).to(torch.int64)
    runs_c = runs.gather(1, idx).to(torch.int16)
    return runs, torch.cat([term.to(torch.int16), runs_c], dim=1)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_lib_ready = False


def _lib():
    global _lib_ready
    lib = _build.load("seg_wfa")
    if not _lib_ready:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.seg_wfa_launch.restype = ci
        lib.seg_wfa_launch.argtypes = [vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                       ci, ci, vp, vp, vp, vp]
        lib.seg_wfa_error_string.restype = ctypes.c_char_p
        lib.seg_wfa_error_string.argtypes = [ci]
        _lib_ready = True
    return lib


def run_seg(buf: torch.Tensor, *, penalties: Penalties, K: int, smax: int,
            maxr: int):
    """(B, L//2 + L//2 + 64) u8 chunk buffer -> (runs_full (B, maxr) i32,
    out16 (B, 16 + min(maxr, RUNS_CAP)) i16).

    A CUDA tensor launches the hand-written kernel on the current stream
    (asynchronously) and raises if the launch is refused; a CPU tensor
    runs the plain version."""
    global LAUNCHES
    if buf.dtype != torch.uint8 or buf.dim() != 2:
        raise ValueError(f"chunk buffer must be 2-D uint8, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    B, W = buf.shape
    L = W - 64
    if L <= 0 or L % 2:
        raise ValueError(f"chunk row of {W} bytes: need an even sequence "
                         "length plus 64 parameter bytes")
    if not (2 <= K <= 1024 and K % 2 == 0) or smax < 1 or maxr < 1:
        raise ValueError(f"unsupported shape K={K} smax={smax} maxr={maxr}")
    if buf.device.type == "cpu":
        return seg_sweep_torch(buf, penalties=penalties, K=K, smax=smax,
                               maxr=maxr)
    if buf.device.type != "cuda":
        raise ValueError(f"run_seg: no kernel for device {buf.device}")
    if K % 32:
        raise ValueError(f"the kernel takes K in multiples of 32, got {K}")
    buf = buf.contiguous()
    dev = buf.device
    ncap = min(maxr, RUNS_CAP)
    runs_full = torch.empty((B, maxr), dtype=torch.int32, device=dev)
    out16 = torch.empty((B, NTERM + ncap), dtype=torch.int16, device=dev)
    # scratch is freed to the caching allocator on return; launches on one
    # stream run in order, so the next chunk reuses it safely
    hist = torch.empty((B, 5, smax, K), dtype=torch.int16, device=dev)
    p = penalties
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seg_wfa_launch(
            buf.data_ptr(), B, L, K, smax, maxr, p.mismatch, p.gap_opening1,
            p.gap_extension1, p.gap_opening2, p.gap_extension2,
            hist.data_ptr(), runs_full.data_ptr(), out16.data_ptr(), stream)
    if err:
        msg = lib.seg_wfa_error_string(err).decode()
        raise RuntimeError(f"seg_wfa launch failed (B={B} K={K} L={L} "
                           f"smax={smax}): {msg}")
    with _launch_lock:
        LAUNCHES += 1
    return runs_full, out16


# ---------------------------------------------------------------------------
# Host solver (numpy; the reference's, with the launch replaced)
# ---------------------------------------------------------------------------


def _run_seg_sharded(buf: np.ndarray, n_rows: int, devices, **kw):
    """One packed chunk over several devices: the reference's
    _run_seg_sharded. The rows are cut into len(devices) contiguous
    ranges, one a device in mesh order; each range that holds one of the
    chunk's n_rows job rows is uploaded to its device and launched there
    with run_seg (a range of padding rows alone is not launched: no
    caller reads its rows). Every launch goes out before any result is
    read. Returns (runs_full, out16) as lists of the launched ranges'
    outputs, in row order; a failed launch raises."""
    per = buf.shape[0] // len(devices)
    runs, out16 = [], []
    for i, dev in enumerate(devices):
        if i * per >= n_rows:
            break
        r, o = run_seg(torch.from_numpy(buf[i * per:(i + 1) * per]).to(dev),
                       **kw)
        runs.append(r)
        out16.append(o)
    return runs, out16


def _host(out) -> np.ndarray:
    """A chunk output, one tensor or a list of a sharded launch's tensors
    in row order, as one numpy array."""
    if isinstance(out, list):
        return torch.cat([t.cpu() for t in out]).numpy()
    return out.cpu().numpy()


def _job_parts(job):
    """Normalize a job tuple: (q, t) or (q, t, ends_free) -> (q, t, ef)."""
    q, t = job[0], job[1]
    ef = job[2] if len(job) > 2 else None
    return q, t, ef


# 4-bit symbol codes for the packed upload: ACGTN, the two pad sentinels,
# and codes 5-13 spare for the per-chunk remap of other bytes (the kernel
# only tests equality, so any injective byte -> code map is exact)
_SYM_LUT = np.full(256, 0xFF, np.uint8)
for _i, _b in enumerate(b"ACGTN"):
    _SYM_LUT[_b] = _i
_SYM_LUT[0x01] = 14   # query pad (never matches target pad 15)
_SYM_LUT[0x02] = 15   # target pad


def _place4(codes_flat, lens, starts, B, L, pad_code):
    """Place nj concatenated code sequences into (B, L) rows (sequence j
    at column starts[j], pad elsewhere), nibble-packed to (B, L//2) u8."""
    nj = len(lens)
    out = np.full((B, L), pad_code, np.uint8)
    if nj:
        off = np.zeros(nj, np.int64)
        off[1:] = np.cumsum(lens[:-1])
        lens_a = np.asarray(lens, np.int64)
        ar = np.arange(L, dtype=np.int64)[None, :]
        sv = np.asarray(starts, np.int64)[:, None]
        pos = off[:, None] + (ar - sv)
        valid = (ar >= sv) & (ar < sv + lens_a[:, None])
        hi = max(len(codes_flat) - 1, 0)
        src = codes_flat[np.clip(pos, 0, hi)] if len(codes_flat) else \
            np.zeros((nj, L), np.uint8)
        out[:nj] = np.where(valid, src, pad_code)
    return out[:, 0::2] | (out[:, 1::2] << 4)


_BAND_MARGIN = 16    # lanes kept free of the diagonal interest range


class SegmentSolver:
    """Batched solver for small WFA problems (end-to-end and ends-free) on
    one device, or with each chunk split over a mesh's devices.

    solve(jobs) -> list of RLE CIGARs [(n, op)] (op in '=XID'), or None
    for problems the kernel cannot certify (too long, diagonal interest
    range wider than the band, score cap hit, band-edge contact above the
    certificate bound, or an inconsistent backtrace — the caller escalates
    those to the exact engine). Jobs are (q, t) or (q, t, EndsFree); the
    band is re-centred per problem by placing the sequences inside the
    padded rows (query at S, target at P, centre S - P).
    """

    def __init__(self, penalties: Penalties, device, PB: int = 16,
                 K: int = 256, smax: int = 256, lseg: int = 512,
                 groups: int = 64, mesh=None):
        self.p = penalties
        self.device = torch.device(device)
        self.PB = PB
        self.K = K
        self.smax = smax
        self.lseg = lseg
        self.maxr = 2 * smax + 128
        self.groups = groups
        self.max_call = groups * PB
        # gap_cost(0..K/2), the certificate bounds' one spelling for the
        # native pack (a margin never exceeds K/2)
        self.gap_table = np.array(
            [penalties.gap_cost(i) for i in range(K // 2 + 1)], np.int64)
        # optional parallel.mesh.Mesh: a chunk's rows split over the
        # devices of its first axis, as the reference shards a tier only
        # when that axis has more than one device and divides `groups`
        self.mesh = None
        if mesh is not None:
            n_dev = mesh.shape[mesh.axis_names[0]]
            if n_dev > 1 and groups % n_dev == 0:
                self.mesh = mesh

    def _envelope(self, m: int, n: int, ef):
        """Fit check. Returns (S, P, tb, qb, te, qe, cert_bound,
        always_cert) or None.

        Seed hull = score-0 diagonals [-tb, qb]; accept hull = accepting
        diagonals [m-n-qe, m-n+te] (wfa_np:140-159). Both hulls in band
        with margin M: any out-of-band path leaves and returns, cost >=
        2*gap_cost(M), certificate gated on band-edge contact. One hull
        truncated, the other (the anchor) in band: every path starts or
        ends in the anchor hull, cost >= gap_cost(M), certificate applied
        unconditionally. Both truncated: reject."""
        if ef is None:
            tb = qb = te = qe = 0
        else:
            tb = min(ef.target_begin, n)
            qb = min(ef.query_begin, m)
            te = ef.target_end
            qe = ef.query_end
        C = self.K // 2
        M = _BAND_MARGIN
        s_lo, s_hi = -tb, qb
        a_lo, a_hi = m - n - qe, m - n + te
        lo, hi = min(s_lo, a_lo), max(s_hi, a_hi)
        seeds_fit = s_hi - s_lo < self.K - 2 * M
        accepts_fit = a_hi - a_lo < self.K - 2 * M
        if hi - lo < self.K - 2 * M:
            cc = (lo + hi) // 2
            margin = C - max(hi - cc, cc - lo)
            cert_bound = 2 * self.p.gap_cost(margin)
            always = False
        elif accepts_fit:
            cc = (a_lo + a_hi) // 2
            margin = C - max(a_hi - cc, cc - a_lo)
            cert_bound = self.p.gap_cost(margin)
            always = True
        elif seeds_fit:
            cc = (s_lo + s_hi) // 2
            margin = C - max(s_hi - cc, cc - s_lo)
            cert_bound = self.p.gap_cost(margin)
            always = True
        else:
            return None
        S, P = max(0, -cc), max(0, cc)
        if S + m >= self.lseg or P + n >= self.lseg:
            return None
        return (S, P, tb, qb, te, qe, cert_bound, always)

    def accepts(self, qlen: int, tlen: int, ends_free=None) -> bool:
        return self._envelope(qlen, tlen, ends_free) is not None

    def solve(self, jobs, certify: bool = True, status: list | None = None,
              max_scores: list | None = None,
              uncertified: list | None = None):
        """status (optional, filled per job): "ok", "envelope",
        "scorecap" (the sweep exhausted the score budget: the true score
        exceeds min(cap, smax)), "uncert" (banded result above the
        certificate bound; only with certify=True), "badbt".
        certify=False returns uncertified banded CIGARs (replayable,
        score-valid, possibly suboptimal). max_scores: optional per-job
        score caps. uncertified (optional list): filled with (ops, score,
        cert_bound) for "uncert" jobs."""
        results: list = [None] * len(jobs)
        st = ["envelope"] * len(jobs)
        todo = []
        for i, job in enumerate(jobs):
            q, t, ef = _job_parts(job)
            m, n = len(q), len(t)
            if m == 0 and n == 0:
                results[i] = []
                st[i] = "ok"
            elif (m == 0 or n == 0) and ef is None:
                ops = []
                if n:
                    ops.append((n, "D"))
                if m:
                    ops.append((m, "I"))
                results[i] = ops
                st[i] = "ok"
            elif m and n and self.accepts(m, n, ef):
                todo.append(i)
        # size-sorted chunks keep the launch's problems of similar depth
        todo.sort(key=lambda i: max(len(jobs[i][0]), len(jobs[i][1])))
        unc: list = [None] * len(jobs)
        if todo:
            with perf.span("align.device"):
                disps = [self._dispatch_chunk(todo[c0:c0 + self.max_call],
                                              jobs, max_scores)
                         for c0 in range(0, len(todo), self.max_call)]
                for disp in disps:
                    self._collect_chunk(disp, results, st, certify, unc)
            perf.add("align.device_calls", len(disps))
        if status is not None:
            status[:] = st
        if uncertified is not None:
            uncertified[:] = unc
        return results

    def pack_chunk(self, idxs, jobs, max_scores):
        """Pack jobs[idxs] into one fused (groups*PB, lseg + 64) uint8
        buffer: query nibbles | target nibbles | 16 little-endian int32
        params per row (the TPU package's chunk layout, byte for byte).
        Returns (buf, meta); buf is None and meta["give_up"] is set when
        the chunk holds more than 14 distinct symbols.

        One pass gathers each job's lengths, ends-free spans and cap; one
        native call (native/tierpack.cpp, which releases the GIL) does
        the rest. pack_chunk_py is its spec and the fallback."""
        qparts: list = []
        tparts: list = []
        cols: list = []
        for i in idxs:
            q, t, ef = _job_parts(jobs[i])
            cap = None if max_scores is None else max_scores[i]
            qparts.append(q)
            tparts.append(t)
            cols.append((len(q), len(t), *(
                (0, 0, 0, 0) if ef is None else
                (ef.target_begin, ef.query_begin, ef.target_end,
                 ef.query_end)), 0 if cap is None else int(cap)))
        got = pack_tier_chunk_native(
            b"".join(qparts), b"".join(tparts),
            np.array(cols, np.int64).reshape(-1, 7), self.groups * self.PB,
            self.lseg, self.K, self.smax, _SYM_LUT, self.gap_table)
        if got is NotImplemented:
            return self.pack_chunk_py(idxs, jobs, max_scores)
        perf.add("align.tier.pack_native", 1)
        if got is None:
            return None, dict(idxs=idxs, give_up=True)
        buf, cert_b, cert_always = got
        return buf, dict(idxs=idxs, cert_b=cert_b, cert_always=cert_always)

    def pack_chunk_py(self, idxs, jobs, max_scores):
        """pack_chunk in numpy: the native pack's spec (tested byte for
        byte) and its fallback where the library cannot be built."""
        L = self.lseg
        B = self.groups * self.PB
        nj = len(idxs)
        par = np.zeros((B, 16), np.int32)
        cert_b = np.zeros(B, np.int64)
        cert_always = np.zeros(B, bool)
        qparts: list = []
        tparts: list = []
        for j, i in enumerate(idxs):
            q, t, ef = _job_parts(jobs[i])
            m, n = len(q), len(t)
            S, P, tb, qb, te, qe, cbound, calways = self._envelope(m, n, ef)
            qparts.append(bytes(q))
            tparts.append(bytes(t))
            par[j, :8] = (S + m, P + n, S, S - P, tb, qb, te, qe)
            if max_scores is not None and max_scores[i] is not None:
                par[j, 8] = min(int(max_scores[i]), self.smax)
            cert_b[j] = cbound
            cert_always[j] = calways
        # unmapped bytes get a per-chunk remap (equality-preserving); a
        # chunk of more than 14 symbols escalates via "envelope" status
        lut = _SYM_LUT
        flat_q = np.frombuffer(b"".join(qparts), np.uint8)
        flat_t = np.frombuffer(b"".join(tparts), np.uint8)
        cq, ct = lut[flat_q], lut[flat_t]
        if nj and (cq.max(initial=0) == 0xFF or ct.max(initial=0) == 0xFF):
            present = np.nonzero(
                np.bincount(flat_q, minlength=256)
                + np.bincount(flat_t, minlength=256))[0]
            if len(present) > 14:
                return None, dict(idxs=idxs, give_up=True)
            lut = np.full(256, 0xFF, np.uint8)
            for ci, b in enumerate(present):
                lut[b] = ci
            cq, ct = lut[flat_q], lut[flat_t]
        q4 = _place4(cq, [len(x) for x in qparts], par[:nj, 2], B, L, 14)
        t4 = _place4(ct, [len(x) for x in tparts],
                     par[:nj, 2] - par[:nj, 3], B, L, 15)
        buf = np.concatenate(
            [q4, t4, par.astype("<i4").view(np.uint8).reshape(B, 64)],
            axis=1)
        return buf, dict(idxs=idxs, cert_b=cert_b, cert_always=cert_always)

    def _dispatch_chunk(self, idxs, jobs, max_scores):
        """Pack one chunk and launch it (asynchronously on a card).
        Returns the collect state: device outputs + certificate metadata."""
        perf.add(f"align.tier_jobs.{tier_name(self.K, self.smax)}",
                 len(idxs))
        with perf.span("align.tier.pack"):
            buf, meta = self.pack_chunk(idxs, jobs, max_scores)
        if buf is None:
            return meta
        kw = dict(penalties=self.p, K=self.K, smax=self.smax, maxr=self.maxr)
        with perf.span("align.tier.launch"):
            if self.mesh is None:
                meta["runs_full"], meta["out16"] = run_seg(
                    torch.from_numpy(buf).to(self.device), **kw)
            else:
                devices = self.mesh.axis_devices(self.mesh.axis_names[0])
                meta["runs_full"], meta["out16"] = _run_seg_sharded(
                    buf, len(idxs), devices, **kw)
        return meta

    def _collect_chunk(self, disp, results, st, certify, unc):
        idxs = disp["idxs"]
        if disp.get("give_up"):
            return                      # statuses stay "envelope"
        with perf.span("align.tier.collect"):
            self._decode_chunk(disp, results, st, certify, unc)

    def _decode_chunk(self, disp, results, st, certify, unc):
        """The chunk's outputs brought to the host (the readback waits for
        the kernel) and turned into each job's CIGAR and status."""
        idxs = disp["idxs"]
        maxr = self.maxr
        cap = min(maxr, RUNS_CAP)
        out16 = _host(disp["out16"])
        term = out16[:, :NTERM]
        runs_c = out16[:, NTERM:]
        cert_b, cert_always = disp["cert_b"], disp["cert_always"]
        nj_rows = len(idxs)
        # per job row of the last chunk collected, its swept levels (the
        # dry run's per-device balance reads it)
        self.last_row_levels = term[:nj_rows, 8].astype(np.int64)
        cur = term[:, 4]
        used = (maxr - 1) - cur.astype(np.int64)
        runs_np = None
        if (used[:nj_rows] > cap).any():
            # rare overflow (deep-divergence CIGARs): one full readback
            runs_np = _host(disp["runs_full"])
        # flat-prefix decode: gather only the used entries of this chunk's
        # rows, convert once, slice per row
        used_c = np.minimum(used[:nj_rows], cap)
        tot = int(used_c.sum())
        row_off = np.zeros(nj_rows + 1, np.int64)
        np.cumsum(used_c, out=row_off[1:])
        rr = np.repeat(np.arange(nj_rows), used_c)
        cc = np.arange(tot, dtype=np.int64) - np.repeat(row_off[:-1], used_c)
        vals = runs_c[rr, cc].astype(np.int32)
        n_flat = (vals & 0x1FFF).tolist()
        o_flat = [OP_CHARS[o] for o in (vals >> 13).tolist()]
        off_l = row_off.tolist()
        t0_l = term[:nj_rows, 0].tolist()
        t1_l = term[:nj_rows, 1].tolist()
        t3_l = term[:nj_rows, 3].tolist()
        t5_l = term[:nj_rows, 5].tolist()
        used_l = used[:nj_rows].tolist()
        for j, i in enumerate(idxs):
            if not t0_l[j]:
                st[i] = "scorecap"
                continue
            if not t5_l[j]:
                st[i] = "badbt"
                continue
            score = t1_l[j]
            if used_l[j] > cap:
                valsf = runs_np[j, cur[j] + 1:maxr].astype(np.int32)
                ops = list(zip((valsf & 0x1FFF).tolist(),
                               (OP_CHARS[o] for o in (valsf >> 13).tolist())))
            else:
                a, b = off_l[j], off_l[j + 1]
                ops = list(zip(n_flat[a:b], o_flat[a:b]))
            if certify and (t3_l[j] or cert_always[j]):
                # a banded score strictly below the certificate bound
                # proves no out-of-band path can win (see _envelope)
                if score >= int(cert_b[j]):
                    st[i] = "uncert"
                    unc[i] = (ops, score, int(cert_b[j]))
                    continue
            st[i] = "ok"
            results[i] = ops


# The five tier envelopes (PB, K, smax, lseg, groups) of the reference's
# TieredSegmentSolver (wfa_pallas_seg.py:998-1019). K, smax and lseg decide
# which jobs certify, escalate or are accepted banded: they are semantics.
TIERS = (
    (64, 128, 128, 512, 64),      # t1: the bulk of ~256 bp anchored pieces
    (16, 256, 384, 512, 64),      # t2: divergent, clipped, skewed pieces
    (16, 512, 768, 2048, 32),     # t3: 0.5-2 kb pieces, boundary patches
    (16, 1024, 512, 4224, 16),    # t4: deep patches up to 4096 a side
    (16, 256, 2048, 2048, 32),    # t5: deep divergence, narrow band
)


def tier_name(K: int, smax: int) -> str:
    """t1..t5 for a tier envelope of TIERS, else K<K>s<smax>."""
    for i, (_, k, sm, _, _) in enumerate(TIERS):
        if (k, sm) == (K, smax):
            return f"t{i + 1}"
    return f"K{K}s{smax}"


class TieredSegmentSolver:
    """Five kernel configurations behind one solve(). Jobs cascade
    t1 -> t5 on both envelope rejection and kernel failure (score cap,
    uncertified band edge); a job failing all returns None for the
    caller's exact-engine escalation."""

    def __init__(self, penalties: Penalties, device, tiers=TIERS,
                 mesh=None):
        self.p = penalties
        self.tiers = tuple(
            SegmentSolver(penalties, device, PB=pb, K=k, smax=sm, lseg=ls,
                          groups=g, mesh=mesh)
            for pb, k, sm, ls, g in tiers)

    @classmethod
    def from_reference(cls, ref, device, mesh=None):
        """The port's solver with the tier table of a reference
        wfmash_tpu TieredSegmentSolver (penalties and each tier's PB, K,
        smax, lseg, groups read as plain ints)."""
        return cls(ref.p, device, tiers=tuple(
            (int(t.PB), int(t.K), int(t.smax), int(t.lseg), int(t.groups))
            for t in ref.tiers), mesh=mesh)

    def accepts(self, qlen: int, tlen: int, ends_free=None) -> bool:
        return any(t.accepts(qlen, tlen, ends_free) for t in self.tiers)

    def solve(self, jobs, certify: bool = True, status: list | None = None,
              max_scores: list | None = None,
              uncertified: list | None = None):
        """Like SegmentSolver.solve, but status entries are
        (code, smax_of_deepest_attempting_tier) tuples."""
        res: list = [None] * len(jobs)
        st: list = [("envelope", 0)] * len(jobs)
        unc_all: list = [None] * len(jobs)
        self._cascade(self.tiers, list(range(len(jobs))), jobs, certify,
                      max_scores, res, st, unc_all, take_empty=True)
        if status is not None:
            status[:] = st
        if uncertified is not None:
            uncertified[:] = unc_all
        return res

    def _cascade(self, tiers, pending, jobs, certify, max_scores, res, st,
                 unc_all, take_empty):
        """Runs the pending job indices through tiers in turn: each tier
        takes those its envelope holds (and, with take_empty, the jobs
        with an empty side), and a job leaves once a tier solves it or
        proves its score over its cap."""
        for tier in tiers:
            if not pending:
                break
            idx = [i for i in pending
                   if tier.accepts(len(jobs[i][0]), len(jobs[i][1]),
                                   _job_parts(jobs[i])[2])
                   or (take_empty and (not jobs[i][0] or not jobs[i][1]))]
            refuted = (self._run_tier(tier, idx, jobs, certify, max_scores,
                                      res, st, unc_all) if idx else ())
            pending = [i for i in pending
                       if res[i] is None and i not in refuted]

    def _run_tier(self, tier, idx, jobs, certify, max_scores, res, st,
                  unc_all):
        """One tier pass over job indices idx; fills res/st/unc_all and
        returns the set of refuted indices (score cap proven)."""
        tst: list = []
        tunc: list = []
        got = tier.solve(
            [jobs[i] for i in idx], certify=certify, status=tst,
            max_scores=None if max_scores is None else
            [max_scores[i] for i in idx], uncertified=tunc)
        refuted = set()
        for i, o, s, u in zip(idx, got, tst, tunc):
            res[i] = o
            if u is not None:
                unc_all[i] = u   # deepest tier's banded result
            if s != "envelope":
                st[i] = (s, tier.smax)
            if (s == "scorecap" and max_scores is not None
                    and max_scores[i] is not None
                    and max_scores[i] <= tier.smax):
                refuted.add(i)   # score > cap proven
        return refuted

    def stream(self, certify: bool = True):
        """Streaming solve: add() feeds jobs from the planning thread while
        run() (a worker thread) launches tier-1 chunks as they fill, then
        cascades the remainder through the deeper tiers. Per-job results
        equal solve()'s (a job's result never depends on its chunk)."""
        return _StreamSolve(self, certify)


class _StreamSolve:
    """Producer/consumer wrapper around TieredSegmentSolver. add() and
    close() are called by the producing (planning) thread; run() is the
    consuming worker, which launches on its own current CUDA stream."""

    def __init__(self, solver: TieredSegmentSolver, certify: bool):
        self.solver = solver
        self.certify = certify
        self.cv = threading.Condition()
        self.jobs: list = []
        self.max_scores: list = []
        self.closed = False
        self.res: list = []
        self.st: list = []
        self.unc: list = []
        self.refuted: set = set()

    def add(self, job, max_score=None) -> int:
        with self.cv:
            self.jobs.append(job)
            self.max_scores.append(max_score)
            self.res.append(None)
            self.st.append(("envelope", 0))
            self.unc.append(None)
            k = len(self.jobs) - 1
            self.cv.notify()
        return k

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify()

    def run(self) -> None:
        t1 = self.solver.tiers[0]
        CH = t1.max_call
        taken = 0
        elig: list = []     # t1-eligible, awaiting launch
        # three chunks in flight: chunk N+1's upload and compute overlap
        # chunk N's readback
        depth = 3
        inflight: list = []
        st_str: dict = {}   # raw string statuses from _collect_chunk
        # align.device: from the first launch to the last collect (its
        # self time is the wait for planned work between them)
        device_span = None

        def finish_one():
            disp = inflight.pop(0)
            t1._collect_chunk(disp, self.res, st_str, self.certify,
                              self.unc)
            for i in disp["idxs"]:
                s = st_str.get(i, "envelope")
                if s != "envelope":
                    self.st[i] = (s, t1.smax)
                if (s == "scorecap" and self.max_scores[i] is not None
                        and self.max_scores[i] <= t1.smax):
                    self.refuted.add(i)   # score > cap proven

        while True:
            with self.cv:
                while not self.closed and len(self.jobs) - taken < CH:
                    self.cv.wait(0.05)
                new_hi = len(self.jobs)
                closed = self.closed
            for k in range(taken, new_hi):
                q, t, ef = _job_parts(self.jobs[k])
                if not q or not t or t1.accepts(len(q), len(t), ef):
                    elig.append(k)
            taken = new_hi
            drained = closed and taken == len(self.jobs)
            while len(elig) >= CH or (drained and elig):
                chunk, elig = elig[:CH], elig[CH:]
                if device_span is None:
                    device_span = perf.span("align.device").__enter__()
                inflight.append(t1._dispatch_chunk(chunk, self.jobs,
                                                   self.max_scores))
                perf.add("align.device_calls", 1)
                while len(inflight) > depth:
                    finish_one()
            if drained and not elig:
                break
        while inflight:
            finish_one()
        if device_span is not None:
            device_span.__exit__(None, None, None)
        # cascade the remainder through the deeper tiers (pooled)
        self.solver._cascade(
            self.solver.tiers[1:],
            [k for k in range(len(self.jobs))
             if self.res[k] is None and k not in self.refuted],
            self.jobs, self.certify, self.max_scores, self.res, self.st,
            self.unc, take_empty=False)
