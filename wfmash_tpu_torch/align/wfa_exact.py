"""Batched exact WFA engine: device sweeps + host recursion.

Counterpart of wfmash_tpu/align/wfa_jax.py (JaxWfaEngine) on its Pallas
branch, with wfmash_tpu/align/wfa_pallas.py's sweeps replaced by
wfa_sweep.ExactSweeps. The reference's default aligner is WFA2-lib's biWFA
(wflign.cpp:136-148): exact gap-affine-2p alignment in O(span) memory.
Here:

* **Sweep** (wfa_sweep): advances the five wavefronts one score level at
  a time for a whole batch, keeping only a ring of the last levels, and
  carries with every cell the cell at which its path crossed a
  per-problem split line (row v == mid for target-axis splits, column
  h == mid for query-axis splits). Crossings inside a gap run are
  anchored at the run's gap-open cell, so splitting at the anchor is
  exactly score-preserving: the Hirschberg construction on wavefronts.
* **Recursion** (host): each problem is swept once to find its score and
  split anchor, split and re-queued; halves small enough (score x span
  below the leaf budget) become leaves. Leaves go to the segment tiers
  (wfa_seg, full-history kernel) in batches, leaves the tiers cannot
  settle re-enter the sweep recursion once, and the rest go to the native
  host WFA.

There is one backend: the sweep runs the hand-written kernel on a CUDA
device and its plain PyTorch version on the CPU. An engine error ends the
call; nothing is caught and carried on.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np

from ..utils import perf
from .cigar import merge_ops
from .wfa_np import EndsFree, Penalties
from .wfa_sweep import NEG_I, UNSET32, ExactSweeps
from .wfa_vec import wfa_align

SPAN_LADDER = (256, 512, 1024, 2048, 4096)
MAX_LEN = 65535          # packed (v << 16) | h anchors: lengths below this


def _host_solve(q, t, ef, p):
    """Pool worker: host WFA (no device access)."""
    _, ops = wfa_align(q, t, p, ef)
    return ops


def _wfa_log(msg: str) -> None:
    print(msg, file=sys.stderr)


@dataclass
class _Sub:
    """A pending subproblem: align query[q0:q1] vs target[t0:t1]."""

    job_id: int
    q0: int
    q1: int
    t0: int
    t1: int
    order: tuple  # position in the output tree (for reassembly)
    force_axis: int = -1  # -1 auto, 0 target-axis, 1 query-axis


class ExactWfaEngine:
    """Batched exact WFA engine on one explicit device."""

    def __init__(self, penalties: Penalties, device, batch_size: int = 128,
                 host_len: int = 1500, max_span: int = 4096 + 1,
                 seg_solver=None):
        import torch

        self.p = penalties
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.HOST_LEN = host_len
        self.HOST_CELLS = 1_000_000   # adaptive leaf: score/2 * span bound
        self.MAX_SPAN = max_span
        self.sweeps = ExactSweeps(penalties, self.device)
        # shared full-history segment solver (wfa_seg): recursion leaves
        # that fit its envelope solve in device batches instead of one by
        # one on the host (bit-identical results). Installed lazily, or
        # injected by SegmentedEngine so both use one solver.
        self.seg_solver = seg_solver
        self.seg_min_batch = 4
        # opt-in (set by SegmentedEngine to its banded_pieces policy):
        # accept banded/diagonal leaf results instead of host WFA for
        # leaves the segment tiers cannot certify. Default False: this
        # engine's standalone contract is exactness.
        self.banded_leaves = False
        # host-leaf pool width (set from -t by make_engine)
        self.threads = 1

    @classmethod
    def from_reference(cls, ref, device, seg_solver=None):
        """The port's engine with the settings of a reference wfmash_tpu
        JaxWfaEngine, read as plain values. seg_solver: the port's
        TieredSegmentSolver to use for the leaves (the reference's own
        solver is not carried across)."""
        eng = cls(ref.p, device, batch_size=int(ref.batch_size),
                  host_len=int(ref.HOST_LEN), max_span=int(ref.MAX_SPAN),
                  seg_solver=seg_solver)
        eng.HOST_CELLS = int(ref.HOST_CELLS)
        eng.seg_min_batch = int(ref.seg_min_batch)
        eng.banded_leaves = bool(ref.banded_leaves)
        eng.threads = int(ref.threads)
        return eng

    # -- single-problem API ---------------------------------------------
    def align(self, query: bytes, target: bytes,
              ends_free: EndsFree | None = None):
        if ends_free is not None or (
            len(query) <= self.HOST_LEN and len(target) <= self.HOST_LEN
        ):
            _, ops = wfa_align(query, target, self.p, ends_free)
            return ops
        return self.align_batch([(query, target, None)])[0]

    def _get_seg_solver(self):
        if self.seg_solver is None:
            from .wfa_seg import TieredSegmentSolver

            self.seg_solver = TieredSegmentSolver(self.p, self.device)
        return self.seg_solver

    # -- batched API ------------------------------------------------------
    def align_batch(self, jobs, allow_seg: bool = True, bounds=None):
        """jobs: [(query, target, ends_free|None)] -> [ops].

        allow_seg=False skips the segment-kernel leaf batching (used for
        problems that already failed the segment kernel's envelope)."""
        results: dict[int, dict[tuple, list]] = {}
        self._results = results
        queue: list[_Sub] = []
        deferred: list = []    # (job_id, order, q, t, ef) small problems
        seqs = []
        for i, (q, t, ef) in enumerate(jobs):
            seqs.append((np.frombuffer(bytes(q), dtype=np.uint8),
                         np.frombuffer(bytes(t), dtype=np.uint8)))
            results[i] = {}
            if ef is not None or (
                len(q) <= self.HOST_LEN and len(t) <= self.HOST_LEN
            ):
                deferred.append((i, (), bytes(q), bytes(t), ef))
            else:
                queue.append(_Sub(i, 0, len(q), 0, len(t), ()))

        synth: dict[int, tuple[int, tuple]] = {}

        def drain_queue(queue):
            """Crossing-payload sweep recursion; leaves append to
            `deferred` (closure)."""
            while queue:
                batch = queue[: self.batch_size]
                queue = queue[self.batch_size:]
                # problems outside the device envelope go straight to
                # the host solver rather than dragging the batch down:
                # (a) lengths >= 65535 (u16-packed anchors),
                # (b) |m - n| beyond the diagonal span budget
                keep = []
                for sub in batch:
                    m_len, n_len = sub.q1 - sub.q0, sub.t1 - sub.t0
                    too_long = max(m_len, n_len) >= MAX_LEN
                    too_skew = 2 * (abs(m_len - n_len) + 16) + 3 \
                        > self.MAX_SPAN
                    if too_long or too_skew:
                        q = seqs[sub.job_id][0][sub.q0:sub.q1].tobytes()
                        t = seqs[sub.job_id][1][sub.t0:sub.t1].tobytes()
                        _, ops = wfa_align(q, t, self.p)
                        self._store(sub, ops)
                    else:
                        keep.append(sub)
                batch = keep
                if not batch:
                    continue
                splits = self._sweep_batch(batch, seqs)
                for sub, split in zip(batch, splits):
                    if split is None:
                        continue       # solved directly
                    anchor_v, anchor_h, score = split
                    if anchor_v == 0 and anchor_h == 0:
                        # degenerate anchor: re-sweep the other axis
                        m_len = sub.q1 - sub.q0
                        n_len = sub.t1 - sub.t0
                        cur_axis = 1 if (
                            sub.force_axis == 1
                            or (sub.force_axis == -1 and m_len > n_len)
                        ) else 0
                        queue.append(
                            _Sub(sub.job_id, sub.q0, sub.q1, sub.t0,
                                 sub.t1, sub.order,
                                 force_axis=1 - cur_axis)
                        )
                        continue
                    qm = sub.q0 + anchor_h
                    tm = sub.t0 + anchor_v
                    for side, (a, b, c, d) in enumerate(
                        [(sub.q0, qm, sub.t0, tm), (qm, sub.q1, tm, sub.t1)]
                    ):
                        q_sub = seqs[sub.job_id][0][a:b].tobytes()
                        t_sub = seqs[sub.job_id][1][c:d].tobytes()
                        order = sub.order + (side,)
                        # adaptive leaf rule: defer when score x span is
                        # small enough for the leaf solvers
                        side_len = max(len(q_sub), len(t_sub))
                        est = (score // 2 + 1) * side_len
                        if (side_len <= self.HOST_LEN
                                or est <= self.HOST_CELLS):
                            deferred.append(
                                (sub.job_id, order, q_sub, t_sub, None))
                        else:
                            queue.append(
                                _Sub(sub.job_id, a, b, c, d, order)
                            )

        def seg_pass(entries, seg):
            """Solve deferred entries on the segment tiers; returns the
            unsolved remainder."""
            if seg is None:
                return list(entries)
            solved = [False] * len(entries)
            elig = [k for k, (_, _, q, t, ef) in enumerate(entries)
                    if q and t and seg.accepts(len(q), len(t), ef)]
            if len(elig) >= self.seg_min_batch:
                unc: list = []
                stat: list = []
                got = seg.solve(
                    [(entries[k][2], entries[k][3], entries[k][4])
                     for k in elig], uncertified=unc, status=stat)
                for j, (k, ops) in enumerate(zip(elig, got)):
                    i, order, q, t, ef = entries[k]
                    if ops is None and self.banded_leaves:
                        # same ledgered policy as the segmented engine:
                        # mildly-banded CIGAR (score < 3x certificate),
                        # or the diagonal path for junk-level leaves
                        if unc[j] is not None and \
                                unc[j][1] < 3 * max(unc[j][2], 1):
                            ops = unc[j][0]
                        elif ef is None and max(len(q), len(t)) <= 2047:
                            s = stat[j]
                            code = s[0] if isinstance(s, tuple) else s
                            if code == "scorecap":
                                from .segmented import _diag_ops

                                ops = _diag_ops(q, t)
                    if ops is not None:
                        results[i][order] = ops
                        solved[k] = True
            return [e for k, e in enumerate(entries) if not solved[k]]

        drain_queue(queue)
        seg = self._get_seg_solver() if allow_seg else None
        pending = deferred
        for rnd in range(2):
            unsolved = seg_pass(pending, seg)
            if rnd == 1 or seg is None:
                pending = unsolved
                break
            # leaves the tiers could not settle re-enter the exact sweep
            # recursion as synthetic jobs: the crossing-payload split
            # lands ON the true path, so the halves' bands re-center on
            # the real diagonals (repeat shifts included) and the tiers
            # finish them exactly; the host only sees what nothing else
            # can take.
            requeue, keep = [], []
            for ent in unsolved:
                i, order, q, t, ef = ent
                skew_ok = 2 * (abs(len(q) - len(t)) + 16) + 3 \
                    <= self.MAX_SPAN
                if (ef is None and len(q) >= 600 and len(t) >= 600
                        and max(len(q), len(t)) < MAX_LEN and skew_ok):
                    sid = len(seqs)
                    seqs.append((np.frombuffer(q, dtype=np.uint8),
                                 np.frombuffer(t, dtype=np.uint8)))
                    results[sid] = {}
                    synth[sid] = (i, order)
                    requeue.append(_Sub(sid, 0, len(q), 0, len(t), ()))
                else:
                    keep.append(ent)
            if not requeue:
                pending = keep
                break
            deferred = []
            drain_queue(requeue)
            pending = keep + deferred

        rest_entries = pending
        with perf.span("align.host_leaf"):
            leaf_log = os.environ.get("WFMASH_TPU_LEAF_LOG")
            if leaf_log and rest_entries:
                with open(leaf_log, "a") as fh:
                    for (_i, _o, q, t, ef) in rest_entries:
                        fh.write(f"{len(q)}\t{len(t)}\t{ef}\n")
            done_pool = False
            if self.threads > 1 and len(rest_entries) >= 8:
                from ..utils.hostpool import get_pool

                pool = get_pool(self.threads)
                if pool is not None:
                    got = pool.starmap(
                        _host_solve,
                        [(q, t, ef, self.p)
                         for (_, _, q, t, ef) in rest_entries],
                        chunksize=max(1, len(rest_entries) //
                                      (4 * self.threads)))
                    for (i, order, _, _, _), ops in zip(rest_entries, got):
                        results[i][order] = ops
                    done_pool = True
            if not done_pool:
                for (i, order, q, t, ef) in rest_entries:
                    _, ops = wfa_align(q, t, self.p, ef)
                    results[i][order] = ops

        # synthetic sub-jobs assemble back into their parent order slot
        for sid, (pi, porder) in synth.items():
            pieces = results.pop(sid)
            ops = []
            for order in sorted(pieces):
                ops = ops + pieces[order]
            results[pi][porder] = merge_ops(ops)

        out = []
        for i in range(len(jobs)):
            pieces = results[i]
            ops: list = []
            for order in sorted(pieces):
                ops = ops + pieces[order]
            out.append(merge_ops(ops))
        return out

    # -- one batched sweep: score + split anchor ---------------------------
    def _sweep_batch(self, batch: list[_Sub], seqs):
        B = len(batch)
        ms = [s.q1 - s.q0 for s in batch]
        ns = [s.t1 - s.t0 for s in batch]
        longest = max(max(ms), max(ns))

        # rows padded with distinct sentinel bytes (query 0x01, target
        # 0x02): out-of-range positions mismatch automatically
        L = -(-(longest + 8) // 64) * 64
        query = np.full((B, L), 0x01, dtype=np.uint8)
        target = np.full((B, L), 0x02, dtype=np.uint8)
        for i, s in enumerate(batch):
            query[i, : ms[i]] = seqs[s.job_id][0][s.q0: s.q1]
            target[i, : ns[i]] = seqs[s.job_id][1][s.t0: s.t1]

        qlen = np.array(ms, dtype=np.int32)
        tlen = np.array(ns, dtype=np.int32)
        diff = int(np.max(np.abs(qlen - tlen)))
        if 2 * (diff + 16) + 3 > self.MAX_SPAN:
            raise RuntimeError(
                "alignment problem exceeds the diagonal span budget"
            )
        # split the longer axis (or the forced one after a degenerate anchor)
        axis_is_query = qlen > tlen
        for i, sub in enumerate(batch):
            if sub.force_axis == 0:
                axis_is_query[i] = False
            elif sub.force_axis == 1:
                axis_is_query[i] = True
        mid = np.where(axis_is_query, qlen // 2, tlen // 2).astype(np.int32)

        # score-0 seeds: M[k=0] = LCP, with extension-crossing payload
        splits: list = [None] * B
        done0 = np.zeros(B, dtype=bool)
        lcps = np.zeros(B, dtype=np.int32)
        for i in range(B):
            q, t = query[i, : ms[i]], target[i, : ns[i]]
            lcp = _lcp_np(q, t)
            lcps[i] = lcp
            if lcp >= ms[i] and lcp >= ns[i]:
                done0[i] = True    # perfect match
                self._emit_trivial(batch[i], lcp)

        if done0.all():
            return splits

        # a loose upper bound on any score; the sweep stops at the finish
        max_s = int(
            self.p.mismatch * (max(ms) + max(ns))
            + self.p.gap_opening1 + self.p.gap_opening2 + 64
        )
        # margin-based span ladder (exactness envelope): the wavefront is
        # banded to Kp diagonals. Band-edge contact (the sweep's clipped
        # flag) triggers escalation to the next ladder step unless the
        # final score certifies the band: any path leaving the band pays
        # for an out-and-back excursion of >= margin each way, so a
        # banded score strictly below that bound is globally optimal.
        ladder = [v for v in SPAN_LADDER if v <= self.MAX_SPAN]
        need = 2 * (diff + max(128, longest // 16)) + 3
        ki = next((i for i, v in enumerate(ladder) if v >= need),
                  len(ladder) - 1)
        adiff = np.abs(qlen - tlen)
        f_score = np.zeros(B, np.int32)
        f_pv = np.full(B, -1, np.int32)
        f_ph = np.full(B, -1, np.int32)
        finished = done0.copy()
        remaining = ~done0
        while True:
            Kp = ladder[ki]
            seed_off = np.full((B, Kp), NEG_I, np.int32)
            seed_anc = np.full((B, Kp), UNSET32, np.uint32)
            seed_off[:, Kp // 2] = lcps
            crossed0 = remaining & (lcps > mid)
            seed_anc[crossed0, Kp // 2] = (
                (mid[crossed0].astype(np.uint32) << 16)
                | mid[crossed0].astype(np.uint32))
            s, pv, ph, fin, clip = self.sweeps.sweep(
                query, target, qlen, tlen, axis_is_query, mid,
                seed_off, seed_anc, ~remaining, max_s, Kp)
            solved = remaining & fin
            f_score[solved] = s[solved]
            f_pv[solved] = pv[solved]
            f_ph[solved] = ph[solved]
            finished |= solved
            margin = (Kp - 1) // 2 - adiff
            gc = np.minimum(
                self.p.gap_opening1 + margin * self.p.gap_extension1,
                self.p.gap_opening2 + margin * self.p.gap_extension2)
            gc = np.where(margin > 0, gc, 0)
            certified = s.astype(np.int64) < 2 * gc
            retry = solved & clip & ~certified
            if not retry.any():
                break
            if ki + 1 >= len(ladder):
                _wfa_log(
                    f"[wfmash::align] warning: {int(retry.sum())} "
                    f"problem(s) touched the K={Kp} band edge above the "
                    "certificate bound at max span; result may be "
                    "banded (fidelity ledger)")
                break
            _wfa_log(
                f"[wfmash::align] span escalation: {int(retry.sum())} "
                f"problem(s) clipped at K={Kp}, re-running at "
                f"K={ladder[ki + 1]}")
            finished &= ~retry
            remaining = retry
            ki += 1
        if not finished.all():
            raise RuntimeError("WFA sweep failed to converge")

        for i in range(B):
            if done0[i]:
                continue
            pv, ph = int(f_pv[i]), int(f_ph[i])
            if pv < 0 or ph < 0:
                # path never crossed mid (possible when mid >= n for tiny
                # axes): the host aligner takes the block whole
                sub = batch[i]
                q = seqs[sub.job_id][0][sub.q0: sub.q1].tobytes()
                t = seqs[sub.job_id][1][sub.t0: sub.t1].tobytes()
                _, ops = wfa_align(q, t, self.p)
                self._store(sub, ops)
            else:
                splits[i] = (pv, ph, int(f_score[i]))
        return splits

    # bookkeeping helpers installed by align_batch
    def _emit_trivial(self, sub: _Sub, match_len: int):
        self._results[sub.job_id][sub.order] = (
            [(match_len, "=")] if match_len else []
        )

    def _store(self, sub: _Sub, ops):
        self._results[sub.job_id][sub.order] = ops


def _lcp_np(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = a[:n] != b[:n]
    idx = np.nonzero(neq)[0]
    return int(idx[0]) if len(idx) else n
