"""Banded global alignment under two-piece gap-affine penalties, in
plain torch (any device), a row of the query at a time.

The band is `band` cells either side of the straight line from (0, 0) to
(n, m), so a path that strays further is not seen: the band's optimum is
then above the true one, never below it. Vertical gaps are carried from
row to row; horizontal gaps within a row come from a running minimum
(a gap of length L costs min(o1 + e1 L, o2 + e2 L), which is subadditive,
so one run from the best opening is always as good as two).
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 28


def _gap(j: torch.Tensor, pen) -> torch.Tensor:
    x, o1, e1, o2, e2 = pen
    return torch.minimum(o1 + e1 * j, o2 + e2 * j) * (j > 0)


def banded(pairs, pen, band: int, device, keep_rows: bool = False):
    """Optimal scores of global alignments of each (query, target) pair of
    uint8 arrays within the band; with keep_rows, also every row of H as
    a (n_max + 1, B, 2 band + 1) int64 tensor on the host, for
    `traceback_linear`.

    Row i holds columns j = c(i) - band + k, k < 2 band + 1, with
    c(i) = i m // n. A cell left of column 0 is never reached (INF in
    row 0 and fed only from its like); a cell right of column m never
    feeds one at or left of it, so neither needs a mask."""
    B = len(pairs)
    L = 2 * band + 1
    x, o1, e1, o2, e2 = pen
    n = torch.tensor([len(q) for q, _ in pairs], dtype=torch.int64,
                     device=device)
    m = torch.tensor([len(t) for _, t in pairs], dtype=torch.int64,
                     device=device)
    nmax, mmax = int(n.max()), int(m.max())
    Q = torch.zeros((nmax + 1, B, 1), dtype=torch.uint8)
    T = torch.zeros((B, mmax + 2 * band + 2), dtype=torch.uint8)
    for b, (q, t) in enumerate(pairs):
        Q[:len(q), b, 0] = torch.from_numpy(np.ascontiguousarray(q))
        T[b, band + 1:band + 1 + len(t)] = torch.from_numpy(
            np.ascontiguousarray(t))
    Q, T = Q.to(device), T.to(device)
    kk = torch.arange(L, dtype=torch.int64, device=device)[None, :]
    # c(i) for every row, and the shift from row i - 1 to row i
    C = (torch.arange(nmax + 1, dtype=torch.int64, device=device)[:, None]
         * m[None, :]) // n.clamp(min=1)[None, :]
    S = torch.zeros_like(C)
    S[1:] = C[1:] - C[:-1]
    tcap = T.shape[1] - 1
    oe = torch.tensor([o1 + e1, o2 + e2], dtype=torch.int64,
                      device=device)[:, None, None]
    ee = torch.tensor([e1, e2], dtype=torch.int64, device=device)[:, None,
                                                                  None]
    ekk = ee * kk[None]
    o_ekk = (oe - ee) + ekk
    inf_col = torch.full((3, B, 1), INF, dtype=torch.int64, device=device)
    inf_cum = torch.full((2, B, 1), INF, dtype=torch.int64, device=device)

    j0 = kk - band + torch.zeros_like(m)[:, None]
    H = torch.where(j0 >= 0, _gap(j0, pen), torch.full_like(j0, INF))
    HD = torch.stack([H, torch.full_like(H, INF), torch.full_like(H, INF)])
    out = [None] * B
    ends: dict[int, list[int]] = {}
    for b in range(B):
        ends.setdefault(int(n[b]), []).append(b)
    rows = torch.empty((nmax + 1, B, L), dtype=torch.int64) if keep_rows \
        else None
    if keep_rows:
        rows[0] = H.cpu()
    for b in ends.get(0, ()):
        out[b] = H[b, band]
    for i in range(1, nmax + 1):
        # padded: column 0 and column L + 1 are INF
        P = torch.cat([inf_col, HD, inf_col], dim=2)
        up = (kk + S[i][:, None] + 1).clamp(max=L + 1)
        dg = (kk + S[i][:, None]).clamp(max=L + 1)
        g_up = P.gather(2, up.expand(3, B, L))
        h_dg = P[0].gather(1, dg)
        tb = T.gather(1, (C[i][:, None] + kk).clamp(max=tcap))
        diag = h_dg + torch.where(tb == Q[i - 1], 0, x)
        D = torch.minimum(g_up[0][None] + oe, g_up[1:] + ee)
        H0 = torch.minimum(diag, D.min(dim=0).values)
        A = torch.cummin(H0[None] - ekk, dim=2).values
        I = torch.cat([inf_cum, A[:, :, :-1]], dim=2) + o_ekk
        H = torch.minimum(H0, I.min(dim=0).values)
        HD = torch.cat([H[None], D], dim=0)
        if keep_rows:
            rows[i] = H.cpu()
        for b in ends.get(i, ()):
            out[b] = H[b, band]
    scores = [int(v) for v in torch.stack(out).cpu()]
    return (scores, rows) if keep_rows else scores


def traceback_linear(q: np.ndarray, t: np.ndarray, H: np.ndarray, band: int,
                     pen) -> list[tuple[int, str]]:
    """A path of one pair's rows H (n + 1, 2 band + 1) under penalties with
    no gap opening (pen[1] == pen[3] == 0): diagonal first, then query
    gaps, then target gaps. Returns the CIGAR as (length, op) runs."""
    x, o1, e1 = pen[0], pen[1], pen[2]
    if o1 != 0 or pen[3] != 0:
        raise ValueError("traceback_linear needs gap costs without opening")
    n, m = len(q), len(t)
    L = H.shape[1]
    nn = max(n, 1)
    i, jj = n, m
    ops: list[str] = []

    def cell(r, col):
        k = col - (r * m) // nn + band
        return int(H[r, k]) if 0 <= k < L else INF

    while i > 0 or jj > 0:
        h = cell(i, jj)
        if i > 0 and jj > 0:
            same = q[i - 1] == t[jj - 1]
            if cell(i - 1, jj - 1) + (0 if same else x) == h:
                ops.append("=" if same else "X")
                i -= 1
                jj -= 1
                continue
        if i > 0 and cell(i - 1, jj) + e1 == h:
            ops.append("I")
            i -= 1
            continue
        if jj > 0 and cell(i, jj - 1) + e1 == h:
            ops.append("D")
            jj -= 1
            continue
        raise RuntimeError("traceback left the band")
    ops.reverse()
    runs: list[tuple[int, str]] = []
    for op in ops:
        if runs and runs[-1][1] == op:
            runs[-1] = (runs[-1][0] + 1, op)
        else:
            runs.append((1, op))
    return runs
