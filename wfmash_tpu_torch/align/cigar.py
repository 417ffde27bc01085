"""CIGAR utilities for the alignment layer.

Exact ports of the reference's CIGAR post-processing rules:

* RLE parse/format, op merge (wflign_swizzle.cpp:merge_cigar_ops)
* alignment statistics (wflign_patch.cpp:226-283 process_compressed_cigar)
* leading/trailing indel trim (wflign_patch.cpp:139-223 trim_indels)
* short-match erosion between opposing indels (wflign.cpp:19-106)
* boundary erosion bookkeeping for head/tail patching (wflign.cpp:240-418)
* start/end "swizzle" normalization (wflign_swizzle.cpp:try_swap_*)
* validation against sequences (pafcheck-style; also mirrors the
  VALIDATE_WFA_WFLIGN debug hooks, wflign.cpp:944-971)

All CIGARs here are lists of (count:int, op:str) with ops in "=XID" (plus
'M' accepted on input, converted to '=' as the reference does for exact
matchers, wflign_swizzle.cpp:wfa_edit_cigar_to_string).
"""

from __future__ import annotations

import re

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

Op = tuple[int, str]


def parse(cigar: str) -> list[Op]:
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


def format_ops(ops: list[Op]) -> str:
    return "".join(f"{n}{op}" for n, op in ops if n > 0)


def merge_ops(ops: list[Op], out: list[Op] | None = None) -> list[Op]:
    """Merge adjacent same-op runs, dropping zero-length ops; appended to
    `out`, a list already merged so, when one is given."""
    out = [] if out is None else out
    for n, op in ops:
        if n <= 0:
            continue
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + n, op)
        else:
            out.append((n, op))
    return out


def compress_long(long_cigar: str) -> list[Op]:
    """RLE a long-form CIGAR (one char per column), converting M -> '='."""
    ops: list[Op] = []
    for ch in long_cigar:
        op = "=" if ch == "M" else ch
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + 1, op)
        else:
            ops.append((1, op))
    return ops


def stats(ops: list[Op]):
    """(matches, mismatches, insertions, inserted_bp, deletions, deleted_bp,
    ref_aligned, query_aligned) — process_compressed_cigar semantics ('M'
    counts as match)."""
    matches = mismatches = ins = ins_bp = dels = del_bp = 0
    ref_len = q_len = 0
    for n, op in ops:
        if op in "M=":
            matches += n
            ref_len += n
            q_len += n
        elif op == "X":
            mismatches += n
            ref_len += n
            q_len += n
        elif op == "I":
            ins += 1
            ins_bp += n
            q_len += n
        elif op == "D":
            dels += 1
            del_bp += n
            ref_len += n
    return matches, mismatches, ins, ins_bp, dels, del_bp, ref_len, q_len


def trim_indels(ops: list[Op], ref_start: int, query_start: int):
    """Strip leading/trailing I/D ops, adjusting start coordinates
    (wflign_patch.cpp:139-223). Returns (ops, new_ref_start, new_query_start)."""
    start = 0
    rs, qs = ref_start, query_start
    while start < len(ops) and ops[start][1] in "ID":
        if ops[start][1] == "I":
            qs += ops[start][0]
        else:
            rs += ops[start][0]
        start += 1
    end = len(ops) - 1
    if start < len(ops):
        while end >= start and ops[end][1] in "ID":
            end -= 1
    trimmed = ops[start : end + 1]
    return trimmed, rs, qs


def erode_short_matches(ops: list[Op], max_match_length: int = 3,
                        is_head: bool = True) -> list[Op]:
    """Kill <=3bp matches wedged between opposing indels near the boundary
    (wflign.cpp:19-106). Only the first (head) or last (tail) 3 interior
    operations are examined, as in the reference."""
    if len(ops) < 3:
        return ops
    ops = [list(o) for o in ops]
    start_idx = 1
    end_idx = len(ops) - 1
    if is_head:
        end_idx = min(end_idx, 3)
    else:
        start_idx = max(start_idx, len(ops) - 3)
    modified = False
    for i in range(start_idx, end_idx):
        is_match = ops[i][1] in "M=X"
        prev_in = ops[i - 1][1] in "ID"
        next_in = ops[i + 1][1] in "ID"
        if is_match and ops[i][0] <= max_match_length and prev_in and next_in:
            if (
                ops[i - 1][1] != ops[i + 1][1]
                and ops[i - 1][0] > ops[i][0]
                and ops[i + 1][0] > ops[i][0]
            ):
                ops[i - 1][0] += ops[i][0]
                ops[i + 1][0] += ops[i][0]
                ops[i][0] = 0
                modified = True
    if not modified:
        return [tuple(o) for o in ops]
    return merge_ops([tuple(o) for o in ops])


def erode_head(ops: list[Op], min_patch: int = 128, max_erode: int = 4096,
               min_consecutive: int = 11):
    """Head erosion scan (wflign.cpp:240-276). Returns
    (query_eroded, target_eroded, n_ops_eroded)."""
    q = t = 0
    eroded_ops = 0
    found = False
    for i, (n, op) in enumerate(ops):
        if op == "=" and n >= min_consecutive:
            found = True
        if found and q >= min_patch and t >= min_patch:
            break
        if q >= max_erode or t >= max_erode:
            break
        if op in "MX=":
            q += n
            t += n
        elif op == "I":
            q += n
        elif op == "D":
            t += n
        eroded_ops = i + 1
    return q, t, eroded_ops


def erode_tail(ops: list[Op], min_patch: int = 128, max_erode: int = 4096,
               min_consecutive: int = 11):
    """Tail erosion scan (wflign.cpp:324-364). Returns
    (query_eroded, target_eroded, erode_start_idx)."""
    q = t = 0
    erode_start = len(ops)
    found = False
    for i in range(len(ops) - 1, -1, -1):
        n, op = ops[i]
        if op == "=" and n >= min_consecutive:
            found = True
        if found and q >= min_patch and t >= min_patch:
            break
        if q >= max_erode or t >= max_erode:
            break
        if op in "MX=":
            q += n
            t += n
        elif op == "I":
            q += n
        elif op == "D":
            t += n
        erode_start = i
    return q, t, erode_start


def merge_adjacent(ops1: list[Op], ops2: list[Op]) -> list[Op]:
    """Concatenate two op lists, merging at the junction (wflign.cpp:211-238)."""
    return merge_ops(list(ops1) + list(ops2))


def stitch_pieces(pieces) -> list[Op]:
    """Join a block's piece CIGARs in one pass over their ops.

    The same list as folding `merge_adjacent` over the pieces: a piece
    that finds the list empty is copied as it is, and the next piece
    normalises the whole (zero-length ops dropped, runs merged across
    the junctions).
    """
    out: list[Op] = []
    normal = False
    for p in pieces:
        if not out:
            out, normal = list(p), False
            continue
        if not normal:
            out, normal = merge_ops(out), True
        merge_ops(p, out)
    return out


# ---------------------------------------------------------------------------
# swizzle (wflign_swizzle.cpp)
# ---------------------------------------------------------------------------

def _seq_match(query: bytes, target: bytes, qs: int, ts: int, n: int) -> bool:
    if qs < 0 or ts < 0 or qs + n > len(query) or ts + n > len(target):
        return False
    return query[qs : qs + n] == target[ts : ts + n]


def try_swap_start_pattern(ops: list[Op], query: bytes, target: bytes,
                           query_start: int, target_start: int) -> list[Op]:
    """N= Dlen D -> Dlen D N= when the sequences agree (wflign_swizzle.cpp:
    try_swap_start_pattern)."""
    if len(ops) < 2:
        return ops
    (n1, op1), (n2, op2) = ops[0], ops[1]
    if op1 == "=" and op2 == "D":
        if _seq_match(query, target, query_start, target_start + n2, n1):
            return merge_ops([(n2, "D"), (n1, "=")] + ops[2:])
    return ops


def _end_coords(ops: list[Op], query_start: int, target_start: int):
    q, t = query_start, target_start
    for n, op in ops:
        if op == "=":
            q += n
            t += n
        elif op == "D":
            t += n
        elif op in "MX":
            q += n
            t += n
        elif op == "I":
            q += n
    return q, t


def try_swap_end_pattern(ops: list[Op], query: bytes, target: bytes,
                         query_start: int, target_start: int) -> list[Op]:
    """... Dlen D N= -> ... N= Dlen D when sequences agree
    (wflign_swizzle.cpp:try_swap_end_pattern). The reference computes end
    coordinates counting only '=' and 'D' ops (alignment_end_coords), which
    we reproduce."""
    if len(ops) < 2:
        return ops
    (n1, op1), (n2, op2) = ops[-2], ops[-1]
    if op1 == "D" and op2 == "=":
        # alignment_end_coords counts only '=' and 'D'
        q, t = query_start, target_start
        for n, op in ops:
            if op == "=":
                q += n
                t += n
            elif op == "D":
                t += n
        if _seq_match(query, target, q - n2, t - n2 - n1, n2):
            cand = merge_ops(ops[:-2] + [(n2, "="), (n1, "D")])
            if validate(cand, query, target, query_start, target_start,
                        only_eq_d=True):
                return cand
    return ops


def validate(ops: list[Op], query: bytes, target: bytes, query_start: int,
             target_start: int, only_eq_d: bool = False) -> bool:
    """Verify a CIGAR against the sequences: '=' columns must match, 'X'
    must mismatch, coordinates must stay in bounds."""
    q, t = query_start, target_start
    for n, op in ops:
        if op == "=" or (only_eq_d and op == "M"):
            if q < 0 or t < 0 or q + n > len(query) or t + n > len(target):
                return False
            if query[q : q + n] != target[t : t + n]:
                return False
            q += n
            t += n
        elif op == "X":
            if only_eq_d:
                return False
            if q + n > len(query) or t + n > len(target):
                return False
            for i in range(n):
                if query[q + i] == target[t + i]:
                    return False
            q += n
            t += n
        elif op == "I":
            if only_eq_d:
                return False
            q += n
        elif op == "D":
            t += n
        else:
            return False
        if q > len(query) or t > len(target):
            return False
    return True
