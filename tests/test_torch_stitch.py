"""The segmented engine's stitching of a block's piece CIGARs
(wfmash_tpu_torch.align.cigar.stitch_pieces) against the incremental
fold it replaces, kept here as the oracle: the same list, element for
element and type for type, on seeded random piece lists with empty
pieces, zero-length ops, unnormalised pieces and runs across junctions;
and the ops the stitch visits, counted, stay linear in the block."""

import copy

import numpy as np
import pytest

from wfmash_tpu_torch.align.cigar import merge_adjacent, stitch_pieces

OPS = "=XID"


def _fold(pieces):
    """The engine's stitching before the one-pass form: merge_adjacent
    once a piece over the growing list."""
    ops: list = []
    for p in pieces:
        ops = merge_adjacent(ops, p) if ops else list(p)
    return ops


def _piece(rng, n_ops, zero, runs, ops=OPS):
    """A random piece of `n_ops` ops; `zero`: share of zero-length ops;
    `runs`: share of ops that repeat the op before them."""
    out = []
    for _ in range(n_ops):
        if out and rng.random() < runs:
            op = out[-1][1]
        else:
            op = ops[int(rng.integers(len(ops)))]
        n = 0 if rng.random() < zero else int(rng.integers(1, 40))
        out.append((n, op))
    return out


def _pieces(seed, n, max_ops=6, empty=0.0, zero=0.0, runs=0.0,
            ops=OPS, lead=0, trail=0):
    rng = np.random.default_rng(seed)
    body = [[] if rng.random() < empty else
            _piece(rng, int(rng.integers(1, max_ops + 1)), zero, runs, ops)
            for _ in range(n)]
    return [[] for _ in range(lead)] + body + [[] for _ in range(trail)]


def _engine_like(seed, n):
    """Normalised ~256 bp pieces with a mismatch every 10-90 bp, as the
    planner cuts a 2%-diverged block."""
    rng = np.random.default_rng(seed)
    pieces = []
    for _ in range(n):
        p, left = [], 256
        while left > 0:
            run = min(left, int(rng.integers(10, 90)))
            p.append((run, "="))
            left -= run
            if left > 0:
                p.append((1, "X"))
                left -= 1
        pieces.append(p)
    return pieces


CASES = {
    "none": lambda: [],
    "one_empty": lambda: [[]],
    "single_raw": lambda: [[(0, "="), (3, "="), (3, "="), (0, "X")]],
    "single_lists": lambda: [[[2, "="], [2, "="]]],
    "lead_empty_then_raw": lambda: [[], [], [(2, "I"), (2, "I"), (0, "D")]],
    "lead_empty_then_two": lambda: [[], [(2, "="), (0, "X")], [(3, "=")]],
    "zero_only_then_raw": lambda: [[(0, "=")], [(0, "X")],
                                   [(1, "D"), (1, "D")]],
    "zero_only_then_two": lambda: [[(0, "=")], [(0, "X")], [(1, "D")],
                                   [(1, "D"), (0, "I")]],
    "junction_runs": lambda: [[(3, "=")], [(4, "=")], [(1, "X"), (2, "=")],
                              [(5, "=")]],
    "trailing_empty": lambda: [[(3, "="), (3, "=")], [], []],
    "pieces_2": lambda: _pieces(1, 2, runs=0.5),
    "pieces_17_mixed": lambda: _pieces(2, 17, empty=0.2, zero=0.2,
                                       runs=0.3, lead=2, trail=2),
    "pieces_300_unnormalised": lambda: _pieces(3, 300, max_ops=9, zero=0.3,
                                               runs=0.6),
    "pieces_300_empty_middle": lambda: _pieces(4, 300, empty=0.5),
    "pieces_1000_two_ops": lambda: _pieces(5, 1000, ops="=X", runs=0.4,
                                           lead=3, trail=3, empty=0.1),
    "pieces_4000": lambda: _pieces(6, 4000, max_ops=2, ops="==XI",
                                   zero=0.1, runs=0.7, empty=0.05,
                                   lead=1, trail=1),
    "engine_like_195": lambda: _engine_like(7, 195),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stitch_equals_the_incremental_fold(case):
    pieces = CASES[case]()
    before = copy.deepcopy(pieces)
    got = stitch_pieces(pieces)
    want = _fold(pieces)
    assert repr(got) == repr(want)
    assert [type(e) for e in got] == [type(e) for e in want]
    # the pieces are read, never changed
    assert pieces == before


@pytest.mark.parametrize("seed", range(40))
def test_stitch_equals_the_fold_on_drawn_shapes(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(0, 60))
    pieces = _pieces(seed, n, max_ops=int(rng.integers(1, 8)),
                     empty=float(rng.random()) * 0.6,
                     zero=float(rng.random()) * 0.6,
                     runs=float(rng.random()),
                     lead=int(rng.integers(0, 3)),
                     trail=int(rng.integers(0, 3)))
    assert repr(stitch_pieces(pieces)) == repr(_fold(pieces))


class _Len(int):
    """An op length that counts each time it is compared or tested."""

    seen = 0

    def _counted(name):
        f = getattr(int, name)

        def g(self, *a):
            _Len.seen += 1
            return f(self, *a)
        return g

    __le__ = _counted("__le__")
    __lt__ = _counted("__lt__")
    __ge__ = _counted("__ge__")
    __gt__ = _counted("__gt__")
    __eq__ = _counted("__eq__")
    __ne__ = _counted("__ne__")
    __bool__ = _counted("__bool__")
    __hash__ = int.__hash__

    def __add__(self, other):
        return _Len(int(self) + int(other))

    __radd__ = __add__


def _visits(stitch, pieces):
    pieces = [[(_Len(n), op) for n, op in p] for p in pieces]
    _Len.seen = 0
    out = stitch(pieces)
    return _Len.seen, out


def test_stitch_visits_each_op_once():
    """A 4000-piece block: the stitch looks at no more ops than the
    block holds plus its pieces (the fold re-reads the growing list once
    a piece, and goes far past that bound already at 400 pieces)."""
    pieces = _engine_like(8, 4000)
    total = sum(len(p) for p in pieces)
    seen, out = _visits(stitch_pieces, pieces)
    assert total - len(pieces[0]) <= seen <= total + len(pieces)
    assert out == stitch_pieces(_engine_like(8, 4000))
    short = pieces[:400]
    seen_fold, _ = _visits(_fold, short)
    assert seen_fold > 10 * (sum(len(p) for p in short) + len(short))
