"""Host-side traceback over a filled DP band — bit-exact reference order.

Parity targets:
* non-affine: bialignment.pyx:513-531 (first case whose re-evaluated score
  equals the cell value wins; depth-first walk from (n, m, n, m)).
* affine "smart" traceback: pyx:535-586 — collect ALL co-optimal predecessor
  cases, then pick argmin of [total |shift| so far, |net B shift|]
  (enumeration order breaks residual ties), with the start state chosen as
  the best-scoring state of minimal intrinsic shift (pyx:573-582).

Implemented iteratively (the reference recurses; co-optimal paths on
~1000-residue inputs exceed CPython's recursion limit only because Cython
compiles the closure to C — an iterative walk is semantics-identical).

The band H comes from any engine; values are compared exactly, so the fill
must be bit-exact (all engines are validated for that).
"""

from __future__ import annotations

import numpy as np

from .cases import (
    N_STATES,
    STATES,
    STATE_BOTH_MATCH,
    NonAffineTables,
    guard_case,
    iter_affine_cases,
)


class TracebackIncomplete(Warning):
    pass


_AFFINE_CASES = [list(iter_affine_cases(t)) for t in range(N_STATES)]
_INTRINSIC = [abs(s[0] - s[2]) + abs(s[1] - s[3]) for s in STATES]


def affine_start_state(final) -> int:
    """Start state of the affine walk from the 9 values of the last cell
    (n, m, n, m): best score, ties broken by minimal intrinsic shift, then
    by state enumeration order (pyx:573-582)."""
    best_score = max(final)
    best_states = [q for q in range(N_STATES) if final[q] == best_score]
    intrinsic = [_INTRINSIC[q] for q in best_states]
    return best_states[int(np.argmin(intrinsic))]


def affine_walk(cell, mu1, mu2, max_shift, beta, gamma, delta, state, *,
                stop_below=0, cap=None):
    """Walk the affine band read through ``cell(q, i, j, k, l)`` from
    ``state`` = (i, j, k, l, q, netA, netB, first) until the origin is
    reached (done 1), no case matches (done 2), i + j falls below
    ``stop_below`` or ``cap`` columns were taken (done 0).  ``netA``,
    ``netB``: the net shift of the columns walked so far; ``first``: no
    column taken yet.  Returns (columns in walk order, state, done)."""
    S = max_shift
    i, j, k, l, q, net_a, net_b, first = state
    cols = []
    done = 0
    while cap is None or len(cols) < cap:
        if i + j < stop_below:
            break
        # Quirk kept for parity: the reference's start state is a tuple, so
        # its `state == [1,1,1,1]` termination test (pyx:551) can never pass
        # on the initial call — only after at least one traced column.
        if (i, j, k, l) == (0, 0, 0, 0) and q == STATE_BOTH_MATCH \
                and not first:
            done = 1
            break
        here = cell(q, i, j, k, l)

        # of all co-optimal cases the least [total |shift|, |net B shift|]
        # with this column and the source state's intrinsic shift counted
        # in; the first minimum wins (pyx:541-545, :564)
        best = None
        for (src, col, mu1c, mu2c, ng, nb, nd, _g) in _AFFINE_CASES[q]:
            if not guard_case(col, (i, j, k, l), S):
                continue
            val = (
                cell(src, i - col[0], j - col[1], k - col[2], l - col[3])
                + ng * gamma
                + nb * beta
                + nd * delta
                + mu1c * int(mu1[i, j])
                + mu2c * int(mu2[k, l])
            )
            if val == here:
                t_a = net_a + col[0] - col[2] + STATES[src][0] - STATES[src][2]
                t_b = net_b + col[1] - col[3] + STATES[src][1] - STATES[src][3]
                key = (abs(t_a) + abs(t_b), abs(t_b))
                if best is None or key < best[0]:
                    best = (key, src, col)

        if best is None:
            done = 2
            break
        _key, src, col = best
        cols.append(col)
        i, j, k, l = i - col[0], j - col[1], k - col[2], l - col[3]
        # the persistent record gets the column only
        net_a += col[0] - col[2]
        net_b += col[1] - col[3]
        q = src
        first = False
    return cols, (i, j, k, l, q, net_a, net_b, first), done


def affine_traceback(H, mu1, mu2, max_shift, beta, gamma, delta):
    """Return (trace, complete) for an affine band H[q, i, j, sk, sl].

    ``trace`` is the forward-ordered list of column 4-tuples; ``complete``
    is False when the walk could not reach the origin (the reference prints
    a warning in that case, pyx:584-585).
    """
    S = max_shift
    n = H.shape[1] - 1
    m = H.shape[2] - 1

    def cell(q, i, j, k, l):
        return int(H[q, i, j, k - i + S, l - j + S])

    q = affine_start_state([cell(s, n, m, n, m) for s in range(N_STATES)])
    cols, _state, done = affine_walk(
        cell, mu1, mu2, S, beta, gamma, delta, (n, m, n, m, q, 0, 0, True))
    return list(reversed(cols)), done == 1


def nonaffine_walk(cell, mu1, mu2, max_shift, gamma, delta, state, *,
                   stop_below=0, cap=None):
    """Walk the non-affine band read through ``cell(i, j, k, l)`` from
    ``state`` = (i, j, k, l): at each cell the first case whose re-evaluated
    value equals the cell's (pyx:513-531), until none does (done 1), i + j
    falls below ``stop_below`` or ``cap`` columns were taken (done 0).
    Returns (columns in walk order, state, done)."""
    S = max_shift
    tab = NonAffineTables(gamma, delta)
    cases = [(tuple(int(v) for v in c), int(tab.const[ci]),
              int(tab.mu1_coef[ci]), int(tab.mu2_coef[ci]))
             for ci, c in enumerate(tab.cols)]
    i, j, k, l = state
    cols = []
    done = 0
    while cap is None or len(cols) < cap:
        if i + j < stop_below:
            break
        here = cell(i, j, k, l)
        for col, const, mu1c, mu2c in cases:
            if not guard_case(col, (i, j, k, l), S):
                continue
            pi, pj = i - col[0], j - col[1]
            pk, pl = k - col[2], l - col[3]
            val = (cell(pi, pj, pk, pl) + const + mu1c * int(mu1[i, j])
                   + mu2c * int(mu2[k, l]))
            if val == here:
                cols.append(col)
                i, j, k, l = pi, pj, pk, pl
                break
        else:
            done = 1
            break
    return cols, (i, j, k, l), done


def nonaffine_traceback(H, mu1, mu2, max_shift, gamma, delta):
    """Forward trace for a non-affine band H[i, j, sk, sl] (pyx:513-531)."""
    S = max_shift
    n = H.shape[0] - 1
    m = H.shape[1] - 1

    def cell(i, j, k, l):
        return int(H[i, j, k - i + S, l - j + S])

    cols, _state, _done = nonaffine_walk(cell, mu1, mu2, S, gamma, delta,
                                         (n, m, n, m))
    return list(reversed(cols))
