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


def _shift_by(col, total):
    """Mutate running shift record [netA, netB, |netA|+|netB|] (pyx:541-545)."""
    total[0] += col[0] - col[2]
    total[1] += col[1] - col[3]
    total[2] = abs(total[0]) + abs(total[1])
    return total


class TracebackIncomplete(Warning):
    pass


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

    # -- start state: best score, ties broken by minimal intrinsic shift,
    #    then by state enumeration order (pyx:573-582)
    final = [cell(q, n, m, n, m) for q in range(N_STATES)]
    best_score = max(final)
    best_states = [q for q in range(N_STATES) if final[q] == best_score]
    intrinsic = [
        abs(STATES[q][0] - STATES[q][2]) + abs(STATES[q][1] - STATES[q][3])
        for q in best_states
    ]
    q = best_states[int(np.argmin(intrinsic))]

    cases = [list(iter_affine_cases(t)) for t in range(N_STATES)]

    trace = []
    idx = [n, m, n, m]
    total_shift = [0, 0, 0]
    complete = False
    first = True
    while True:
        # Quirk kept for parity: the reference's start state is a tuple, so
        # its `state == [1,1,1,1]` termination test (pyx:551) can never pass
        # on the initial call — only after at least one traced column.
        if idx == [0, 0, 0, 0] and q == STATE_BOTH_MATCH and not first:
            complete = True
            break
        first = False
        i, j, k, l = idx
        here = cell(q, i, j, k, l)

        candidates = []
        for (src, col, mu1c, mu2c, ng, nb, nd, _g) in cases[q]:
            if not guard_case(col, idx, S):
                continue
            pi, pj = i - col[0], j - col[1]
            pk, pl = k - col[2], l - col[3]
            val = (
                cell(src, pi, pj, pk, pl)
                + ng * gamma
                + nb * beta
                + nd * delta
                + mu1c * int(mu1[i, j])
                + mu2c * int(mu2[k, l])
            )
            if val == here:
                tmp = total_shift[:]
                _shift_by(col, tmp)
                _shift_by(STATES[src], tmp)
                candidates.append((src, col, tmp))

        if not candidates:
            break

        keys = [(tmp[2], abs(tmp[1])) for _src, _col, tmp in candidates]
        sel = min(range(len(keys)), key=keys.__getitem__)
        src, col, _tmp = candidates[sel]
        _shift_by(col, total_shift)  # persistent record gets the column only
        trace.append(col)
        idx = [i - col[0], j - col[1], k - col[2], l - col[3]]
        q = src

    return list(reversed(trace)), complete


def nonaffine_traceback(H, mu1, mu2, max_shift, gamma, delta):
    """Forward trace for a non-affine band H[i, j, sk, sl] (pyx:513-531)."""
    S = max_shift
    n = H.shape[0] - 1
    m = H.shape[1] - 1
    tab = NonAffineTables(gamma, delta)
    cols = [tuple(int(v) for v in c) for c in tab.cols]

    def cell(i, j, k, l):
        return int(H[i, j, k - i + S, l - j + S])

    trace = []
    idx = (n, m, n, m)
    while True:
        i, j, k, l = idx
        here = cell(i, j, k, l)
        advanced = False
        for ci, col in enumerate(cols):
            if not guard_case(col, idx, S):
                continue
            pi, pj = i - col[0], j - col[1]
            pk, pl = k - col[2], l - col[3]
            val = (
                cell(pi, pj, pk, pl)
                + int(tab.const[ci])
                + int(tab.mu1_coef[ci]) * int(mu1[i, j])
                + int(tab.mu2_coef[ci]) * int(mu2[k, l])
            )
            if val == here:
                trace.append(col)
                idx = (pi, pj, pk, pl)
                advanced = True
                break
        if not advanced:
            break

    return list(reversed(trace))
