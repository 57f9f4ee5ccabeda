"""The BiAlign recurrence as data, written from its definition.

A column of a bi-alignment is x = (x0, x1, x2, x3) in {0, 1}^4: whether it
advances A and B in the sequence alignment (x0, x1) and A and B in the
structure alignment (x2, x3).  A cell (i, j, k, l) is reached from
(i - x0, j - x1, k - x2, l - x3); the band keeps |k - i| <= S and
|l - j| <= S (S = max_shift).  Scores (upstream bialignment.pyx:84-131,
225-296):

* non-affine: 13 columns, in the upstream order; a column pays gamma for
  each half that advances one molecule only, delta once when its sequence
  half differs from its structure half, mu1(i, j) when both molecules
  advance in the sequence half and mu2(k, l) when both do in the structure
  half;
* affine: 9 states, the columns whose halves both advance; a target state
  (a, b, c, d) takes group A (its own column from any state), group B (the
  column (0, 0, c, d) from states (a, b, h)) and group C (the column
  (a, b, 0, 0) from states (h, c, d)), h over (1, 1), (1, 0), (0, 1) in
  that order; a half that advances one molecule pays gamma, and beta unless
  the source state's half gapped the same way; delta per unit of
  |x0 - x2| + |x1 - x3|.

Nothing here comes from the program under test.
"""

from __future__ import annotations

from itertools import product

NEG_INF = -(1 << 30)            # the value of a cell with no valid case

PAIRS = ((0, 1), (1, 0), (1, 1))          # half patterns, state order
HALF_ORDER = ((1, 1), (1, 0), (0, 1))     # order of h in groups B and C
STATES = tuple(ab + cd for ab in PAIRS for cd in PAIRS)
BOTH_MATCH = STATES.index((1, 1, 1, 1))

NONAFFINE_COLUMNS = (
    (1, 1, 1, 1), (1, 0, 1, 0), (0, 1, 0, 1), (1, 1, 0, 0), (0, 0, 1, 1),
    (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1), (1, 0, 1, 1),
    (0, 1, 1, 1), (1, 1, 1, 0), (1, 1, 0, 1),
)


def nonaffine_terms(col):
    """(n_gamma, n_delta, mu1 scored, mu2 scored) of a non-affine column."""
    a, b, c, d = col
    return ((a ^ b) + (c ^ d), int((a, b) != (c, d)), a & b, c & d)


def _half_gap(xa, xb, sa, sb):
    """(n_gamma, n_beta) of one half of an affine column from the same half
    of the source state."""
    if xa == xb:
        return 0, 0
    opened = (sa, sb) != (xa, xb)
    return 1, int(opened)


def affine_terms(src, col):
    """(n_gamma, n_beta, n_delta, mu1 scored, mu2 scored) of the affine
    column ``col`` taken from state ``src``."""
    g1, b1 = _half_gap(col[0], col[1], src[0], src[1])
    g2, b2 = _half_gap(col[2], col[3], src[2], src[3])
    n_delta = abs(col[0] - col[2]) + abs(col[1] - col[3])
    return g1 + g2, b1 + b2, n_delta, col[0] & col[1], col[2] & col[3]


def affine_cases(q):
    """The cases of target state ``q`` in the upstream order:
    [(source state index, column, group)]."""
    a, b, c, d = STATES[q]
    out = [(s, (a, b, c, d), "A") for s in range(len(STATES))]
    out += [(STATES.index((a, b) + h), (0, 0, c, d), "B") for h in HALF_ORDER]
    out += [(STATES.index(h + (c, d)), (a, b, 0, 0), "C") for h in HALF_ORDER]
    return out


def case_value_terms(affine, costs):
    """Every case as (target, source, column, constant, mu1 scored, mu2
    scored), targets and sources 0 for the non-affine recurrence; ``costs``
    (beta, gamma, delta) or (gamma, delta)."""
    out = []
    if affine:
        beta, gamma, delta = costs
        for q in range(len(STATES)):
            for s, col, _g in affine_cases(q):
                ng, nb, nd, m1, m2 = affine_terms(STATES[s], col)
                out.append((q, s, col, ng * gamma + nb * beta + nd * delta,
                            m1, m2))
    else:
        gamma, delta = costs
        for col in NONAFFINE_COLUMNS:
            ng, nd, m1, m2 = nonaffine_terms(col)
            out.append((0, 0, col, ng * gamma + nd * delta, m1, m2))
    return out


def pred_in_band(col, i, j, k, l, S):
    """Whether the predecessor of (i, j, k, l) by ``col`` lies in the band."""
    pi, pj, pk, pl = i - col[0], j - col[1], k - col[2], l - col[3]
    return (min(pi, pj, pk, pl) >= 0 and abs(pk - pi) <= S
            and abs(pl - pj) <= S)


def all_columns():
    return [c for c in product((0, 1), repeat=4) if any(c)]
