"""State and recursion-case tables for the bi-alignment DP.

This module is the single source of truth for the recurrence used by every
engine (the CUDA kernels and their plain PyTorch versions): the reference's
per-cell Python generators (bialignment.pyx:225-296) are re-expressed as
static integer tables so the DP becomes pure tensor arithmetic.

Background (reference semantics):

* An alignment column is a 0/1 vector x = (x0, x1, x2, x3): does the column
  advance (seqA-in-seq-alignment, seqB-in-seq-alignment, seqA-in-structure-
  alignment, seqB-in-structure-alignment)?
* Affine mode tracks 9 states = columns with (x0,x1) != (0,0) and
  (x2,x3) != (0,0), in the reference's itertools.product order
  (pyx:61-65); the state records the last column's gap pattern per
  sub-alignment half for gap-opening decisions.
* Column score (pyx:84-131):
    Delta * (|x0-x2| + |x1-x3|)                       -- shift term
  + [x0&x1] * mu1(i,j)                                 -- seq match
  + [x0^x1] * (gamma + beta * [source gap dir differs])-- seq gap
  + the analogous structure terms with mu2(k,l).
  We decompose each (source_state, column) pair into integer multiplicities
  (mu1_coef, mu2_coef, n_gamma, n_beta, n_delta) so parameter-dependent
  constants are a tiny einsum at setup time.
* Affine recursion cases per target state (pyx:255-296), in order:
    group A: 9 full columns   (column == target state, any source state)
    group B: 3 str-only halves (column (0,0,c,d), source (a,b,*,*))
    group C: 3 seq-only halves (column (a,b,0,0), source (*,*,c,d))
  The enumeration order is parity-critical for traceback tie-breaking.
* Non-affine recursion: 13 columns per cell (pyx:225-252), order below.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -(1 << 30)  # reference's -infinity: plus() of an empty case set
INT32_SENTINEL = np.int32(np.iinfo(np.int32).min)  # masked-out contribution

# The 9 affine states in reference enumeration order (pyx:61-65).
STATES = tuple(
    (a, b, c, d)
    for a in (0, 1)
    for b in (0, 1)
    for c in (0, 1)
    for d in (0, 1)
    if (a, b) != (0, 0) and (c, d) != (0, 0)
)
STATES_ARR = np.array(STATES, dtype=np.int32)
STATE_INDEX = {s: q for q, s in enumerate(STATES)}
N_STATES = len(STATES)  # 9
STATE_BOTH_MATCH = STATE_INDEX[(1, 1, 1, 1)]  # 8

# Half-state enumeration order for groups B and C (pyx:281-282).
HALF_STATES = ((1, 1), (1, 0), (0, 1))

# Non-affine columns in reference yield order (pyx:233-248).
NONAFFINE_COLS = (
    (1, 1, 1, 1),
    (1, 0, 1, 0),
    (0, 1, 0, 1),
    (1, 1, 0, 0),
    (0, 0, 1, 1),
    (1, 0, 0, 0),
    (0, 1, 0, 0),
    (0, 0, 1, 0),
    (0, 0, 0, 1),
    (1, 0, 1, 1),
    (0, 1, 1, 1),
    (1, 1, 1, 0),
    (1, 1, 0, 1),
)
N_NONAFFINE_CASES = len(NONAFFINE_COLS)  # 13


def guard_case(o, x, max_shift: int) -> bool:
    """Predecessor validity (pyx:133-148): componentwise x - o >= 0 and the
    predecessor stays inside the shift band."""
    return (
        x[0] - o[0] >= 0
        and x[1] - o[1] >= 0
        and x[2] - o[2] >= 0
        and x[3] - o[3] >= 0
        and abs(x[2] - o[2] - (x[0] - o[0])) <= max_shift
        and abs(x[3] - o[3] - (x[1] - o[1])) <= max_shift
    )


def _gap_multiplicities(xa: int, xb: int, sa: int, sb: int):
    """(n_gamma, n_beta) contribution of one sub-alignment pair of a column.

    Mirrors one half of affine_score (pyx:103-129): a single-advance column
    pays gap extension, plus gap opening unless the source state already
    gapped in the same direction.
    """
    if xa and xb:
        return 0, 0
    if xa and not xb:
        return 1, 0 if (sa, sb) == (1, 0) else 1
    if xb and not xa:
        return 1, 0 if (sa, sb) == (0, 1) else 1
    return 0, 0


def affine_score_multiplicities(src, col):
    """(mu1_coef, mu2_coef, n_gamma, n_beta, n_delta) for one affine case."""
    n_delta = abs(col[0] - col[2]) + abs(col[1] - col[3])
    mu1c = 1 if (col[0] and col[1]) else 0
    mu2c = 1 if (col[2] and col[3]) else 0
    g1, b1 = _gap_multiplicities(col[0], col[1], src[0], src[1])
    g2, b2 = _gap_multiplicities(col[2], col[3], src[2], src[3])
    return mu1c, mu2c, g1 + g2, b1 + b2, n_delta


def iter_affine_cases(q: int):
    """Yield the affine cases of target state q in exact reference order.

    Each item: (src_state_index, column, mu1_coef, mu2_coef, n_gamma,
    n_beta, n_delta, group) with group in 'A'/'B'/'C'.  The caller applies
    the per-group guard on the column (pyx:275, 286, 292).
    """
    a, b, c, d = STATES[q]
    col = (a, b, c, d)
    for ss in range(N_STATES):
        yield (ss, col) + affine_score_multiplicities(STATES[ss], col) + ("A",)
    colB = (0, 0, c, d)
    for h0, h1 in HALF_STATES:
        src = (a, b, h0, h1)
        yield (STATE_INDEX[src], colB) + affine_score_multiplicities(
            src, colB
        ) + ("B",)
    colC = (a, b, 0, 0)
    for h0, h1 in HALF_STATES:
        src = (h0, h1, c, d)
        yield (STATE_INDEX[src], colC) + affine_score_multiplicities(
            src, colC
        ) + ("C",)


def nonaffine_case_multiplicities(col):
    """(mu1_coef, mu2_coef, n_gamma, n_delta) of a non-affine column.

    Matches the yielded scores at pyx:233-248: single advances cost gamma;
    double advances score mu; Delta is charged ONCE per column whose seq
    half advances differently from its str half (note the whole-pair shifts
    (1,1,0,0)/(0,0,1,1) pay a single Delta, unlike the affine scorer's
    per-component |x0-x2|+|x1-x3| term).
    """
    mu1c = 1 if (col[0] and col[1]) else 0
    mu2c = 1 if (col[2] and col[3]) else 0
    n_gamma = (col[0] ^ col[1]) + (col[2] ^ col[3])
    n_delta = 1 if (col[0], col[1]) != (col[2], col[3]) else 0
    return mu1c, mu2c, n_gamma, n_delta


def _check_nonaffine_consts():
    # The decomposition must reproduce the reference's literal case scores.
    expect = {
        (1, 1, 1, 1): (1, 1, 0, 0),
        (1, 0, 1, 0): (0, 0, 2, 0),
        (0, 1, 0, 1): (0, 0, 2, 0),
        (1, 1, 0, 0): (1, 0, 0, 1),
        (0, 0, 1, 1): (0, 1, 0, 1),
        (1, 0, 0, 0): (0, 0, 1, 1),
        (0, 1, 0, 0): (0, 0, 1, 1),
        (0, 0, 1, 0): (0, 0, 1, 1),
        (0, 0, 0, 1): (0, 0, 1, 1),
        (1, 0, 1, 1): (0, 1, 1, 1),
        (0, 1, 1, 1): (0, 1, 1, 1),
        (1, 1, 1, 0): (1, 0, 1, 1),
        (1, 1, 0, 1): (1, 0, 1, 1),
    }
    for col in NONAFFINE_COLS:
        assert nonaffine_case_multiplicities(col) == expect[col], col


_check_nonaffine_consts()


class AffineTables:
    """Parameter-bound constant tables for the affine recurrence.

    Given (beta, gamma, Delta) produces int32 arrays used by the tensor
    engines:

    * ``a_const[q, src]``: group-A constant (shift + gap terms) per target
      state q and source state src.
    * ``b_src[q, h]`` / ``b_const[q, h]``: group-B source-state indices and
      constants, h over HALF_STATES.
    * ``c_src[q, h]`` / ``c_const[q, h]``: group-C equivalents.
    * ``mu1_coef[q]`` / ``mu2_coef[q]``: does state q's full column score
      mu1/mu2 (group A); ``b_mu2_coef[q]``: does the str-only half column
      score mu2; ``c_mu1_coef[q]``: seq-only half, mu1.
    """

    def __init__(self, beta: int, gamma: int, delta: int, dtype=np.int32):
        self.beta, self.gamma, self.delta = beta, gamma, delta
        Q = N_STATES
        self.a_const = np.zeros((Q, Q), dtype=dtype)
        self.b_src = np.zeros((Q, 3), dtype=np.int32)
        self.b_const = np.zeros((Q, 3), dtype=dtype)
        self.c_src = np.zeros((Q, 3), dtype=np.int32)
        self.c_const = np.zeros((Q, 3), dtype=dtype)
        self.mu1_coef = np.zeros(Q, dtype=np.int32)
        self.mu2_coef = np.zeros(Q, dtype=np.int32)
        self.b_mu2_coef = np.zeros(Q, dtype=np.int32)
        self.c_mu1_coef = np.zeros(Q, dtype=np.int32)

        for q in range(Q):
            bi, ci = 0, 0
            for (src, col, mu1c, mu2c, ng, nb, nd, group) in iter_affine_cases(q):
                const = ng * gamma + nb * beta + nd * delta
                if group == "A":
                    self.a_const[q, src] = const
                    self.mu1_coef[q] = mu1c
                    self.mu2_coef[q] = mu2c
                elif group == "B":
                    self.b_src[q, bi] = src
                    self.b_const[q, bi] = const
                    self.b_mu2_coef[q] = mu2c
                    bi += 1
                else:
                    self.c_src[q, ci] = src
                    self.c_const[q, ci] = const
                    self.c_mu1_coef[q] = mu1c
                    ci += 1


    def a_const_separable(self):
        """Factor ``a_const[q, s]`` into per-pair terms.

        The group-A constant is a sum of independent contributions of the
        sequence pair and the structure pair (the shift term depends only
        on the target column; each pair's gap-open/extend term compares
        the TARGET column's gap direction for that pair with the SOURCE
        state's — pyx:110-129).  Hence

            a_const[q, s] == base[q] + cseq[qp(q), sp(s)]
                                      + cstr[qt(q), st(s)]

        where ``qp/sp`` are the pair codes of the seq halves and
        ``qt/st`` of the str halves (0=(1,1), 1=(1,0), 2=(0,1)).  The
        factorization lets the 9-source max per target become two chained
        3-way maxes shared across targets (90 instead of 153 slab ops in
        the Pallas kernel); int32 ``+`` associativity makes the regrouped
        arithmetic bit-identical.  Verified exhaustively below — raises
        if the table ever stops being separable.

        Returns (base[Q], cseq[3, 3], cstr[3, 3], src_idx[3, 3],
        seq_code[Q], str_code[Q]) as plain int lists.
        """
        Q = N_STATES
        pc = {(1, 1): 0, (1, 0): 1, (0, 1): 2}
        seq_code = [pc[(s[0], s[1])] for s in STATES]
        str_code = [pc[(s[2], s[3])] for s in STATES]
        inv = {v: k for k, v in pc.items()}
        A = self.a_const.astype(np.int64)

        def sidx(sp, st):
            tgt = inv[sp] + inv[st]
            return next(
                i for i, s in enumerate(STATES) if tuple(s) == tgt
            )

        src_idx = [[sidx(sp, st) for st in range(3)] for sp in range(3)]
        s00 = src_idx[0][0]
        base = [int(A[q, s00]) for q in range(Q)]
        # representative targets per pair code (any works; asserted below)
        q_of_seq = [next(q for q in range(Q) if seq_code[q] == sp)
                    for sp in range(3)]
        q_of_str = [next(q for q in range(Q) if str_code[q] == st)
                    for st in range(3)]
        cseq = [
            [int(A[q_of_seq[sp], src_idx[ss][0]] - A[q_of_seq[sp], s00])
             for ss in range(3)]
            for sp in range(3)
        ]
        cstr = [
            [int(A[q_of_str[st], src_idx[0][ss]] - A[q_of_str[st], s00])
             for ss in range(3)]
            for st in range(3)
        ]
        for q in range(Q):
            for s in range(Q):
                want = (base[q] + cseq[seq_code[q]][seq_code[s]]
                        + cstr[str_code[q]][str_code[s]])
                if want != int(A[q, s]):
                    raise AssertionError(
                        f"a_const not separable at q={q}, s={s}: "
                        f"{A[q, s]} != {want}"
                    )
        return base, cseq, cstr, src_idx, seq_code, str_code


class NonAffineTables:
    """Parameter-bound constants for the 13 non-affine cases."""

    def __init__(self, gamma: int, delta: int, dtype=np.int32):
        self.gamma, self.delta = gamma, delta
        self.cols = np.array(NONAFFINE_COLS, dtype=np.int32)
        mults = np.array(
            [nonaffine_case_multiplicities(c) for c in NONAFFINE_COLS],
            dtype=dtype,
        )
        self.mu1_coef = mults[:, 0]
        self.mu2_coef = mults[:, 1]
        self.const = mults[:, 2] * gamma + mults[:, 3] * delta


def int32_value_bound(mu1: np.ndarray, mu2: np.ndarray, params: dict) -> int:
    """Upper bound on |DP value - NEG_INF drift| to validate int32 safety.

    DP values live in [NEG_INF - D, POS], where D <= max_steps * max |column
    score| (a path has at most 2(n+m) columns).  The engines store int32, so
    we require NEG_INF - D > INT32_MIN with margin.
    """
    n = mu1.shape[0] - 1
    m = mu1.shape[1] - 1
    max_mu = max(
        int(np.abs(mu1).max(initial=0)), int(np.abs(mu2).max(initial=0))
    )
    per_col = (
        2 * abs(params.get("gap_cost", -200))
        + 2 * abs(params.get("gap_opening_cost", 0))
        + 2 * abs(params.get("shift_cost", -250))
        + 2 * max_mu
    )
    return 2 * (n + m + 2) * per_col


def check_int32_safe(mu1, mu2, params) -> bool:
    bound = int32_value_bound(mu1, mu2, params)
    return (-(1 << 30)) - bound > np.iinfo(np.int32).min + (1 << 20)
