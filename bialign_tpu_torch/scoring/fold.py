"""Built-in RNA partition function: base-pair probabilities + MEA structure.

The reference can only align RNAs without a given structure when the
ViennaRNA C library is installed (lazy ``import RNA``,
bialignment.pyx:347-353; otherwise it errors).  This module makes the
framework standalone: a McCaskill-style inside/outside computation over a
Nussinov-class energy model (per-pair Boltzmann weights, minimum hairpin
loop) produces a symmetric base-pair-probability matrix compatible with
everything downstream (``mea``, ``consensus_sbpp``, the stral-like mu2
scoring).

DOCUMENTED DIVERGENCE: probabilities differ numerically from ViennaRNA's
Turner-model ensemble — this is a fallback for when ViennaRNA is absent,
not a re-implementation of it.  When ViennaRNA is importable the
preprocessing uses it, exactly like the reference.

Algorithm (host numpy, float64, O(n^3) inside / sparse outside):

  Qb[i,j] = w(i,j) * Q[i+1,j-1]                 (i pairs j)
  Q[i,j]  = Q[i,j-1] + sum_k Q[i,k-1] * Qb[k,j] (rightmost-pair decomp.)
  P[i,j]  = Qb[i,j] * ( Qext + sum over direct enclosers (k,l):
            P[k,l] * Q[k+1,i-1] * Q[j+1,l-1] / Q[k+1,l-1] )

with per-base rescaling to keep doubles in range.

Both recursions are numpy-vectorized and exactly O(n^3) (a pure-Python
triple loop is the wall at ~1k nt when ViennaRNA is absent, the corpus
case the reference offloads to ViennaRNA's C, pyx:347-353): the inside runs one masked mat-vec per
column (BLAS) and the outside maintains the encloser sum G[k, j]
incrementally with one O(n^2) rank-style update + one O(n^2)
contraction per span (no probability cutoff).  A 300-nt RNA
preprocesses in well under a second; ~1k nt in a few seconds
(tests/test_fold.py).
"""

from __future__ import annotations

import numpy as np

# Boltzmann weights per pair type (unitless; roughly exp(stacking
# strength)): GC strongest, AU, then the GU wobble.
PAIR_WEIGHTS = {
    ("G", "C"): 20.0, ("C", "G"): 20.0,
    ("A", "U"): 7.0, ("U", "A"): 7.0,
    ("G", "U"): 2.0, ("U", "G"): 2.0,
}
MIN_HAIRPIN = 3  # minimum unpaired bases enclosed by a pair


def _weight_matrix(seq: str, scale: float) -> np.ndarray:
    n = len(seq)
    s = seq.upper().replace("T", "U")
    w = np.zeros((n, n))
    for i in range(n):
        for j in range(i + MIN_HAIRPIN + 1, n):
            w[i, j] = PAIR_WEIGHTS.get((s[i], s[j]), 0.0) / (scale * scale)
    return w


def partition_bpp(seq: str) -> np.ndarray:
    """Base-pair probability matrix, 1-based (n+1, n+1), symmetric, with
    the diagonal holding the unpaired probability (same convention as
    ``symmetrize_bpps``, bialignment.pyx:326-338)."""
    n = len(seq)
    if n == 0:
        return np.zeros((1, 1))
    # rescale so Q stays in double range (the math is homogeneous in a
    # per-base factor, so any uniform scale cancels exactly in P): aim
    # the DOMINANT per-base contribution at ~1/1.9 — secondary-structure
    # COUNT grows ~1.86^n, so centering the combined growth keeps both
    # Qtot and single-structure weights inside double range to ~1k nt
    # (beyond that the weakest configurations underflow gracefully to
    # probability 0; Qtot itself is guarded below).
    scale = max(1.0, 1.35 * max(PAIR_WEIGHTS.values()) ** 0.25)
    w = _weight_matrix(seq, scale)
    inv = 1.0 / scale

    # inside, one masked mat-vec per column.  Q[i, j] = partition weight
    # of the 0-based half-open interval [i, j); initialized to 1 so
    # empty/inverted intervals read as 1 without branching.  Qm is the
    # strictly-masked copy (Qm[i, k] = Q[i, k] for k >= i, else 0) that
    # makes "sum over k in [i, jj]" a plain mat-vec.
    Q = np.ones((n + 2, n + 2))
    Qm = np.triu(np.ones((n + 2, n + 2)))
    Qb = np.zeros((n, n))
    for jj in range(n):           # jj = last index of the interval
        # Qb column: pairs (i, jj); inner content is Q[i+1, jj]
        col_w = w[:jj + 1, jj]
        live = col_w > 0.0
        if live.any():
            Qb[:jj + 1, jj] = col_w * np.where(live, Q[1:jj + 2, jj], 0.0)
        # Q column jj+1: last base unpaired, or paired with some k>=i
        contrib = Qm[: jj + 1, : jj + 1] @ Qb[: jj + 1, jj]
        Q[: jj + 1, jj + 1] = Q[: jj + 1, jj] * inv + contrib
        Qm[: jj + 2, jj + 1] = Q[: jj + 2, jj + 1]

    Qtot = Q[0, n] if n > 0 else 1.0
    if Qtot <= 0.0 or not np.isfinite(Qtot):
        # no structure possible — everything unpaired
        sbpp = np.zeros((n + 1, n + 1))
        np.fill_diagonal(sbpp, 1.0)
        sbpp[0, 0] = 0.0
        return sbpp

    # outside, longest spans first, exact O(n^3).  Qout[i, j] = weight
    # of everything outside the pair (i, j):
    #   Qout[i, j] = q(0, i-1) * q(j+1, n-1)                 [no encloser]
    #     + sum_{k<i, l>j} w[k, l] * Qout[k, l] * q(k+1, i-1) * q(j+1, l-1)
    # (the innermost-encloser decomposition; P = Qb * Qout / Qtot).
    # The l-sum is maintained incrementally: after a span's diagonal of
    # Qout is final, its pairs' contributions fold into
    #   G[k, j] = sum_{l>j} w[k, l] * Qout[k, l] * q(j+1, l-1)
    # (one rank-style O(n^2) update per span), and the next diagonals
    # read sum_{k<i} q(k+1, i-1) * G[k, j] as one O(n^2) contraction —
    # no probability cutoff, bit-for-bit the full sum.
    P = np.zeros((n, n))
    G = np.zeros((n, n))
    q0 = Q[0, :]                       # q(0, i-1) = weight left of i
    qn = Q[:, n]                       # q(j+1, n-1) = weight right of j
    # L[k, i] = q(k+1, i-1) for k < i (empty flank == 1), else 0
    L = Qm[1:n + 1, :n]
    for span in range(n - 1, MIN_HAIRPIN, -1):
        nd = n - span                  # diagonal length
        i_all = np.arange(nd)
        jj_all = i_all + span
        qout = q0[i_all] * qn[jj_all + 1]
        if span < n - 1:
            # sum_{k < i} L[k, i] * G[k, i + span]
            qout = qout + np.einsum(
                "ki,ki->i", L[:, :nd], G[:, span:span + nd]
            )
        wdiag = w[i_all, jj_all]
        live = wdiag > 0.0
        if live.any():
            P[i_all[live], jj_all[live]] = (
                Qb[i_all[live], jj_all[live]] * qout[live] / Qtot
            )
            # fold this span's pairs into G: for pair (k, k+span),
            # G[k, j] += w * Qout * q(j+1, k+span-1)   for j < k+span
            val = np.where(live, wdiag * qout, 0.0)
            # Qm[j+1, k+span] = q(j+1, k+span-1) for j+1 <= k+span
            G[:nd, :] += val[:, None] * Qm[1:n + 1, i_all + span].T

    if not np.isfinite(P).all():
        raise ValueError(
            f"partition function over/underflowed for this {n}-nt "
            "sequence — beyond the built-in fallback's practical length "
            "range (~1k nt); install ViennaRNA for long RNAs"
        )

    # 1-based symmetric sbpp with unpaired probability on the diagonal
    sbpp = np.zeros((n + 1, n + 1))
    sbpp[1:, 1:] = P + P.T
    for i in range(1, n + 1):
        sbpp[i, i] = 1.0 - sbpp[i].sum()
    return sbpp


def predict_structure(seq: str):
    """(dot-bracket structure, sbpp) via the built-in partition function +
    MEA decoding — the fallback analog of the reference's
    ViennaRNA ``pf()`` + ``mea`` path (pyx:349-354)."""
    from .structure import mea

    sbpp = partition_bpp(seq)
    structure, _ = mea(sbpp)
    return structure, sbpp
