"""Seeded fuzz cases for the port's kernels, twins and entry points.

One generator for both lanes: the CPU tests (``tests/test_torch_fuzz*.py``)
and ``chip_smoke.py``'s fuzz phase draw their cases here, so that a seed
names the same shape, max_shift, costs and tables on the CPU and on the
card.  It imports numpy alone (the card's machine has no JAX, and the tests
import it without torch's help).

A case is drawn from ``(family, seed)``:

- **shapes**: n and m from 0 to ``max_len``, kept uneven (n != m unless one
  is drawn empty); one seed in five makes one sequence empty, one in five
  puts the widest live range at R - 1, R or R + 1 rows of the family's tile
  (``rows``, the caller's ``cuda_dp.tile_rows``);
- **max_shift**: from 0 to ``max_shift``, capped by the family's own limit
  (:data:`LIMITS`); n and m shrink as the band widens, so that a case holds
  at most ``cells`` four-dimensional cells and a twin stays cheap;
- **costs** (beta, gamma, delta): uniform in [-500, 200] with beta != 0, as
  ``tests/test_fuzz.py:24-26`` draws them, or one of :data:`CORNER_COSTS`;
  seed % 5 picks which;
- **tables**: values in [-500, 900) as ``tests/test_fuzz.py:29-30``, the
  tie-heavy {0, +-100}, or values just inside the int32 certificate of
  ``ops/cases.check_int32_safe`` (one entry at the largest magnitude it
  certifies); seed % 3 picks which.  :func:`int32_outside_tables` gives
  tables just outside it, which must reach the int64 engine through
  ``BiAligner`` and no kernel.
"""

from dataclasses import dataclass

import numpy as np

COST_RANGE = (-500, 200)            # tests/test_fuzz.py:24-26, inclusive
TABLE_RANGE = (-500, 900)           # tests/test_fuzz.py:29-30, half-open
TIE_VALUES = (-100, 0, 100)
# beta (gap opening), gamma (gap extension), delta (shift); multiples of 50,
# so that with tie-heavy tables many cases tie
CORNER_COSTS = {
    "zero_gaps": (0, 0, 0),             # every gap and shift cost zero
    "shift_reward": (-150, -50, 100),   # a positive shift cost
    "gamma_over_delta": (-200, -50, -300),
    "all_equal": (-100, -100, -100),    # beta = gamma = delta
}
COST_KINDS = ("random", *CORNER_COSTS)
TABLE_KINDS = ("random", "ties", "int32_inside")

# the largest max_shift each family takes: the tile kernels (K1, K2, K4,
# K5, K8, K9-K12, the split) by ``cuda_dp._tile_consts``; the triplet's
# routes switch at TRIPLET_STATIC_SHIFTS ("resident" at or below, "cluster"
# above), and its kernel takes any max_shift: 16 reaches across
LIMITS = {"affine": 17, "nonaffine": 48, "ms0": 0, "triplet": 16}
TRIPLET_STATIC_SHIFTS = 8
# K3's route "resident" from this many rows (``cuda_dp.MS0_RESIDENT_ROWS``)
MS0_RESIDENT_ROWS = 1024

# ops/cases.check_int32_safe: the DP values must stay above INT32_MIN +
# 2^20 below NEG_INF = -2^30, i.e. the value bound below 2^30 - 2^20
_INT32_BOUND = (1 << 30) - (1 << 20)


@dataclass(frozen=True)
class Case:
    family: str
    seed: int
    n: int
    m: int
    max_shift: int
    costs: tuple            # (beta, gamma, delta)
    cost_kind: str
    table_kind: str

    def params(self, affine: bool) -> tuple:
        """The costs a kind of fill takes: (beta, gamma, delta) affine,
        (gamma, delta) non-affine and for the triplet."""
        return self.costs if affine else self.costs[1:]

    def tables(self) -> tuple:
        """The pair's int32 score tables ``[n+1, m+1]``, row and column 0
        zero, drawn from the seed."""
        rng = np.random.default_rng([self.seed, 7])
        return draw_tables(rng, self.n, self.m, self.table_kind, self.costs)

    def tag(self) -> str:
        return (f"{self.family}:{self.seed} n={self.n} m={self.m} "
                f"S={self.max_shift} {self.cost_kind}{self.costs} "
                f"{self.table_kind}")


def draw_costs(rng, kind: str) -> tuple:
    if kind != "random":
        return CORNER_COSTS[kind]
    beta, gamma, delta = (int(v) for v in rng.integers(
        COST_RANGE[0], COST_RANGE[1] + 1, 3))
    return (beta or -1, gamma, delta)      # beta != 0 keeps affine selected


def int32_certified_magnitude(n: int, m: int, costs) -> int:
    """The largest |table value| at which ``check_int32_safe`` still
    certifies a pair of lengths n, m at ``costs`` (gap opening included, so
    that it holds for the non-affine fill too)."""
    per_col = (_INT32_BOUND - 1) // (2 * (n + m + 2))
    return per_col // 2 - sum(abs(int(c)) for c in costs)


def draw_tables(rng, n: int, m: int, kind: str, costs=(0, 0, 0)) -> tuple:
    mu = np.zeros((2, n + 1, m + 1), np.int64)
    if kind == "ties":
        mu[:, 1:, 1:] = rng.choice(TIE_VALUES, size=(2, n, m))
    else:
        mu[:, 1:, 1:] = rng.integers(*TABLE_RANGE, size=(2, n, m))
    if kind == "int32_inside" and n and m:
        big = int32_certified_magnitude(n, m, costs)
        mu[rng.integers(2), rng.integers(1, n + 1), rng.integers(1, m + 1)] \
            = big * rng.choice([-1, 1])
    return mu[0].astype(np.int32), mu[1].astype(np.int32)


def int32_outside_tables(rng, n: int, m: int) -> tuple:
    """Tables whose one entry lies just beyond what ``check_int32_safe``
    certifies at any costs (n, m >= 1)."""
    mu1, mu2 = draw_tables(rng, n, m, "random")
    mu1[n, m] = int32_certified_magnitude(n, m, (0, 0, 0)) + 1
    return mu1, mu2


def _lengths(rng, max_len: int, rows) -> tuple:
    """(n, m) in [0, max_len], uneven."""
    pick = int(rng.integers(5))
    if pick == 0:                            # one sequence empty
        n = int(rng.integers(0, max_len + 1))
        return (n, 0) if rng.integers(2) else (0, n)
    if pick == 1 and rows is not None and rows + 1 <= max_len:
        # the widest live range at R - 1, R or R + 1 rows: min(n, m) + 1
        short = max(rows - 2 + int(rng.integers(3)), 0)
        long = int(rng.integers(short + 1, max_len + 1))
        return (short, long) if rng.integers(2) else (long, short)
    n, m = (int(v) for v in rng.integers(0, max_len + 1, 2))
    if n == m:
        m = m + 1 if m < max_len else m - 1
    return n, m


def draw(family: str, seed: int, *, max_len: int = 40, max_shift: int = 4,
         cells: int = 200_000, rows=None) -> Case:
    """One case of ``family`` ("affine", "nonaffine", "ms0", "triplet")
    from ``seed``; ``rows``: a callable max_shift -> the tile's R (the
    shape then sits at its edge one seed in five)."""
    rng = np.random.default_rng([seed, sum(map(ord, family))])
    S = int(rng.integers(0, min(max_shift, LIMITS[family]) + 1))
    W2 = (2 * S + 1) ** 2 * (9 if family == "affine" else 1)
    # (n+1)(m+1) W2 <= cells, and never below a 4 x 4 pair
    cap = max(4, min(max_len, int((cells / W2) ** 0.5) - 1))
    n, m = _lengths(rng, cap, rows(S) if rows else None)
    cost_kind = COST_KINDS[seed % len(COST_KINDS)]
    costs = draw_costs(rng, cost_kind)
    return Case(family, seed, n, m, S, costs, cost_kind,
                TABLE_KINDS[seed % len(TABLE_KINDS)])


def at_limit(family: str, seed: int, *, max_len: int = 6,
             max_shift=None) -> Case:
    """A case of n, m in [2, max_len], uneven, at ``max_shift`` (default the
    family's largest: the run-time-S form of the tile kernels at 17 affine
    and 48 non-affine, the triplet beyond its route boundary)."""
    case = draw(family, seed, max_len=max_len, max_shift=0)
    rng = np.random.default_rng([seed, 11])
    n = int(rng.integers(2, max_len + 1))
    m = int(rng.choice([v for v in range(2, max_len + 1) if v != n]))
    S = LIMITS[family] if max_shift is None else max_shift
    return Case(family, seed, n, m, S, case.costs, case.cost_kind,
                case.table_kind)


def uneven_rows(rng, n: int, K: int) -> list:
    """K contiguous row ranges [(a, b), ...] covering 0..n, of uneven
    lengths (at least one row each; K <= n + 1)."""
    cuts = np.sort(rng.choice(np.arange(1, n + 1), size=K - 1, replace=False))
    edges = [0, *map(int, cuts), n + 1]
    return [(edges[k], edges[k + 1] - 1) for k in range(K)]


def mixed_bucket(rng, N: int, M: int, B: int) -> list:
    """(n, m) of B pairs of one (N, M) bucket: an empty first sequence, an
    empty second, the bucket's own size, then lengths at random."""
    fixed = [(0, M), (N, 0), (N, M)]
    rest = [(int(rng.integers(0, N + 1)), int(rng.integers(0, M + 1)))
            for _ in range(max(B - len(fixed), 0))]
    return (fixed + rest)[:B]
