"""The constants the tile kernels carry, held to the JAX package's cases.

The tile kernels of K1, K2 and K9-K12 (``bialign_tpu_torch/csrc/
tile_diag.cuh``) compile in the recurrence's states, half-column sources,
multiplicities and non-affine columns (``csrc/recurrence.cuh``) and take
only the constant term of each case by value, packed by
``cuda_dp.affine_kernel_consts`` / ``nonaffine_kernel_consts``.  The
kernels themselves run only on the card (``chip_smoke.py`` holds them to
their plain twins there); what the CPU can check is that the constants in
their source and in their argument are the reference's.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from bialign_tpu.ops import cases as J
from bialign_tpu_torch.ops import cuda_dp

CSRC = Path(__file__).resolve().parents[1] / "bialign_tpu_torch" / "csrc"

# the cost sets of tests/test_engines.py:126-127 (beta, gamma, delta); the
# last is the CLI defaults (gap_opening_cost 0, gap_cost -200, shift_cost
# -250)
COSTS = [(-150, -50, -150), (-200, -50, -210), (-7, -13, -29),
         (100, 50, 75), (0, -200, -250)]


def _tables(path: Path) -> dict:
    """Every ``constexpr int name[N][K] = {...};`` of a source, as arrays."""
    text = path.read_text()
    out = {}
    for name, n, k, body in re.findall(
            r"constexpr int (\w+)\[(\d+)\]\[(\d+)\] = \{(.*?)\};", text, re.S):
        vals = [int(v) for v in re.findall(r"-?\d+", body)]
        out[name] = np.array(vals, dtype=np.int64).reshape(int(n), int(k))
    return out


def _scalar(path: Path, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (-?\d+);", path.read_text())
    assert m, f"{name} not found in {path.name}"
    return int(m.group(1))


REC = _tables(CSRC / "recurrence.cuh")


def _affine_cases(q):
    """(src, col, mu1c, mu2c, group) of target q in reference order."""
    return [(c[0], tuple(c[1]), c[2], c[3], c[7])
            for c in J.iter_affine_cases(q)]


def test_states_are_the_reference_states():
    assert [tuple(r) for r in REC["kStateCol"]] == list(J.STATES)
    assert _scalar(CSRC / "recurrence.cuh", "kStateBoth") == \
        J.STATE_BOTH_MATCH


@pytest.mark.parametrize("group,table", [("B", "kBSrc"), ("C", "kCSrc")])
def test_half_column_sources(group, table):
    """Each target's group B (C) sources, in case order, and the column
    the kernel assumes for them: (0, 0, c, e) for B, (a, b, 0, 0) for C."""
    for q, (a, b, c, e) in enumerate(J.STATES):
        got = [x for x in _affine_cases(q) if x[4] == group]
        assert [x[0] for x in got] == REC[table][q].tolist(), q
        col = (0, 0, c, e) if group == "B" else (a, b, 0, 0)
        assert all(x[1] == col for x in got), q


def test_group_a_is_the_target_column_from_every_state():
    for q, state in enumerate(J.STATES):
        got = [x for x in _affine_cases(q) if x[4] == "A"]
        assert [x[0] for x in got] == list(range(J.N_STATES))
        assert all(x[1] == state for x in got)


def test_affine_multiplicities():
    """kAffineMu[q] = (A mu1, A mu2, B mu2, C mu1); B's mu1 and C's mu2 are
    0, and each group's multiplicities do not depend on the source."""
    for q in range(J.N_STATES):
        by = {g: {(x[2], x[3]) for x in _affine_cases(q) if x[4] == g}
              for g in "ABC"}
        assert all(len(v) == 1 for v in by.values()), (q, by)
        (a1, a2), (b1, b2), (c1, c2) = (next(iter(by[g])) for g in "ABC")
        assert (b1, c2) == (0, 0)
        assert REC["kAffineMu"][q].tolist() == [a1, a2, b2, c1], q


def test_nonaffine_columns_and_multiplicities():
    assert [tuple(r) for r in REC["kNonaffineCol"]] == list(J.NONAFFINE_COLS)
    want = [J.nonaffine_case_multiplicities(c)[:2] for c in J.NONAFFINE_COLS]
    assert [tuple(r) for r in REC["kNonaffineMu"]] == want


def test_case_order_constants_of_the_kernels():
    """The kernels index a target's constants as 9 group A, then group B
    from FIRST_B, group C from FIRST_C (csrc/common.cuh), as the reference
    enumerates them."""
    common = CSRC / "common.cuh"
    assert _scalar(common, "N_STATES") == J.N_STATES
    assert _scalar(common, "N_AFFINE_CASES") == len(_affine_cases(0)) == 15
    assert _scalar(common, "N_NONAFFINE_CASES") == J.N_NONAFFINE_CASES
    groups = "".join(x[4] for x in _affine_cases(0))
    assert groups.index("B") == _scalar(common, "FIRST_B")
    assert groups.index("C") == _scalar(common, "FIRST_C")


@pytest.mark.parametrize("beta,gamma,delta", COSTS)
def test_affine_kernel_consts(beta, gamma, delta):
    got = cuda_dp.affine_kernel_consts(beta, gamma, delta)
    tabs = J.AffineTables(beta, gamma, delta)
    assert got.dtype == np.int32 and got.shape == (9, 15)
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got[:, :9], tabs.a_const)
    np.testing.assert_array_equal(got[:, 9:12], tabs.b_const)
    np.testing.assert_array_equal(got[:, 12:], tabs.c_const)
    np.testing.assert_array_equal(tabs.b_src, REC["kBSrc"])
    np.testing.assert_array_equal(tabs.c_src, REC["kCSrc"])


@pytest.mark.parametrize("gamma,delta", sorted({c[1:] for c in COSTS}))
def test_nonaffine_kernel_consts(gamma, delta):
    got = cuda_dp.nonaffine_kernel_consts(gamma, delta)
    assert got.dtype == np.int32 and got.shape == (13,)
    np.testing.assert_array_equal(got, J.NonAffineTables(gamma, delta).const)


@pytest.mark.parametrize("struct,kind", [("AffineTile", 0),
                                         ("NonaffineTile", 1)])
def test_tile_rows_match_the_kernel(struct, kind):
    """cuda_dp.TILE_ROWS (the shared-memory check) is the kernel's own
    ``rows(kS)``: R at max_shift 0-3, 1 above."""
    text = (CSRC / "tile_diag.cuh").read_text()
    body = text[text.index(f"struct {struct}"):]
    m = re.search(r"static constexpr int rows\(int kS\) \{\s*return (.*?);",
                  body, re.S)
    pairs = re.findall(r"kS == (\d) \? (\d+)", m.group(1))
    assert [int(s) for s, _r in pairs] == [0, 1, 2, 3]
    assert tuple(int(r) for _s, r in pairs) == cuda_dp.TILE_ROWS[kind]
    assert m.group(1).rstrip().endswith(": 1")
