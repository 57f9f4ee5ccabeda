"""Tables and costs that fail the int32 check: the port's BiAligner warns
and runs the int64 engine (the plain recurrence at int64, the host walk),
as the JAX package's runs its int64 XLA fill (bialign_tpu/aligner.py:
156-183); score and decoded lines equal to JAX ``engine="xla"``'s."""

import functools
import warnings

import numpy as np
import pytest
import torch

import golden as G
from bialign_tpu import BiAligner as JaxAligner
from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.ops import cuda_dp

# tests/test_engines.py:95-117: path sums beyond 2^31
PROTEIN = dict(seqA="ACDEFGHIKL", seqB="ACDEFGAIKL", strA="HHHHHEEEEE",
               strB="HHHHEEEEEC")
PROTEIN_PARAMS = dict(type="Protein", structure_weight=500_000_000,
                      simmatrix="BLOSUM62", gap_opening_cost=-150,
                      gap_cost=-50, shift_cost=-150, max_shift=1)


@functools.lru_cache(maxsize=None)
def _jax(mol: tuple, params: tuple):
    """(score, decoded lines) of the JAX package's int64 XLA engine."""
    ba = JaxAligner(**dict(mol), engine="xla", **dict(params))
    with pytest.warns(RuntimeWarning, match="int64 XLA engine"):
        score = ba.optimize()
    return score, list(ba.decode_trace())


def _port(mol: dict, params: dict):
    ba = BiAligner(**mol, engine="torch", device="cpu", **params)
    with pytest.warns(RuntimeWarning, match="int64 engine"):
        score = ba.optimize()
    assert ba._band.ys.dtype == torch.int64     # a full band, also lowmem
    return score, list(ba.decode_trace())


@pytest.mark.parametrize("params", [
    dict(lowmem=True, gap_cost=-10 ** 8),
    dict(gap_cost=-10 ** 8),               # fails check_int32_safe
])
def test_int32_unsafe_costs_take_the_int64_engine(params):
    """The toy RNA pair with a gap cost whose paths leave the certified
    int32 range (these were refused until the int64 engine was ported)."""
    score, lines = _port(G.TOY_RNA, params)
    want = _jax(tuple(G.TOY_RNA.items()), tuple(params.items()))
    assert (score, lines) == want


@pytest.mark.parametrize("lowmem", [False, True])
@pytest.mark.parametrize("gap_opening_cost", [-150, 0],
                         ids=["affine", "nonaffine"])
def test_int32_overflow_uses_the_int64_engine(gap_opening_cost, lowmem):
    """tests/test_engines.py:95-117 through the port, affine and in its
    non-affine form: the score exceeds the int32 maximum and equals the
    JAX int64 engine's, and so do the decoded lines."""
    params = dict(PROTEIN_PARAMS, gap_opening_cost=gap_opening_cost)
    score, lines = _port(PROTEIN, dict(params, lowmem=lowmem))
    assert score > np.iinfo(np.int32).max
    assert (score, lines) == _jax(tuple(PROTEIN.items()),
                                  tuple(params.items()))


def test_the_int64_fill_equals_the_int32_fill_where_both_run():
    """On tables the int32 check certifies, the int64 band holds the int32
    band's values, INVALID64 where the int32 band has INVALID."""
    rng = np.random.default_rng(3)
    mu1 = torch.from_numpy(rng.integers(-400, 800, (8, 7)).astype(np.int32))
    mu2 = torch.from_numpy(rng.integers(-400, 800, (8, 7)).astype(np.int32))
    for fill, costs in ((cuda_dp.fill_affine_plain, (-150, -50, -150)),
                        (cuda_dp.fill_nonaffine_plain, (-200, -250))):
        b32 = fill(mu1, mu2, 2, *costs)
        b64 = fill(mu1.long(), mu2.long(), 2, *costs, dtype=torch.int64)
        want = torch.where(b32.ys == cuda_dp.INVALID, cuda_dp.INVALID64,
                           b32.ys.long())
        assert b64.ys.dtype == torch.int64 and torch.equal(b64.ys, want)


def test_score_entry_points_keep_refusing():
    """The band-free score entry points run int32 only (as the JAX batch
    path refuses such tables); BiAligner is where the int64 engine runs."""
    mu = torch.zeros((3, 3), dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(NotImplementedError, match="int64 engine is"):
            cuda_dp.affine_score(mu, mu, 1, -150, -10 ** 9, -150)
