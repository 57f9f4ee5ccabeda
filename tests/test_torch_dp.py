"""Plain twins of the port's band fills against the JAX package: the
Pallas kernels (interpret mode on the CPU, as tests/test_pallas.py runs
them), the XLA scan and the numpy oracle.  Exact equality on every genuine
cell and on the final score; all values are int32 DP scores."""

import numpy as np
import pytest
import torch

from bialign_tpu.ops import pallas_dp, reference_dp, xla_dp
from test_pallas import CASES, NA_CASES, _genuine_mask, _rand_pair

from bialign_tpu_torch.convert import band_from_jax, tables_to_torch
from bialign_tpu_torch.ops import cuda_dp


def _tables(mu1, mu2):
    return tables_to_torch(mu1, mu2, "cpu")


def _assert_genuine_equal(got, want, n, m, S, affine):
    ok = _genuine_mask(n, m, S)
    if affine:
        ok = ok[None]
    assert got.shape == want.shape
    assert np.where(ok, got == want, True).all(), (
        f"mismatch at {np.argwhere(ok & (got != want))[:5]}"
    )


def _assert_off_live_rows_invalid(band):
    """Rows off a diagonal's live range hold INVALID (the kernels' contract:
    they are never written)."""
    ys = band.ys.numpy()
    d = np.arange(ys.shape[0])[:, None]
    i = np.arange(band.n + 1)[None, :]
    dead = (d - i < 0) | (d - i > band.m)              # [D, P]
    rows = np.moveaxis(ys, -1, 1)                       # [D, P, ...]
    assert (rows[dead] == cuda_dp.INVALID).all()


@pytest.mark.parametrize("n,m,S,beta,gamma,delta", CASES)
def test_affine_plain_matches_pallas_and_oracle(n, m, S, beta, gamma, delta):
    rng = np.random.default_rng(n * 37 + m * 5 + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
    jband = pallas_dp.fill_affine_device(mu1, mu2, S, beta, gamma, delta)
    band = cuda_dp.fill_affine_plain(*_tables(mu1, mu2), S, beta, gamma,
                                     delta)
    got = band.to_numpy()
    _assert_genuine_equal(got, H, n, m, S, affine=True)
    _assert_genuine_equal(got, jband.to_numpy(), n, m, S, affine=True)
    _assert_off_live_rows_invalid(band)
    want = reference_dp.affine_score_from_band(H, n, m, S)
    assert band.final_score() == jband.final_score() == want


@pytest.mark.parametrize("n,m,S,gamma,delta", NA_CASES)
def test_nonaffine_plain_matches_pallas_and_oracle(n, m, S, gamma, delta):
    rng = np.random.default_rng(n * 31 + m * 7 + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    H = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
    jband = pallas_dp.fill_nonaffine_device(mu1, mu2, S, gamma, delta)
    band = cuda_dp.fill_nonaffine_plain(*_tables(mu1, mu2), S, gamma, delta)
    got = band.to_numpy()
    _assert_genuine_equal(got, H, n, m, S, affine=False)
    _assert_genuine_equal(got, jband.to_numpy(), n, m, S, affine=False)
    _assert_off_live_rows_invalid(band)
    want = reference_dp.nonaffine_score_from_band(H, n, m, S)
    assert band.final_score() == jband.final_score() == want


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n,m,S", [(9, 12, 1), (11, 6, 3)])
def test_plain_matches_xla_band_in_port_layout(affine, n, m, S):
    """The XLA engine's band, carried into the port's layout by
    convert.band_from_jax, equals the plain twin's on every live cell."""
    rng = np.random.default_rng(100 * n + m + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    t1, t2 = _tables(mu1, mu2)
    if affine:
        jband = xla_dp.fill_affine_device(mu1, mu2, S, -150, -50, -120)
        band = cuda_dp.fill_affine_plain(t1, t2, S, -150, -50, -120)
    else:
        jband = xla_dp.fill_nonaffine_device(mu1, mu2, S, -200, -250)
        band = cuda_dp.fill_nonaffine_plain(t1, t2, S, -200, -250)
    carried = band_from_jax(np.asarray(jband.ys), n, m, S, affine=affine,
                            p_last=False)
    assert carried.ys.shape == band.ys.shape
    _assert_genuine_equal(band.to_numpy(), carried.to_numpy(), n, m, S,
                          affine)
    assert carried.final_score() == band.final_score() == jband.final_score()


def test_wrappers_run_the_plain_twin_for_cpu_tables():
    rng = np.random.default_rng(3)
    t1, t2 = _tables(*_rand_pair(rng, 6, 5))
    before = dict(cuda_dp.LAUNCHES)
    got = cuda_dp.fill_affine_device(t1, t2, 1, -150, -50, -150)
    want = cuda_dp.fill_affine_plain(t1, t2, 1, -150, -50, -150)
    assert torch.equal(got.ys, want.ys)
    got = cuda_dp.fill_nonaffine_device(t1, t2, 2, -200, -250)
    want = cuda_dp.fill_nonaffine_plain(t1, t2, 2, -200, -250)
    assert torch.equal(got.ys, want.ys)
    assert cuda_dp.LAUNCHES == before       # no kernel was launched


def test_wrappers_reject_bad_tables():
    t1, t2 = _tables(*_rand_pair(np.random.default_rng(4), 4, 4))
    with pytest.raises(ValueError, match="int32"):
        cuda_dp.fill_affine_device(t1.long(), t2, 1, -150, -50, -150)
    with pytest.raises(ValueError, match="differ"):
        cuda_dp.fill_nonaffine_device(t1, t2[:, :3].contiguous(), 1, -200,
                                      -250)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_dp.fill_nonaffine_device(t1.t(), t2.t(), 1, -200, -250)
    with pytest.raises(TypeError):
        cuda_dp.fill_affine_device(t1.numpy(), t2, 1, -150, -50, -150)
