"""The port's walk (its plain twin, the host walk over the port's band)
against the JAX package's device walks, and the JAX band carried into the
port by convert.band_from_jax and walked there.  Traces are compared
exactly, column for column."""

import numpy as np
import pytest

from bialign_tpu.ops import device_traceback as jdtb
from bialign_tpu.ops import pallas_dp, xla_dp
from test_pallas import CASES, NA_CASES, _rand_pair

from bialign_tpu_torch.convert import band_from_jax, tables_to_torch
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb


def _cols(trace):
    return [tuple(int(v) for v in c) for c in trace]


@pytest.mark.parametrize("n,m,S,beta,gamma,delta",
                         CASES[:3] + [(8, 10, 3, -150, -50, -150)])
def test_affine_walk_matches_jax_device_walk(n, m, S, beta, gamma, delta):
    rng = np.random.default_rng(n + m + S)
    mu1, mu2 = _rand_pair(rng, n, m)
    jband = pallas_dp.fill_affine_device(mu1, mu2, S, beta, gamma, delta)
    want, want_complete = jdtb.affine_traceback(jband, beta, gamma, delta,
                                                mu1, mu2)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    band = cuda_dp.fill_affine_plain(t1, t2, S, beta, gamma, delta)
    got, complete = dtb.affine_traceback_plain(band, beta, gamma, delta, t1, t2)
    assert _cols(got) == _cols(want)
    assert complete == want_complete

    carried = band_from_jax(np.asarray(jband.ys), n, m, S, affine=True,
                            p_last=True)
    got, complete = dtb.affine_traceback_plain(carried, beta, gamma, delta, t1, t2)
    assert _cols(got) == _cols(want)
    assert complete == want_complete


@pytest.mark.parametrize("n,m,S,gamma,delta", NA_CASES[:3])
def test_nonaffine_walk_matches_jax_device_walk(n, m, S, gamma, delta):
    rng = np.random.default_rng(n + m + S + 1)
    mu1, mu2 = _rand_pair(rng, n, m)
    jband = pallas_dp.fill_nonaffine_device(mu1, mu2, S, gamma, delta)
    want = jdtb.nonaffine_traceback(jband, gamma, delta, mu1, mu2)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    band = cuda_dp.fill_nonaffine_plain(t1, t2, S, gamma, delta)
    assert _cols(dtb.nonaffine_traceback_plain(band, gamma, delta, t1, t2)) \
        == _cols(want)

    carried = band_from_jax(np.asarray(jband.ys), n, m, S, affine=False,
                            p_last=True)
    assert _cols(dtb.nonaffine_traceback_plain(carried, gamma, delta, t1, t2)) \
        == _cols(want)


@pytest.mark.parametrize("affine", [True, False])
def test_xla_band_carried_and_walked(affine):
    rng = np.random.default_rng(21)
    n, m, S = 10, 8, 2
    mu1, mu2 = _rand_pair(rng, n, m)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    if affine:
        jband = xla_dp.fill_affine_device(mu1, mu2, S, -100, -200, -250)
        want, _ = jdtb.affine_traceback(jband, -100, -200, -250, mu1, mu2)
        carried = band_from_jax(np.asarray(jband.ys), n, m, S, True, False)
        got, _ = dtb.affine_traceback_plain(carried, -100, -200, -250, t1, t2)
    else:
        jband = xla_dp.fill_nonaffine_device(mu1, mu2, S, -200, -250)
        want = jdtb.nonaffine_traceback(jband, -200, -250, mu1, mu2)
        carried = band_from_jax(np.asarray(jband.ys), n, m, S, False, False)
        got = dtb.nonaffine_traceback_plain(carried, -200, -250, t1, t2)
    assert _cols(got) == _cols(want)


@pytest.mark.parametrize("beta,gamma,delta", [(-150, -50, -150),
                                              (-200, -50, -210)])
def test_kernel_case_tables_match_the_jax_walk(beta, gamma, delta):
    """The packed cases the CUDA fill and walk read are the JAX walk's."""
    src, col, mults = jdtb._affine_static_tables()
    tab = cuda_dp.affine_case_table(beta, gamma, delta)
    assert (tab[..., cuda_dp.SRC] == src).all()
    assert (tab[..., cuda_dp.X0:cuda_dp.X3 + 1] == col).all()
    assert (tab[..., cuda_dp.MU1C] == mults[..., 0]).all()
    assert (tab[..., cuda_dp.MU2C] == mults[..., 1]).all()
    assert (tab[..., cuda_dp.CST]
            == jdtb._affine_const(beta, gamma, delta)).all()


def test_walk_wrappers_run_the_host_walk_for_cpu_bands():
    """A walk wrapper given a band on the CPU runs its plain twin and
    launches no kernel."""
    rng = np.random.default_rng(5)
    t1, t2 = tables_to_torch(*_rand_pair(rng, 7, 6), "cpu")
    before = dict(dtb.LAUNCHES)
    band = cuda_dp.fill_affine_plain(t1, t2, 1, -150, -50, -150)
    assert dtb.affine_traceback(band, -150, -50, -150, t1, t2) \
        == dtb.affine_traceback_plain(band, -150, -50, -150, t1, t2)
    band = cuda_dp.fill_nonaffine_plain(t1, t2, 2, -200, -250)
    assert dtb.nonaffine_traceback(band, -200, -250, t1, t2) \
        == dtb.nonaffine_traceback_plain(band, -200, -250, t1, t2)
    assert dtb.LAUNCHES == before


def test_decode_codes_reverses_and_unpacks():
    assert dtb.decode_codes([15, 8, 1]) == [(0, 0, 0, 1), (1, 0, 0, 0),
                                            (1, 1, 1, 1)]
