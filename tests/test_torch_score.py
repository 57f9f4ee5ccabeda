"""The port's band-free scores (plain twins on the CPU) against the JAX
package: the Pallas score-only kernels K1, K2 and K3 in interpret mode, as
tests/test_pallas.py runs them, and the numpy oracle.  Scores and the
last diagonal's slab are int32 DP values, compared for equality."""

import numpy as np
import pytest
import torch

from bialign_tpu.ops import pallas_dp, reference_dp
from test_pallas import CASES, NA_CASES, _rand_pair

from bialign_tpu_torch.convert import slab_from_jax, tables_to_torch
from bialign_tpu_torch.ops import cuda_dp

# (n, m, S): the band tests' shapes, S up to 3, and n or m 0
SHAPES = ([c[:3] for c in CASES]
          + [(9, 11, 1), (8, 10, 3), (4, 6, 3), (0, 5, 1), (6, 0, 2),
             (0, 0, 1), (3, 0, 0)])
MS0_SHAPES = [(7, 9), (1, 1), (0, 3), (5, 0), (20, 13)]  # test_pallas.py:191
AFFINE_PARAMS = [(-150, -50, -150), (-200, -50, -210)]


def _tables(mu1, mu2):
    return tables_to_torch(mu1, mu2, "cpu")


def _pair(n, m, S):
    return _rand_pair(np.random.default_rng(n * 41 + m * 3 + S), n, m)


def _garbage(rng, shape):
    """A ring holding arbitrary int32 values, the extremes included."""
    ring = rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)
    ring.flat[::7] = np.iinfo(np.int32).max
    ring.flat[3::11] = np.iinfo(np.int32).min
    return torch.from_numpy(ring)


def _jax_last_slab(mu1, mu2, S, params, affine):
    """The JAX package's score-only kernel output (interpret mode)."""
    p1, p2, d_last, D_pad, _n, _m = pallas_dp._prep_single(
        mu1, mu2, S, True, True, affine)
    dense = (pallas_dp._affine_pallas_dense if affine
             else pallas_dp._nonaffine_pallas_dense)
    return np.asarray(dense(p1, p2, d_last, D_pad, S, params, True, True))


@pytest.mark.parametrize("n,m,S", SHAPES)
def test_affine_score_plain_matches_pallas_and_oracle(n, m, S):
    mu1, mu2 = _pair(n, m, S)
    t1, t2 = _tables(mu1, mu2)
    # one Pallas compile per cost set: two sets on the narrow bands only
    for beta, gamma, delta in AFFINE_PARAMS[:2 if S <= 1 else 1]:
        H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
        want = reference_dp.affine_score_from_band(H, n, m, S)
        got = cuda_dp.affine_score_plain(t1, t2, S, beta, gamma, delta)
        assert got == want
        assert got == pallas_dp.affine_score(mu1, mu2, S, beta, gamma, delta,
                                             interpret=True)
        band = cuda_dp.fill_affine_plain(t1, t2, S, beta, gamma, delta)
        assert got == band.final_score()


@pytest.mark.parametrize("n,m,S", SHAPES)
def test_nonaffine_score_plain_matches_pallas_and_oracle(n, m, S):
    mu1, mu2 = _pair(n, m, S)
    t1, t2 = _tables(mu1, mu2)
    for gamma, delta in [(-200, -250), (-50, -100)][:2 if S <= 1 else 1]:
        H = reference_dp.fill_nonaffine(mu1, mu2, S, gamma, delta)
        want = reference_dp.nonaffine_score_from_band(H, n, m, S)
        got = cuda_dp.nonaffine_score_plain(t1, t2, S, gamma, delta)
        assert got == want
        assert got == pallas_dp.nonaffine_score(mu1, mu2, S, gamma, delta,
                                                interpret=True)
        band = cuda_dp.fill_nonaffine_plain(t1, t2, S, gamma, delta)
        assert got == band.final_score()


@pytest.mark.parametrize("n,m,S,beta,gamma,delta",
                         [c for c in CASES if c[2] > 0]
                         + [(8, 10, 3, -150, -50, -150)])
def test_affine_last_slab_equals_the_jax_slab(n, m, S, beta, gamma, delta):
    """The whole slab of the last diagonal's live row (row n), every state
    and shift position, against K1 score-only carried over by
    convert.slab_from_jax; and the band's last diagonal."""
    mu1, mu2 = _pair(n, m, S)
    t1, t2 = _tables(mu1, mu2)
    want = slab_from_jax(
        _jax_last_slab(mu1, mu2, S, (beta, gamma, delta), True), n, S, True)
    got = cuda_dp.affine_last_slab_plain(t1, t2, S, beta, gamma, delta)
    assert got.shape == want.shape == (9, 2 * S + 1, 2 * S + 1, n + 1)
    assert torch.equal(got[..., n], want[..., n])
    band = cuda_dp.fill_affine_plain(t1, t2, S, beta, gamma, delta)
    assert torch.equal(got[..., n], band.ys[n + m, ..., n])


@pytest.mark.parametrize("n,m,S,gamma,delta",
                         NA_CASES + [(8, 10, 3, -200, -250)])
def test_nonaffine_last_slab_equals_the_jax_slab(n, m, S, gamma, delta):
    mu1, mu2 = _pair(n, m, S)
    t1, t2 = _tables(mu1, mu2)
    want = slab_from_jax(
        _jax_last_slab(mu1, mu2, S, (gamma, delta), False), n, S, False)
    got = cuda_dp.nonaffine_last_slab_plain(t1, t2, S, gamma, delta)
    assert got.shape == want.shape == (2 * S + 1, 2 * S + 1, n + 1)
    assert torch.equal(got[..., n], want[..., n])
    band = cuda_dp.fill_nonaffine_plain(t1, t2, S, gamma, delta)
    assert torch.equal(got[..., n], band.ys[n + m, ..., n])


def test_slab_from_jax_rejects_other_shapes():
    with pytest.raises(ValueError, match="JAX slab"):
        slab_from_jax(np.zeros((1, 9, 3, 3, 128)), 5, 2, True)
    with pytest.raises(ValueError, match="JAX slab"):
        slab_from_jax(np.zeros((1, 3, 3, 128)), 200, 1, False)


@pytest.mark.parametrize("n,m", MS0_SHAPES)
def test_ms0_score_plain_matches_pallas_k1_and_oracle(n, m):
    """K3's twin equals the JAX K3 (pallas_dp.affine_score at max_shift 0),
    K1's twin at max_shift 0 and the oracle, in the score; and its three
    live states equal K1's at the last cell."""
    rng = np.random.default_rng(n * 13 + m)
    mu1, mu2 = _rand_pair(rng, n, m)
    t1, t2 = _tables(mu1, mu2)
    live, _const, _m1, _m2 = cuda_dp.ms0_live_tables(-150, -50, -150)
    for beta, gamma, delta in AFFINE_PARAMS:
        H = reference_dp.fill_affine(mu1, mu2, 0, beta, gamma, delta)
        want = reference_dp.affine_score_from_band(H, n, m, 0)
        got = cuda_dp.affine_ms0_score_plain(t1, t2, beta, gamma, delta)
        assert got == want
        assert got == pallas_dp.affine_score(mu1, mu2, 0, beta, gamma, delta)
        assert got == cuda_dp.affine_score_plain(t1, t2, 0, beta, gamma, delta)
        k3 = cuda_dp.affine_ms0_last_slab_plain(t1, t2, beta, gamma, delta)
        k1 = cuda_dp.affine_last_slab_plain(t1, t2, 0, beta, gamma, delta)
        assert torch.equal(k3[:, n], k1[live, 0, 0, n])


def test_ms0_live_tables_equal_the_jax_package():
    for params in AFFINE_PARAMS:
        live, const, mu1c, mu2c = cuda_dp.ms0_live_tables(*params)
        jlive, jconst, jmu1c, jmu2c = pallas_dp._ms0_live_tables(params)
        assert live == jlive and (mu1c, mu2c) == (jmu1c, jmu2c)
        assert np.array_equal(const, jconst) and const.dtype == jconst.dtype
        # what the kernels take by value, and what they compile in: the
        # live states are STATES 4t, their constants group A's between them
        packed = cuda_dp.ms0_kernel_consts(*params)
        assert packed.shape == (3, 3) and packed.dtype == torch.int32
        assert np.array_equal(packed.numpy(), const)
        assert live == [0, 4, 8]
        affine = cuda_dp.affine_kernel_consts(*params)
        assert np.array_equal(affine[np.ix_(live, live)], const)


@pytest.mark.parametrize("n,m,S", SHAPES)
def test_a_ring_prefilled_with_garbage_gives_the_same_slab(n, m, S):
    """The kernels write only a diagonal's live rows, so the other rows of
    a ring slab hold diagonal d-3 or whatever the memory held.  The guards
    must keep every read off them: arbitrary ring contents change nothing
    in the last diagonal's live row."""
    rng = np.random.default_rng(1000 + n * 41 + m * 3 + S)
    mu1, mu2 = _pair(n, m, S)
    t1, t2 = _tables(mu1, mu2)
    W = 2 * S + 1
    H = reference_dp.fill_affine(mu1, mu2, S, -150, -50, -150)
    ring = _garbage(rng, (3, 9, W, W, n + 1))
    dirty = cuda_dp.affine_last_slab_plain(t1, t2, S, -150, -50, -150,
                                           ring=ring)
    clean = cuda_dp.affine_last_slab_plain(t1, t2, S, -150, -50, -150)
    assert torch.equal(dirty[..., n], clean[..., n])
    assert (int(dirty[:, S, S, n].max())
            == reference_dp.affine_score_from_band(H, n, m, S))
    assert dirty.data_ptr() == ring[(n + m) % 3].data_ptr()   # in place

    H = reference_dp.fill_nonaffine(mu1, mu2, S, -200, -250)
    ring = _garbage(rng, (3, W, W, n + 1))
    dirty = cuda_dp.nonaffine_last_slab_plain(t1, t2, S, -200, -250,
                                              ring=ring)
    clean = cuda_dp.nonaffine_last_slab_plain(t1, t2, S, -200, -250)
    assert torch.equal(dirty[..., n], clean[..., n])
    assert (int(dirty[S, S, n])
            == reference_dp.nonaffine_score_from_band(H, n, m, S))


@pytest.mark.parametrize("n,m", MS0_SHAPES)
def test_ms0_ring_prefilled_with_garbage(n, m):
    rng = np.random.default_rng(2000 + n * 13 + m)
    mu1, mu2 = _rand_pair(rng, n, m)
    t1, t2 = _tables(mu1, mu2)
    ring = _garbage(rng, (3, 3, n + 1))
    dirty = cuda_dp.affine_ms0_last_slab_plain(t1, t2, -150, -50, -150,
                                               ring=ring)
    clean = cuda_dp.affine_ms0_last_slab_plain(t1, t2, -150, -50, -150)
    assert torch.equal(dirty[:, n], clean[:, n])
    H = reference_dp.fill_affine(mu1, mu2, 0, -150, -50, -150)
    assert (int(dirty[:, n].max())
            == reference_dp.affine_score_from_band(H, n, m, 0))


def test_stale_rows_stay_in_the_ring():
    """The twin models the kernel's ring: rows off a diagonal's live range
    are not written.  On the last diagonal only row n is live, so the rest
    of that slab still holds what the ring was given or an older diagonal."""
    n, m, S = 6, 4, 1
    t1, t2 = _tables(*_pair(n, m, S))
    ring = torch.full((3, 3, 3, n + 1), 7, dtype=torch.int32)
    last = cuda_dp.nonaffine_last_slab_plain(t1, t2, S, -200, -250, ring=ring)
    band = cuda_dp.fill_nonaffine_plain(t1, t2, S, -200, -250)
    d = n + m
    assert torch.equal(last[..., n], band.ys[d, ..., n])
    # rows 4 and 5 were last live on diagonal d-3 (j = m), rows < 3 never
    # on a diagonal of this residue class after d = 3
    assert torch.equal(last[..., 3:n], band.ys[d - 3, ..., 3:n])
    assert (band.ys[d, ..., :n] == cuda_dp.INVALID).all()


@pytest.mark.parametrize("n,m,S", [(9, 11, 1), (7, 9, 0), (6, 5, 2)])
def test_score_entry_points_take_the_plain_path_for_cpu_tables(n, m, S):
    t1, t2 = _tables(*_pair(n, m, S))
    before = dict(cuda_dp.LAUNCHES)
    assert (cuda_dp.affine_score(t1, t2, S, -150, -50, -150)
            == cuda_dp.affine_score_plain(t1, t2, S, -150, -50, -150))
    assert (cuda_dp.nonaffine_score(t1, t2, S, -200, -250)
            == cuda_dp.nonaffine_score_plain(t1, t2, S, -200, -250))
    assert torch.equal(
        cuda_dp.affine_last_slab(t1, t2, S, -150, -50, -150),
        cuda_dp.affine_last_slab_plain(t1, t2, S, -150, -50, -150))
    assert torch.equal(
        cuda_dp.nonaffine_last_slab(t1, t2, S, -200, -250),
        cuda_dp.nonaffine_last_slab_plain(t1, t2, S, -200, -250))
    assert torch.equal(
        cuda_dp.affine_ms0_last_slab(t1, t2, -150, -50, -150),
        cuda_dp.affine_ms0_last_slab_plain(t1, t2, -150, -50, -150))
    assert cuda_dp.LAUNCHES == before       # no kernel was launched


def test_affine_score_at_max_shift_0_goes_through_k3(monkeypatch):
    t1, t2 = _tables(*_pair(7, 9, 0))
    want = cuda_dp.affine_score_plain(t1, t2, 0, -150, -50, -150)
    called = []
    real = cuda_dp.affine_ms0_last_slab

    def spy(*args, **kw):
        called.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(cuda_dp, "affine_ms0_last_slab", spy)
    monkeypatch.setattr(cuda_dp, "affine_last_slab", None)   # must not run
    assert cuda_dp.affine_score(t1, t2, 0, -150, -50, -150) == want
    assert len(called) == 1


# K3's route by the pair's rows: one CTA below MS0_RESIDENT_ROWS (1024),
# one cooperative grid from there, where it measured faster; one CTA holds
# a pair while four rows a thread of 1024 do (n <= 4095; the ring, 36 bytes
# a row, fits shared memory up to there), so "cta" may be forced up to there
@pytest.mark.parametrize("n,route", [
    (0, "cta"), (928, "cta"), (1022, "cta"), (1023, "resident"),
    (4000, "resident"), (4095, "resident"), (4096, "resident"),
    (13000, "resident")])
def test_k3_route_follows_one_ctas_capacity(n, route):
    assert cuda_dp.cta_shared_bytes(n, 0, True) == 36 * (n + 1)
    assert cuda_dp.cta_fits(n, 0, True) == (n <= 4095)
    assert cuda_dp.batch_route(n, 0, True, B=1) == route
    assert cuda_dp.batch_route(n, 0, True, "grid", B=1) == "grid"
    assert cuda_dp.batch_route(n, 0, True, "resident", B=1) == "resident"
    if n <= 4095:
        assert cuda_dp.batch_route(n, 0, True, "cta", B=1) == "cta"
    else:
        with pytest.raises(ValueError, match="one CTA"):
            cuda_dp.batch_route(n, 0, True, "cta", B=1)


def test_k3_forced_routes():
    """Each route forced on a pair that fits gives the twin's slab; a
    forced one-CTA route on a pair beyond one CTA raises before anything
    runs (it does not give way to another route), and the conveyor is no
    route of one pair."""
    t1, t2 = _tables(*_pair(7, 9, 0))
    want = cuda_dp.affine_ms0_last_slab_plain(t1, t2, -150, -50, -150)
    for route in ("cta", "resident", "grid", None):
        assert torch.equal(cuda_dp.affine_ms0_last_slab(
            t1, t2, -150, -50, -150, route=route), want)
    long = torch.zeros((4097, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CTA"):
        cuda_dp.affine_ms0_last_slab(long, long, -150, -50, -150,
                                     route="cta")
    with pytest.raises(ValueError, match="route"):
        cuda_dp.affine_ms0_last_slab(t1, t2, -150, -50, -150,
                                     route="conveyor")


def test_score_entry_points_refuse_unsafe_scores():
    """Tables or costs that fail check_int32_safe: the same refusal as
    BiAligner's, on either side of the limit."""
    t1, t2 = _tables(*_pair(6, 6, 1))
    with pytest.raises(NotImplementedError, match="P2"):
        cuda_dp.affine_score(t1, t2, 1, -150, -10 ** 8, -150)
    with pytest.raises(NotImplementedError, match="P2"):
        cuda_dp.affine_score(t1, t2, 0, -10 ** 8, -50, -150)
    with pytest.raises(NotImplementedError, match="P2"):
        cuda_dp.nonaffine_score(t1, t2, 1, -200, -10 ** 8)
    big = torch.full_like(t1, 2 ** 29)
    with pytest.raises(NotImplementedError, match="P2"):
        cuda_dp.nonaffine_score(big, t2, 1, -200, -250)
    with pytest.raises(NotImplementedError, match="P2"):
        cuda_dp.affine_score(t1, -big, 1, -150, -50, -150)
    assert isinstance(cuda_dp.affine_score(t1, t2, 1, -150, -50, -150), int)


@pytest.mark.parametrize("n,m", [(6, 6), (3, 40), (25, 0)])
def test_the_refusal_is_check_int32_safe_on_the_tables(n, m):
    """The entry points' check, made from the tables' largest magnitude and
    n + m alone, decides as check_int32_safe does on the tables themselves,
    on either side of its limit."""
    from bialign_tpu.ops.cases import check_int32_safe, int32_value_bound
    mu1, mu2 = _pair(n, m, 1)
    t1, t2 = _tables(mu1, mu2)
    peak = max(int(np.abs(mu1).max(initial=0)),
               int(np.abs(mu2).max(initial=0)))
    # the largest |gap_cost| the check lets pass, within rounding
    edge = ((1 << 30) - (1 << 20)) // (2 * (n + m + 2)) // 2 - 250 - peak
    for gamma, want in ((-50, True), (-(edge - 3), True),
                        (-(edge + 3), False), (-10 ** 8, False)):
        costs = dict(gap_cost=gamma, gap_opening_cost=0, shift_cost=-250)
        assert check_int32_safe(mu1, mu2, costs) is want
        assert int32_value_bound(mu1, mu2, costs) \
            == 2 * (n + m + 2) * 2 * (-gamma + 250 + peak)
        if want:
            cuda_dp._require_int32_safe(t1, t2, gamma, -250)
        else:
            with pytest.raises(NotImplementedError, match="P2"):
                cuda_dp._require_int32_safe(t1, t2, gamma, -250)


def test_score_entry_points_reject_bad_tables_and_rings():
    t1, t2 = _tables(*_pair(4, 4, 1))
    with pytest.raises(ValueError, match="int32"):
        cuda_dp.affine_score(t1.long(), t2, 1, -150, -50, -150)
    with pytest.raises(ValueError, match="differ"):
        cuda_dp.nonaffine_score(t1, t2[:, :3].contiguous(), 1, -200, -250)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_dp.nonaffine_score(t1.t(), t2.t(), 1, -200, -250)
    with pytest.raises(TypeError):
        cuda_dp.affine_score(t1.numpy(), t2, 1, -150, -50, -150)
    with pytest.raises(ValueError, match="max_shift"):
        cuda_dp.affine_score(t1, t2, -1, -150, -50, -150)
    with pytest.raises(ValueError, match="ring"):
        cuda_dp.affine_last_slab(t1, t2, 1, -150, -50, -150,
                                 ring=torch.zeros((2, 9, 3, 3, 5),
                                                  dtype=torch.int32))
    with pytest.raises(ValueError, match="ring"):
        cuda_dp.nonaffine_last_slab(t1, t2, 1, -200, -250,
                                    ring=torch.zeros((3, 3, 3, 5)))
    with pytest.raises(ValueError, match="ring"):
        cuda_dp.affine_ms0_last_slab(t1, t2, -150, -50, -150,
                                     ring=torch.zeros((3, 9, 5),
                                                      dtype=torch.int32))


def test_plain_score_keeps_no_band():
    """A pair whose affine band would take 324 MB scores in a ring of three
    slabs (here non-affine, max_shift 1: 3 * 9 * 1001 * 4 B)."""
    n = m = 1000
    rng = np.random.default_rng(5)
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = np.where(rng.random((n, m)) < 0.1, 500, -100)
    t1, t2 = _tables(mu1, mu1)
    ring = torch.zeros((3, 3, 3, n + 1), dtype=torch.int32)
    score = int(cuda_dp.nonaffine_last_slab_plain(
        t1, t2, 1, -200, -250, ring=ring)[1, 1, n])
    # a lower bound anyone can check: the all-match diagonal path
    assert score >= 2 * int(np.trace(mu1))
    assert ring.any()                 # the carry was the ring it was given
