"""Route "resident" of the triplet fill and of K3, their CUDA source built
for the host and run on the CPU.

``bialign_tpu_torch/csrc/triplet.cu`` (``triplet_fill_ring<...,
Ring::kResident>``) and K3's ``csrc/score_affine_ms0.cu`` (``cta_ms0<kRows,
true>`` of ``csrc/cta_scores.cuh``) run one cooperative launch of G CTAs,
each its own contiguous rows; the last row of each goes to the next through
device memory (the halo) under a progress flag a CTA, and a CTA waits only
for the one above.  They run only on the card, where ``chip_smoke.py`` holds
them to their plain twins.  Here the same source is built with the host's
C++20 compiler against ``tests/cuda_host/`` (a cooperative launch's CTAs
all at once as std::threads, each with a shared buffer of its own; flags as
``std::atomic_ref``; a seeded policy that delays random CTAs at their waits
and stores) and held to the twins with tolerance 0 on memory of garbage:
the triplet's slabs equal ``models.triplet.fill_slabs`` on the domain and
keep their garbage elsewhere; K3's ring equals
``cuda_dp.affine_ms0_last_slab_plain``'s in every cell.  G = 1-4 CTAs
forced (rows that G does not divide, CTAs without rows, CTAs without a live
row for whole diagonals), CTAs of one or several rows a thread, with and
without the spare warps that copy and publish the halo, max_shift 0-4 and
beyond the triplet's compiled widths, tie-heavy tables and tables whose
sums wrap int32.  One toy case of each also goes to the JAX package.  Then
the pure functions of the routes, a flag that never comes (the wait traps,
the fault word names the CTA) and a grid the card cannot hold (refused,
error 720, nothing run and no error left behind).  This checks the routes'
indexing, waits and halo; it says nothing of their speed and does not
replace the card's check (the stand-in's barrier and atomics order memory
by themselves).
"""

import ctypes

import numpy as np
import pytest
import torch
from cuda_host import emulation as emu

import bialign_tpu.models.triplet as J
from bialign_tpu.ops import pallas_dp
import bialign_tpu_torch.models.triplet as T
from bialign_tpu_torch.convert import tables_to_torch
from bialign_tpu_torch.ops import cuda_dp

GAMMA, DELTA = -200, -250
AFFINE_PARAMS = (-150, -50, -150)
WRAP_COSTS = (-(1 << 30) + 7, (1 << 31) - 11)
STATIC_SHIFTS = 8                   # csrc/triplet.cu kTripletStaticShifts
LAUNCH_FAILURE, TOO_LARGE = 719, 720


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = emu.compiler()
    work = tmp_path_factory.mktemp("resident_fills_host")
    csrc = emu.copy_csrc(work / "csrc", {"triplet.cu": (1, 1),
                                         "tile_diag.cuh": (1, 1),
                                         "cta_scores.cuh": (2, 2),
                                         "score_affine_ms0.cu": (0, 1)})
    # -fwrapv: int32 sums wrap on the host as on the card
    lib = emu.build(cxx, [csrc / "triplet.cu", csrc / "score_affine_ms0.cu"],
                    work / "libresident_fills.so", "-fwrapv")
    yield lib
    lib.host_flag_delays(0, 0)


def _tables(rng, n, m, kind="random"):
    """[n+1, m+1] int32 tables, row and column 0 zero: the triplet tests'
    values, tie-heavy ones in {0, +-100}, or magnitudes 2^29 to 2^31 - 1
    of either sign."""
    mu = np.zeros((2, n + 1, m + 1), dtype=np.int64)
    if kind == "random":
        mu[:, 1:, 1:] = rng.integers(-400, 900, size=(2, n, m))
    elif kind == "ties":
        mu[:, 1:, 1:] = rng.integers(-1, 2, size=(2, n, m)) * 100
    else:
        mu[:, 1:, 1:] = (rng.integers(1 << 29, (1 << 31) - 1, size=(2, n, m))
                         * rng.choice([-1, 1], size=(2, n, m)))
    return mu[0].astype(np.int32), mu[1].astype(np.int32)


def _delayed(lib, seed):
    """Random delays of 30% of the waits and stores, by ``seed``."""
    lib.host_flag_delays(30, seed)


# -- the triplet --------------------------------------------------------------

def triplet_resident(lib, mu1, mu2, S, gamma, delta, ctas, threads, junk,
                     fault=None):
    """The kernel's slabs on the stand-in, from a copy of ``junk``; returns
    (the launch's error, the slabs)."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    ys = junk.clone()
    t1, t2 = T.shared_tables(mu1, mu2, S, "cpu")
    halo = emu.garbage(np.random.default_rng(ctas), (max(ctas - 1, 1),
                                                     n + m + 1, 2 * S + 1))
    flags = torch.zeros(ctas, dtype=torch.int32)
    emu.call(lib, "bialign_triplet_fill_resident", ys, t1, t2, n, m, S,
             T._int32(2 * gamma), T._int32(gamma + delta), threads, ctas,
             halo if ctas > 1 else None, flags, fault)
    return lib.host_synchronize(), ys


def check_triplet(lib, mu1, mu2, S, gamma, delta, ctas, threads, seed):
    """Route "resident" on garbage under delays: the twin's values on the
    domain, the garbage elsewhere; returns the slabs."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    junk = emu.garbage(np.random.default_rng(seed),
                       (n + m + 1, n + 1, 2 * S + 1))
    _delayed(lib, seed)
    try:
        err, got = triplet_resident(lib, mu1, mu2, S, gamma, delta, ctas,
                                    threads, junk)
    finally:
        lib.host_flag_delays(0, 0)
    assert err == 0
    want = T.fill_slabs(mu1, mu2, S, gamma, delta, device="cpu")
    assert torch.equal(got, torch.where(T.domain(n, m, S), want, junk))
    return got


# rows that G divides and rows that it does not; CTAs without rows (n+1 <
# G); CTAs without a live row for whole diagonals (n >> m, n << m); every
# compiled width up to 4 and the run-time one
TRIPLET_SHAPES = [(11, 9, 1), (10, 13, 2), (63, 9, 1), (5, 70, 3),
                  (1, 5, 1), (0, 4, 1), (9, 11, 0), (40, 37, 4),
                  (9, 11, STATIC_SHIFTS + 2)]


@pytest.mark.parametrize("ctas", (2, 3, 4))
@pytest.mark.parametrize("threads", (32, 48))
@pytest.mark.parametrize("n,m,S", TRIPLET_SHAPES)
def test_triplet_resident_equals_the_twin(lib, n, m, S, threads, ctas):
    """CTAs of 32 and 48 threads (a row a thread, or several: the tables
    staged), no spare warp: the first row's thread copies the halo and
    publishes its CTA's."""
    rng = np.random.default_rng(n * 31 + m * 7 + S)
    mu1, mu2 = _tables(rng, n, m)
    check_triplet(lib, mu1, mu2, S, GAMMA, DELTA, ctas, threads,
                  n + m + S + ctas)


@pytest.mark.parametrize("n,m,S,ctas", [
    (60, 50, 1, 3), (95, 99, 4, 2), (33, 40, 8, 4), (7, 30, 2, 2),
    (47, 20, 3, 3), (130, 64, 1, 4)])
def test_triplet_resident_at_its_default_threads(lib, n, m, S, ctas):
    """resident_shape's threads: the rows' warps and the flush warps, whose
    last threads copy the halo and publish the CTA's (two warps: two
    threads)."""
    G, threads, _ = T.resident_shape(n, S, ctas)
    rows = -(-(n + 1) // G)
    assert G == ctas and threads >= -(-rows // 32) * 32 + 64
    rng = np.random.default_rng(6000 + n + m + S)
    mu1, mu2 = _tables(rng, n, m)
    check_triplet(lib, mu1, mu2, S, GAMMA, DELTA, ctas, threads, ctas)


@pytest.mark.parametrize("n,m,S,ctas,threads", [
    (70, 65, 1, 3, 64), (100, 90, 2, 2, 128), (40, 37, 3, 1, 96)])
def test_triplet_resident_with_one_spare_warp(lib, n, m, S, ctas, threads):
    """One warp beyond the rows' (or one CTA): one thread both copies and
    publishes; G = 1, no halo at all."""
    rng = np.random.default_rng(7000 + n + m + S)
    mu1, mu2 = _tables(rng, n, m)
    check_triplet(lib, mu1, mu2, S, GAMMA, DELTA, ctas, threads, threads)


@pytest.mark.parametrize("kind", ("ties", "wrap"))
@pytest.mark.parametrize("n,m,S,ctas", [(20, 23, 2, 3), (50, 47, 1, 4),
                                        (6, 7, STATIC_SHIFTS + 1, 2)])
def test_triplet_resident_on_tie_heavy_and_wrapping_tables(lib, n, m, S,
                                                            ctas, kind):
    rng = np.random.default_rng(2000 + n + m + S)
    mu1, mu2 = _tables(rng, n, m, kind)
    costs = (-100, 0) if kind == "ties" else WRAP_COSTS
    got = check_triplet(lib, mu1, mu2, S, *costs, ctas, 48, S)
    if kind == "wrap":
        oracle = T.fill_oracle(mu1, mu2, S, *costs)
        ys = T.oracle_layout(got.numpy(), n, m, S)
        assert not np.array_equal(ys, oracle)  # the int64 oracle differs


def test_triplet_resident_equals_fill_xla(lib):
    """A toy pair through route "resident", in the oracle's layout, against
    the JAX package's XLA fill."""
    n, m, S = 40, 33, 2
    mu1, mu2 = _tables(np.random.default_rng(6), n, m)
    got = check_triplet(lib, mu1, mu2, S, GAMMA, DELTA, 3, 32, 14)
    assert np.array_equal(T.oracle_layout(got.numpy(), n, m, S),
                          J.fill_xla(mu1, mu2, S, GAMMA, DELTA))


def test_triplet_resident_refuses_what_cannot_run(lib):
    """Threads beyond a CTA of the route (512) or none, no CTA, no flags, no
    halo memory for several CTAs, and a CTA beyond its shared memory, are
    refused before any launch; a grid that the card cannot hold at once
    (here a stand-in card of one SM holding two CTAs) is refused with error
    720, runs nothing, and leaves no error behind: the next launch reports
    its own result.  No other route runs in its place."""
    mu1, mu2 = _tables(np.random.default_rng(0), 9, 8)
    t1, t2 = T.shared_tables(mu1, mu2, 1, "cpu")
    junk = emu.garbage(np.random.default_rng(1), (18, 10, 3))
    ys = junk.clone()
    flags = torch.zeros(4, dtype=torch.int32)
    halo = torch.zeros((3, 18, 3), dtype=torch.int32)

    def entry(n, S, threads, ctas, halo=halo, flags=flags):
        return lib.bialign_triplet_fill_resident(
            *(ctypes.c_void_p(x.data_ptr()) for x in (ys, t1, t2)),
            *(ctypes.c_int(v) for v in (n, 8, S, 0, 0, threads, ctas)),
            *(ctypes.c_void_p(None if x is None else x.data_ptr())
              for x in (halo, flags, None)), ctypes.c_int(0), None)

    for n, S, threads, ctas, h, f in [
            (9, 1, 0, 2, halo, flags), (9, 1, 513, 2, halo, flags),
            (9, 1, 32, 0, halo, flags), (9, 1, 32, 2, halo, None),
            (9, 1, 32, 2, None, flags), (20000, 48, 512, 2, halo, flags)]:
        assert entry(n, S, threads, ctas, h, f) != 0
    assert T.resident_shape(20000, 48, 2) is None
    lib.host_resident(1, 2)
    try:
        assert entry(9, 1, 32, 3) == TOO_LARGE
        assert lib.host_synchronize() == 0
        assert torch.equal(ys, junk)
        flags.zero_()
        assert entry(9, 1, 32, 2) == 0
        assert lib.host_synchronize() == 0
    finally:
        lib.host_resident(4, 2)
    want = T.fill_slabs(mu1, mu2, 1, 0, 0, device="cpu")
    assert torch.equal(ys, torch.where(T.domain(9, 8, 1), want, junk))


def test_triplet_flag_that_never_comes_traps(lib):
    """CTA 1 stops publishing from progress 5 on: CTA 2's wait runs out of
    budget, the launch fails, and the fault word names CTA 2, the diagonal
    it waited for and the CTA above; the next launch runs again."""
    n, m, S = 11, 9, 1
    mu1, mu2 = _tables(np.random.default_rng(3), n, m)
    junk = emu.garbage(np.random.default_rng(4), (n + m + 1, n + 1, 3))
    fault = torch.zeros(4, dtype=torch.int32)
    lib.host_spin_budget_ms(300)
    lib.host_flag_drop(1, 5)
    try:
        err, _ = triplet_resident(lib, mu1, mu2, S, GAMMA, DELTA, 3, 32,
                                  junk, fault)
    finally:
        lib.host_flag_drop(-1, 0)
        lib.host_spin_budget_ms(5000)
    assert err == LAUNCH_FAILURE
    assert fault.tolist()[:2] == [1, 2] and fault[3] == 1
    assert 5 <= fault[2] <= n + m
    check_triplet(lib, mu1, mu2, S, GAMMA, DELTA, 3, 32, 5)


# -- K3 -----------------------------------------------------------------------

def k3_resident(lib, mu1, mu2, params, ctas, threads, junk, fault=None):
    """K3's ring on the stand-in, from a copy of ``junk``; returns (the
    launch's error, the ring)."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    ring = junk.clone()
    halo = emu.garbage(np.random.default_rng(ctas),
                       (max(ctas - 1, 1), n + m + 1, 3))
    flags = torch.zeros(ctas, dtype=torch.int32)
    emu.call(lib, "bialign_score_affine_ms0_resident", ring, t1, t2,
             cuda_dp.ms0_kernel_consts(*params), n, m, ctas, threads,
             halo if ctas > 1 else None, flags, fault)
    return lib.host_synchronize(), ring


def check_k3(lib, mu1, mu2, params, ctas, threads, seed):
    """Route "resident" on a ring of garbage under delays: every cell equal
    to the twin's on the same garbage; returns the ring."""
    n = mu1.shape[0] - 1
    junk = emu.garbage(np.random.default_rng(seed), (3, 3, n + 1))
    _delayed(lib, seed)
    try:
        err, got = k3_resident(lib, mu1, mu2, params, ctas, threads, junk)
    finally:
        lib.host_flag_delays(0, 0)
    assert err == 0
    twin = junk.clone()
    cuda_dp.affine_ms0_last_slab_plain(*tables_to_torch(mu1, mu2, "cpu"),
                                       *params, ring=twin)
    assert torch.equal(got, twin)
    return got


# tests/test_torch_score.py's K3 shapes, and rows that G does not divide,
# CTAs without rows, CTAs without a live row for whole diagonals
K3_SHAPES = [(7, 9), (1, 1), (0, 3), (5, 0), (20, 13), (70, 65), (33, 100),
             (100, 20)]


@pytest.mark.parametrize("ctas", (1, 2, 3, 4))
@pytest.mark.parametrize("n,m", K3_SHAPES)
def test_k3_resident_equals_the_twin(lib, n, m, ctas):
    """At the default threads: a row a thread and two warps more, whose
    last threads copy the halo and publish the CTA's."""
    rng = np.random.default_rng(n * 7 + m + ctas)
    mu1, mu2 = _tables(rng, n, m)
    check_k3(lib, mu1, mu2, AFFINE_PARAMS, ctas, 0, n + m + ctas)


@pytest.mark.parametrize("n,m,ctas,threads", [
    (70, 65, 1, 32), (70, 65, 2, 32), (130, 50, 2, 32), (70, 65, 3, 32),
    (40, 45, 2, 64), (100, 30, 3, 96)])
def test_k3_resident_rows_a_thread(lib, n, m, ctas, threads):
    """CTAs of 32 threads over 71 rows (a thread three of its rows: the
    register rows of cta_ms0<4>, the last not a whole multiple), over 36
    (cta_ms0<2>), over 131 in two CTAs; and one spare warp (one thread both
    copies and publishes)."""
    rng = np.random.default_rng(8000 + n + m + ctas)
    mu1, mu2 = _tables(rng, n, m)
    check_k3(lib, mu1, mu2, AFFINE_PARAMS, ctas, threads, threads + ctas)


@pytest.mark.parametrize("kind", ("ties", "wrap"))
@pytest.mark.parametrize("n,m,ctas", [(20, 23, 3), (50, 47, 4)])
def test_k3_resident_on_tie_heavy_and_wrapping_tables(lib, n, m, ctas,
                                                       kind):
    """Tie-heavy tables with costs of the same grain; and tables whose sums
    leave int32 (the kernel and the twin wrap alike)."""
    rng = np.random.default_rng(9000 + n + m)
    mu1, mu2 = _tables(rng, n, m, kind)
    params = (-200, -100, -100) if kind == "ties" else (
        -(1 << 28) + 3, -(1 << 28) + 5, (1 << 28) - 7)
    check_k3(lib, mu1, mu2, params, ctas, 0, ctas)


def test_k3_resident_equals_the_jax_score(lib):
    """A toy pair through route "resident" over three CTAs: the max of the
    three live states at row n of the last slab equals the JAX package's
    K3 score (pallas_dp.affine_score at max_shift 0, interpret mode)."""
    n, m = 20, 13
    rng = np.random.default_rng(21)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    ring = check_k3(lib, mu1, mu2, AFFINE_PARAMS, 3, 0, 22)
    assert int(ring[(n + m) % 3][:, n].max()) == pallas_dp.affine_score(
        mu1, mu2, 0, *AFFINE_PARAMS, interpret=True)


def test_k3_resident_refuses_what_cannot_run(lib):
    """No CTA, threads beyond a CTA, more than four rows a thread, no flags
    or no halo memory for several CTAs are refused before any launch; a
    grid that the card cannot hold at once is refused with error 720, runs
    nothing and leaves no error behind (the next launch reports its own
    result); no other route runs in its place."""
    n, m = 9, 8
    mu1, mu2 = _tables(np.random.default_rng(5), n, m)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    consts = cuda_dp.ms0_kernel_consts(*AFFINE_PARAMS)
    junk = emu.garbage(np.random.default_rng(6), (3, 3, n + 1))
    ring = junk.clone()
    flags = torch.zeros(4, dtype=torch.int32)
    halo = torch.zeros((3, n + m + 1, 3), dtype=torch.int32)

    def entry(ctas, threads, halo=halo, flags=flags):
        return lib.bialign_score_affine_ms0_resident(
            *(ctypes.c_void_p(x.data_ptr()) for x in (ring, t1, t2, consts)),
            *(ctypes.c_int(v) for v in (n, m, ctas, threads)),
            *(ctypes.c_void_p(None if x is None else x.data_ptr())
              for x in (halo, flags, None)), ctypes.c_int(0), None)

    for ctas, threads, h, f in [(0, 0, halo, flags), (2, 1025, halo, flags),
                                (1, 2, halo, flags), (2, 0, halo, None),
                                (2, 0, None, flags)]:
        assert entry(ctas, threads, h, f) != 0
    lib.host_resident(1, 2)
    try:
        assert entry(3, 0) == TOO_LARGE
        assert lib.host_synchronize() == 0
        assert torch.equal(ring, junk)
        flags.zero_()
        assert entry(2, 0) == 0
        assert lib.host_synchronize() == 0
    finally:
        lib.host_resident(4, 2)
    twin = junk.clone()
    cuda_dp.affine_ms0_last_slab_plain(t1, t2, *AFFINE_PARAMS, ring=twin)
    assert torch.equal(ring, twin)


def test_k3_flag_that_never_comes_traps(lib):
    """CTA 0 stops publishing from progress 4 on: CTA 1's wait runs out of
    budget, the launch fails and the fault word names CTA 1 and the CTA
    above; the next launch runs again."""
    n, m = 11, 9
    mu1, mu2 = _tables(np.random.default_rng(7), n, m)
    junk = emu.garbage(np.random.default_rng(8), (3, 3, n + 1))
    fault = torch.zeros(4, dtype=torch.int32)
    lib.host_spin_budget_ms(300)
    lib.host_flag_drop(0, 4)
    try:
        err, _ = k3_resident(lib, mu1, mu2, AFFINE_PARAMS, 2, 0, junk, fault)
    finally:
        lib.host_flag_drop(-1, 0)
        lib.host_spin_budget_ms(5000)
    assert err == LAUNCH_FAILURE
    assert fault.tolist()[:2] == [1, 1] and fault[3] == 1
    assert 4 <= fault[2] <= n + m
    check_k3(lib, mu1, mu2, AFFINE_PARAMS, 2, 0, 9)


# -- the routes' pure functions ----------------------------------------------

def test_resident_shape_takes_a_cta_a_sm():
    """By default the most CTAs up to one a SM that leave none without
    rows (the fewest rows a CTA), each a CTA of route "cluster" with the
    halo's staging rows; a forced G is kept, CTAs without rows included."""
    assert T.resident_shape(6999, 8)[:2] == (130, 128)      # 54 rows a CTA
    assert T.resident_shape(6536, 8)[0] == 131              # 50 rows
    assert T.resident_shape(100000, 0)[:2] == (132, 512)    # staged
    assert T.resident_shape(9, 1)[0] == 10                  # a row a CTA
    assert T.resident_shape(9, 1, 16)[0] == 16              # 6 CTAs empty
    for n, S, G in [(6999, 8, None), (1500, 8, 7), (9, 9, 3)]:
        G, threads, need = T.resident_shape(n, S, G)
        assert need == T.cluster_bytes(n, S, G, threads) + 8 * (2 * S + 1)
        assert threads == T.cluster_threads(n, S, G) <= T.CLUSTER_MAX_THREADS
    assert T.resident_shape(1500, 8, sms=64)[0] == 63      # 24 rows a CTA
    with pytest.raises(ValueError, match="ctas"):
        T.resident_shape(9, 1, 0)


@pytest.mark.parametrize("S", (0, 1, 4, 8, 9, 16, 32, 48))
def test_resident_reaches_every_pair_whose_slabs_fit_the_card(S):
    """Every n whose slabs ys, (2n+1)(n+1)(2S+1) int32 at m = n, fit 80 GB
    gets a resident shape of at most 132 CTAs: the default route never
    needs "global"."""
    W = 2 * S + 1
    n = int((80e9 / (8 * W)) ** 0.5)
    while (2 * n + 1) * (n + 1) * W * 4 <= 80e9:
        n += 1
    for k in (n - 1, n // 2, n // 7 + 1):
        G, threads, need = T.resident_shape(k, S)
        assert G <= 132 and need <= T.CTA_SHARED_LIMIT and threads <= 512
        if T.triplet_route(k, S) != "shared":
            assert T.triplet_route(k, S) in ("cluster", "resident")


def test_triplet_route_order():
    """"shared" while one CTA holds the pair, beyond it "resident" at the
    compiled widths, and at the wider bands "cluster" while a portable
    cluster holds the pair, "resident" beyond; "global" only when
    forced."""
    assert T.triplet_route(928, 1) == "shared"
    assert T.triplet_route(1023, 8) == "shared"
    assert T.triplet_route(1024, 8) == "resident"
    assert T.triplet_route(1500, 8) == "resident"
    assert T.triplet_route(6536, 8) == "resident"
    assert T.triplet_route(3874, 1) == "resident"
    assert T.triplet_route(734, 9) == "shared"
    assert T.triplet_route(735, 9) == "cluster"
    assert T.triplet_route(5871, 9) == "cluster"
    assert T.triplet_route(5872, 9) == "resident"
    assert all(T.triplet_route(n, S) != "global"
               for S in range(0, 49, 6) for n in range(0, 40000, 997))


def test_forced_resident_on_the_cpu_is_the_twin():
    """route="resident" (and ctas=) checked, then the twin runs on a CPU
    device; ctas on another route, threads beyond 512 and a CTA beyond its
    shared memory raise."""
    rng = np.random.default_rng(9)
    mu1, mu2 = _tables(rng, 9, 7)
    want = T.fill_slabs(mu1, mu2, 2, GAMMA, DELTA, device="cpu")
    for G in (None, 1, 3, 40):
        assert torch.equal(T.fill_slabs_cuda(mu1, mu2, 2, GAMMA, DELTA,
                                             device="cpu", route="resident",
                                             ctas=G), want)
    with pytest.raises(ValueError, match="route 'resident'"):
        T.fill_slabs_cuda(mu1, mu2, 2, GAMMA, DELTA, device="cpu", ctas=2)
    with pytest.raises(ValueError, match="threads"):
        T.fill_slabs_cuda(mu1, mu2, 2, GAMMA, DELTA, device="cpu",
                          route="resident", threads=513)
    big = np.zeros((20000, 2), dtype=np.int32)
    with pytest.raises(ValueError, match="over 2 CTAs need"):
        T.fill_slabs_cuda(big, big, 48, GAMMA, DELTA, device="cpu",
                          route="resident", ctas=2)
    assert "resident" in T.ROUTES and "triplet_fill_resident" in T.LAUNCHES


@pytest.mark.parametrize("n,route", [
    (1022, "cta"), (1023, "resident"), (4095, "resident"),
    (4096, "resident"), (8191, "resident"), (13000, "resident")])
def test_k3_route_beyond_one_cta_is_resident(n, route):
    """K3's own route from 1024 rows on is "resident" (beyond 4096 rows and
    where it measured faster than one CTA); "grid" and "cta" stay forced
    routes; a bucket of one such pair keeps K7's "cta" where one CTA holds
    it, K4's "grid" beyond, and no bucket takes "resident"."""
    assert cuda_dp.batch_route(n, 0, True, B=1) == route
    assert cuda_dp.batch_route(n, 0, True, "grid", B=1) == "grid"
    assert cuda_dp.batch_route(n, 0, True, "resident", B=1) == "resident"
    assert cuda_dp._bucket_route(n, 0, True, None, 1) == (
        "cta" if n <= 4095 else "grid")
    for B, S, affine in [(2, 0, True), (1, 1, True), (1, 0, False)]:
        with pytest.raises(ValueError, match="K3's alone"):
            cuda_dp.batch_route(n, S, affine, "resident", B=B)
    with pytest.raises(ValueError, match="not a bucket's"):
        cuda_dp._bucket_route(n, 0, True, "resident", 1)


def test_ms0_resident_shape():
    """A CTA a SM by default, a row a thread and two warps more; at most
    four rows a thread."""
    assert cuda_dp.ms0_resident_shape(8191) == (131, 63, 128)
    assert cuda_dp.ms0_resident_shape(4095) == (128, 32, 96)
    assert cuda_dp.ms0_resident_shape(9) == (10, 1, 96)
    assert cuda_dp.ms0_resident_shape(9, 3) == (3, 4, 96)
    assert cuda_dp.ms0_resident_shape(70, 1, 32) == (1, 71, 32)
    assert cuda_dp.ms0_resident_shape(200, 1, 32) is None
    assert cuda_dp.ms0_resident_shape(540671) == (132, 4096, 1024)
    assert cuda_dp.ms0_resident_shape(540672) is None
    with pytest.raises(ValueError, match="ctas"):
        cuda_dp.ms0_resident_shape(9, 0)


def test_k3_forced_resident_on_the_cpu_is_the_twin():
    """route="resident" with its ctas= and threads= checked, then the twin
    runs on the CPU; ctas= on another route, and a shape whose threads
    take more than four rows, raise."""
    rng = np.random.default_rng(10)
    mu1, mu2 = _tables(rng, 30, 20)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    want = cuda_dp.affine_ms0_last_slab_plain(t1, t2, *AFFINE_PARAMS)
    for kw in ({}, dict(ctas=3), dict(ctas=2, threads=32)):
        assert torch.equal(cuda_dp.affine_ms0_last_slab(
            t1, t2, *AFFINE_PARAMS, route="resident", **kw), want)
    with pytest.raises(ValueError, match="route 'resident'"):
        cuda_dp.affine_ms0_last_slab(t1, t2, *AFFINE_PARAMS, ctas=2)
    with pytest.raises(ValueError, match="four rows"):
        cuda_dp.affine_ms0_last_slab(t1, t2, *AFFINE_PARAMS,
                                     route="resident", ctas=1, threads=4)
    assert "score_affine_ms0_resident" in cuda_dp.LAUNCHES
