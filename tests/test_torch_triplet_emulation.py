"""The triplet fill's CUDA source, built for the host and run on the CPU.

``bialign_tpu_torch/csrc/triplet.cu`` (one CTA runs the whole wavefront, a
thread its rows, a barrier between diagonals; route "global" reads the last
two diagonals back from the slabs, route "shared" keeps the last three in
shared memory and the tables in registers or staged there, route "cluster"
splits the rows over the CTAs of a thread-block cluster, each passing its
last row to the next through distributed shared memory) runs only on the
card, where ``chip_smoke.py`` holds it to its plain twin.  Here the same
source is built with the host's C++20 compiler against ``tests/cuda_host/``
(the CTA as std::threads meeting at a std::barrier for each
``__syncthreads()``, its shared buffer a host buffer filled with a pattern,
its ``<<<>>>`` launches rewritten to ``host_launch``; a cluster's CTAs run at
once, each with a buffer of its own, and meet at one std::barrier for each
cluster barrier) and held to the twin
``models.triplet.fill_slabs(device="cpu")`` with tolerance 0: on slabs of
garbage, the cells of the domain equal to the twin's and every other cell
keeps its garbage.  Every route; thread counts of 32 and 48 (not a warp's
multiple), so that a thread takes one row or several (the tables in
registers, or staged); clusters of 2, 3 and 4 CTAs, rows that C does not
divide, CTAs without rows and CTAs without a live row for whole diagonals;
max_shift 0-4 and one beyond the widths the kernel compiles as constants;
tie-heavy tables and tables whose sums wrap int32.  One case a route also
goes to the JAX ``fill_xla`` through the oracle's layout.  This checks the
kernels' indexing, guards, barriers and staging; it says nothing of their
speed and does not replace the card's check.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
from cuda_host import emulation as emu
from test_torch_triplet import SHAPES, _rand_tables

import bialign_tpu.models.triplet as J
import bialign_tpu_torch.models.triplet as T
from bialign_tpu_torch import _build

GAMMA, DELTA = -200, -250
THREADS = (32, 48)
STATIC_SHIFTS = 8          # csrc/triplet.cu kTripletStaticShifts
# a thread several rows; every compiled width up to 4 and the run-time one
MORE_SHAPES = [(70, 65, 1), (33, 40, 2)] + [
    (9, 11, S) for S in (0, 1, 2, 3, 4, STATIC_SHIFTS + 2)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = emu.compiler()
    work = tmp_path_factory.mktemp("triplet_host")
    csrc = emu.copy_csrc(work / "csrc", {"triplet.cu": (1, 1)})
    return emu.build(cxx, [csrc / "triplet.cu"], work / "libtriplet_host.so")


# the C entry of each route
ENTRY = {"global": "bialign_triplet_fill",
         "shared": "bialign_triplet_fill_shared",
         "cluster": "bialign_triplet_fill_cluster"}


def kernel_fill(lib, mu1, mu2, S, gamma, delta, threads, junk,
                route="global", cluster=None):
    """The kernel's slabs, started from a copy of ``junk``; route
    "cluster" on ``cluster`` CTAs of ``threads`` threads each."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    ys = junk.clone()
    if route == "global":
        t1, t2 = torch.from_numpy(mu1), torch.from_numpy(mu2)
    else:
        t1, t2 = T.shared_tables(mu1, mu2, S, "cpu")
    more = () if cluster is None else (cluster,)
    emu.call(lib, ENTRY[route], ys, t1, t2, n, m, S, T._int32(2 * gamma),
             T._int32(gamma + delta), threads, *more)
    return ys


def check_against_twin(lib, mu1, mu2, S, gamma, delta, threads, seed,
                       route="global", cluster=None):
    """The kernel on slabs of garbage: the twin's values on the domain,
    the garbage elsewhere; returns the kernel's slabs."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    junk = emu.garbage(np.random.default_rng(seed), (n + m + 1, n + 1,
                                                      2 * S + 1))
    got = kernel_fill(lib, mu1, mu2, S, gamma, delta, threads, junk, route,
                      cluster)
    want = T.fill_slabs(mu1, mu2, S, gamma, delta, device="cpu")
    live = T.domain(n, m, S)
    assert torch.equal(got, torch.where(live, want, junk))
    return got


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", SHAPES + MORE_SHAPES)
def test_kernel_equals_the_twin(lib, n, m, S, threads):
    rng = np.random.default_rng(n * 31 + m * 7 + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, threads, n + m + S)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", [(12, 10, 1), (16, 17, 2), (40, 37, 3)])
def test_kernel_on_tie_heavy_tables(lib, n, m, S, threads):
    """Values in {0, +-100} and gamma = gamma + Delta: many cases tie."""
    rng = np.random.default_rng(1000 + n + m + S)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(-1, 2, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-1, 2, size=(n, m)) * 100
    check_against_twin(lib, mu1, mu2, S, -100, 0, threads, 7 * n + S)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", [(9, 8, 1), (20, 23, 2),
                                   (6, 7, STATIC_SHIFTS + 1)])
def test_kernel_where_sums_wrap_int32(lib, n, m, S, threads):
    """Table values and costs near the int32 limits: the sums wrap, and
    the kernel wraps as the twin does."""
    rng = np.random.default_rng(2000 + n + m + S)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    big = rng.integers(1 << 29, (1 << 31) - 1, size=(2, n, m))
    sign = rng.choice([-1, 1], size=(2, n, m))
    mu1[1:, 1:] = big[0] * sign[0]
    mu2[1:, 1:] = big[1] * sign[1]
    gamma, delta = -(1 << 30) + 7, (1 << 31) - 11
    got = check_against_twin(lib, mu1, mu2, S, gamma, delta, threads, S)
    n_, m_ = mu1.shape[0] - 1, mu1.shape[1] - 1
    oracle = T.fill_oracle(mu1, mu2, S, gamma, delta)
    ys = T.oracle_layout(got.numpy(), n_, m_, S)
    assert not np.array_equal(ys, oracle)      # the int64 oracle differs


def test_kernel_equals_fill_xla(lib):
    """A toy pair through the kernel, in the oracle's layout, against the
    JAX package's XLA fill."""
    n, m, S = 7, 9, 2
    mu1, mu2 = _rand_tables(np.random.default_rng(5), n, m)
    got = check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, 32, 11)
    assert np.array_equal(T.oracle_layout(got.numpy(), n, m, S),
                          J.fill_xla(mu1, mu2, S, GAMMA, DELTA))


def test_kernel_refuses_a_bad_launch(lib):
    """Threads beyond one CTA, or none, are refused before any launch."""
    mu = torch.zeros((3, 3), dtype=torch.int32)
    ys = torch.zeros((5, 3, 3), dtype=torch.int32)
    for threads in (0, 1025):
        err = lib.bialign_triplet_fill(
            *(ctypes.c_void_p(t.data_ptr()) for t in (ys, mu, mu)),
            *(ctypes.c_int(v) for v in (2, 2, 1, 0, 0, threads, 0)), None)
        assert err != 0


# -- route "shared": the last three diagonals in shared memory -------------

def tie_tables(rng, n, m):
    """Values in {0, +-100}: with gamma = gamma + Delta many cases tie."""
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(-1, 2, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-1, 2, size=(n, m)) * 100
    return mu1, mu2


def wrap_tables(rng, n, m):
    """Values of magnitude 2^29 to 2^31 - 1, either sign; with WRAP_COSTS
    the sums leave int32."""
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    big = rng.integers(1 << 29, (1 << 31) - 1, size=(2, n, m))
    sign = rng.choice([-1, 1], size=(2, n, m))
    mu1[1:, 1:] = big[0] * sign[0]
    mu2[1:, 1:] = big[1] * sign[1]
    return mu1, mu2


WRAP_COSTS = (-(1 << 30) + 7, (1 << 31) - 11)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", SHAPES + MORE_SHAPES)
def test_shared_route_equals_the_twin(lib, n, m, S, threads):
    """Route "shared" on garbage, every shape at 32 and 48 threads: n+1 up
    to the threads keeps the tables in registers, more rows (and max_shift
    beyond the compiled widths) stage them in shared memory."""
    assert T.triplet_route(n, S, threads) == "shared"
    rng = np.random.default_rng(n * 31 + m * 7 + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, threads, n + m + S,
                       "shared")


@pytest.mark.parametrize("threads", [1, 7, 64])
@pytest.mark.parametrize("n,m,S", [(40, 37, 2), (63, 9, 1), (5, 70, 3)])
def test_shared_route_at_other_thread_counts(lib, n, m, S, threads):
    """One thread for every row, seven (rows 7 apart), and a CTA of more
    threads than rows (the tables in registers, whole diagonals of rows
    inside the domain)."""
    rng = np.random.default_rng(3000 + n + m + S + threads)
    mu1, mu2 = _rand_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, threads, threads,
                       "shared")


@pytest.mark.parametrize("n,m,S", [(100, 90, 1), (95, 120, 3), (127, 64, 0)])
def test_shared_route_in_warps_of_a_larger_cta(lib, n, m, S):
    """A CTA of 128 threads, one row each: four warps, each taking the
    unguarded form on the diagonals where all its live rows lie inside the
    domain and the guarded form at the domain's edges."""
    rng = np.random.default_rng(4000 + n + m + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, 128, S, "shared")


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", [(12, 10, 1), (16, 17, 2), (40, 37, 3),
                                   (20, 21, STATIC_SHIFTS + 1)])
def test_shared_route_on_tie_heavy_tables(lib, n, m, S, threads):
    rng = np.random.default_rng(1000 + n + m + S)
    mu1, mu2 = tie_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, -100, 0, threads, 7 * n + S,
                       "shared")


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", [(9, 8, 1), (20, 23, 2), (50, 47, 1),
                                   (6, 7, STATIC_SHIFTS + 1)])
def test_shared_route_where_sums_wrap_int32(lib, n, m, S, threads):
    rng = np.random.default_rng(2000 + n + m + S)
    mu1, mu2 = wrap_tables(rng, n, m)
    got = check_against_twin(lib, mu1, mu2, S, *WRAP_COSTS, threads, S,
                             "shared")
    oracle = T.fill_oracle(mu1, mu2, S, *WRAP_COSTS)
    ys = T.oracle_layout(got.numpy(), n, m, S)
    assert not np.array_equal(ys, oracle)      # the int64 oracle differs


@pytest.mark.parametrize("threads", THREADS)
def test_shared_route_equals_fill_xla(lib, threads):
    n, m, S = 40, 33, 2
    mu1, mu2 = _rand_tables(np.random.default_rng(6), n, m)
    got = check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, threads, 12,
                             "shared")
    assert np.array_equal(T.oracle_layout(got.numpy(), n, m, S),
                          J.fill_xla(mu1, mu2, S, GAMMA, DELTA))


def test_shared_route_refuses_what_does_not_fit(lib):
    """Threads beyond one CTA, or none, and a ring beyond one CTA's shared
    memory (the bytes of models.triplet.shared_bytes) are refused before
    any launch: the slabs keep their garbage."""
    mu = T.shared_tables(*[np.zeros((3, 3), np.int32)] * 2, 1, "cpu")[0]
    ys = emu.garbage(np.random.default_rng(0), (5, 3, 3))
    before = ys.clone()
    for n, S, threads in [(2, 1, 0), (2, 1, 1025), (3873, 2, 1024),
                          (1023, 9, 1024), (1024, 8, 1024)]:
        assert T.shared_bytes(n, S, max(threads, 1)) > T.CTA_SHARED_LIMIT \
            or threads in (0, 1025)
        err = lib.bialign_triplet_fill_shared(
            *(ctypes.c_void_p(t.data_ptr()) for t in (ys, mu, mu)),
            *(ctypes.c_int(v) for v in (n, 2, S, 0, 0, threads, 0)), None)
        assert err != 0
    assert torch.equal(ys, before)


# -- route "cluster": the rows split over the CTAs of a cluster -------------

CLUSTERS = (2, 3, 4)
# rows that C divides and rows that it does not; CTAs with no rows (n+1 <
# C); CTAs without a live row for whole diagonals (n >> m, n << m)
CLUSTER_SHAPES = [(11, 9, 1), (10, 13, 2), (63, 9, 1), (5, 70, 3),
                  (47, 40, 2)]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", SHAPES + MORE_SHAPES + CLUSTER_SHAPES)
def test_cluster_route_equals_the_twin(lib, n, m, S, threads, cluster):
    """Route "cluster" on garbage, every shape at 32 and 48 threads a CTA
    and 2, 3 and 4 CTAs: a CTA's rows up to its threads keep the tables in
    registers, more rows (and max_shift beyond the compiled widths) stage
    them; n+1 of 1 and 2 leave CTAs without rows."""
    rng = np.random.default_rng(n * 31 + m * 7 + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, threads,
                       n + m + S + cluster, "cluster", cluster)


@pytest.mark.parametrize("n,m,S,threads,cluster", [
    (250, 240, 1, 128, 2), (255, 300, 3, 128, 2), (100, 90, 2, 64, 3)])
def test_cluster_route_in_warps_of_larger_ctas(lib, n, m, S, threads,
                                               cluster):
    """CTAs of several warps, a row a thread: each warp takes the unguarded
    form where all its live rows lie inside the domain, the last row of a
    CTA among them, whose values also go to the next CTA's halo."""
    rng = np.random.default_rng(5000 + n + m + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, threads, S,
                       "cluster", cluster)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("n,m,S", [(60, 50, 1), (95, 99, 4), (33, 40, 8),
                                   (7, 30, 2)])
def test_cluster_route_at_its_default_threads(lib, n, m, S, cluster):
    """The threads of models.triplet.cluster_threads: the rows' warps and
    two warps more that store the rows to ys while the others compute
    (the rows' warps do not store)."""
    threads = T.cluster_threads(n, S, cluster)
    assert threads >= -(-T.cluster_rows(n, cluster) // 32) * 32 + 64
    rng = np.random.default_rng(6000 + n + m + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, threads, cluster,
                       "cluster", cluster)


@pytest.mark.parametrize("cluster", (2, 3))
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", [(12, 10, 1), (40, 37, 3),
                                   (20, 21, STATIC_SHIFTS + 1)])
def test_cluster_route_on_tie_heavy_tables(lib, n, m, S, threads, cluster):
    rng = np.random.default_rng(1000 + n + m + S)
    mu1, mu2 = tie_tables(rng, n, m)
    check_against_twin(lib, mu1, mu2, S, -100, 0, threads, 7 * n + S,
                       "cluster", cluster)


@pytest.mark.parametrize("cluster", (2, 4))
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n,m,S", [(20, 23, 2), (50, 47, 1),
                                   (6, 7, STATIC_SHIFTS + 1)])
def test_cluster_route_where_sums_wrap_int32(lib, n, m, S, threads, cluster):
    rng = np.random.default_rng(2000 + n + m + S)
    mu1, mu2 = wrap_tables(rng, n, m)
    got = check_against_twin(lib, mu1, mu2, S, *WRAP_COSTS, threads, S,
                             "cluster", cluster)
    oracle = T.fill_oracle(mu1, mu2, S, *WRAP_COSTS)
    ys = T.oracle_layout(got.numpy(), n, m, S)
    assert not np.array_equal(ys, oracle)      # the int64 oracle differs


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_cluster_route_equals_fill_xla(lib, cluster):
    n, m, S = 40, 33, 2
    mu1, mu2 = _rand_tables(np.random.default_rng(6), n, m)
    got = check_against_twin(lib, mu1, mu2, S, GAMMA, DELTA, 32, 13,
                             "cluster", cluster)
    assert np.array_equal(T.oracle_layout(got.numpy(), n, m, S),
                          J.fill_xla(mu1, mu2, S, GAMMA, DELTA))


def test_cluster_route_refuses_what_cannot_run(lib):
    """Threads beyond a CTA of the route (512), none, no CTA or more than
    16, a CTA's ring beyond its shared memory (the bytes of
    models.triplet.cluster_bytes), and a cluster that the card cannot make
    resident (here: a stand-in card that holds clusters of 2 CTAs at most)
    are refused before any launch: the slabs keep their garbage, and no
    other route runs in its place."""
    mu = T.shared_tables(*[np.zeros((3, 3), np.int32)] * 2, 1, "cpu")[0]
    ys = emu.garbage(np.random.default_rng(0), (5, 3, 3))
    before = ys.clone()

    def entry(n, S, threads, cluster):
        return lib.bialign_triplet_fill_cluster(
            *(ctypes.c_void_p(t.data_ptr()) for t in (ys, mu, mu)),
            *(ctypes.c_int(v) for v in (n, 2, S, 0, 0, threads, cluster, 0)),
            None)

    for n, S, threads, cluster in [(2, 1, 0, 2), (2, 1, 513, 2),
                                   (2, 1, 32, 0), (2, 1, 32, 17),
                                   (6536, 8, 512, 8), (5872, 9, 512, 8)]:
        assert (threads in (0, 513) or cluster in (0, 17)
                or T.cluster_bytes(n, S, cluster, threads) > T.CTA_SHARED_LIMIT)
        assert entry(n, S, threads, cluster) != 0
    lib.host_cluster_limit(2)
    try:
        assert entry(2, 1, 32, 3) == 701       # cudaErrorLaunchOutOfResources
        assert torch.equal(ys, before)
        assert entry(2, 1, 32, 2) == 0         # a cluster it does hold
    finally:
        lib.host_cluster_limit(16)


_EXTERN = re.compile(r'extern "C" int (bialign_\w+)\((.*?)\)\s*\{', re.S)


def test_the_c_signatures_match_the_loader():
    """Every ``extern "C"`` entry of csrc/*.cu has its argtypes in
    ``_build._SIGNATURES``, a pointer for each pointer parameter and an int
    for each int, and every entry there names such a function."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _EXTERN.findall(src.read_text()):
            found[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                           for p in params.split(",")]
    assert {"bialign_triplet_fill", "bialign_triplet_fill_shared",
            "bialign_triplet_fill_cluster"} <= set(found)
    assert found == _build._SIGNATURES
