"""The CUDA source of every kernel, built for the host, against the plain
twins on the seeded cases of ``tests/torch_fuzz_cases.py`` (the generator
of ``chip_smoke.py``'s fuzz phase and of ``tests/test_torch_fuzz.py``,
which holds the twins to the JAX package).

The host stand-in of ``tests/cuda_host/`` (a CTA as std::threads, a
cluster's CTAs and a cooperative launch's all at once, streams run in an
adversarial order, flags delayed at random) runs the sources of the other
``test_torch_*_emulation`` files, here at random costs in [-500, 200] and
the corner sets, uneven shapes with empty sequences and the tile's edges,
random, tie-heavy and int32-edge tables:

- the tile kernels in every mode (K1/K2 band and score-only, K9-K12) and
  the bucket kernels (K4/K5 in both modes, K8 on 1, 2 and B lanes);
- ``cta_scores.cuh`` (K6, K7, K3 "cta"), K3 "grid" and "resident";
- the six walks;
- the split's routes "streams" (stream orders lowest first, highest first,
  at random) and "resident" (delayed CTAs, a CTA's rows drawn) at K = 1-5
  uneven shards;
- the triplet's four routes, "cluster" on 2-8 CTAs, "resident" on 1-5
  CTAs of uneven rows.

The tile kernels' run-time-S form runs at max_shift 5, 8 and 17 affine and
5, 16 and 48 non-affine on rings and bands of garbage.  Tolerance 0 in
every cell: a kernel's memory equals its twin's on the same garbage.
Tier-1 runs toy shapes (n, m <= 12); ``slow`` runs up to 60 and K3 across
its 1024-row boundary.
"""

import dataclasses

import numpy as np
import pytest
import torch
from cuda_host import emulation as emu

import torch_fuzz_cases as F
from test_torch_resident_fills import check_k3, check_triplet
from test_torch_seqsplit_resident import _check_forms
from test_torch_tile_emulation import _host_sources, _rings_of_pairs
from test_torch_triplet_emulation import check_against_twin
from test_torch_walk_emulation import (_batch_walk, _block_walks,
                                       _on_garbage, _twin_out, _unpacked,
                                       _walk)

import bialign_tpu_torch.models.triplet as T
from bialign_tpu_torch.convert import tables_to_torch
from bialign_tpu_torch.ops import checkpoint_dp as ckp
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb
from bialign_tpu_torch.ops.band import DeviceBatchBand
from bialign_tpu_torch.parallel import seqsplit as ss

KINDS = [True, False]
IDS = ["affine", "nonaffine"]
TIER1 = range(1)
SLOW = range(1, 8)
# the run-time-S form of the tile kernels, up to each kind's limit (the
# limits in tier-1)
WIDE_SHIFTS = [pytest.param(True, 5, marks=pytest.mark.slow),
               pytest.param(True, 8, marks=pytest.mark.slow), (True, 17),
               pytest.param(False, 5, marks=pytest.mark.slow),
               pytest.param(False, 16, marks=pytest.mark.slow), (False, 48)]


def _seeds(tier1=TIER1, slow=SLOW):
    return [*tier1, *(pytest.param(s, marks=pytest.mark.slow) for s in slow)]


def _draw(family, seed, offset=0, **kw):
    """The case of seed + ``offset``; tier-1 seeds toy-sized."""
    big = seed not in TIER1
    kw.setdefault("max_shift", 4)
    return F.draw(family, seed + offset, max_len=60 if big else 12,
                  cells=200_000 if big else 20_000,
                  rows=lambda S: cuda_dp.tile_rows(S, family == "affine"),
                  **kw)


# A wait's budget on the stand-in.  The card's is 5 s; here a CTA's
# diagonal runs thousands of times slower (a std::thread a CUDA thread, at
# max_shift 48 a row of 9409 values on 128 of them), and under a loaded
# host a neighbour that is merely slow would trap.  A flag that never
# comes still traps (tests/test_torch_seqsplit_resident.py).
BUDGET_MS, CARD_BUDGET_MS = 600_000, 5_000


@pytest.fixture(scope="module")
def tile_lib(tmp_path_factory):
    work = tmp_path_factory.mktemp("fuzz_tile_host")
    cxx = emu.compiler()
    lib = emu.build(cxx, _host_sources(work / "csrc"),
                    work / "libfuzz_tile.so")
    lib.host_spin_budget_ms(BUDGET_MS)
    yield lib
    lib.host_spin_budget_ms(CARD_BUDGET_MS)


@pytest.fixture(scope="module")
def walk_lib(tmp_path_factory):
    work = tmp_path_factory.mktemp("fuzz_walk_host")
    csrc = emu.copy_csrc(work / "csrc", {"walk.cu": (2, 6)})
    return emu.build(emu.compiler(), [csrc / "walk.cu"],
                     work / "libfuzz_walk.so")


@pytest.fixture(scope="module")
def fills_lib(tmp_path_factory):
    """The triplet's four routes and K3's "resident" (as
    tests/test_torch_resident_fills.py builds them)."""
    work = tmp_path_factory.mktemp("fuzz_fills_host")
    csrc = emu.copy_csrc(work / "csrc", {"triplet.cu": (1, 1),
                                         "tile_diag.cuh": (1, 1),
                                         "cta_scores.cuh": (2, 2),
                                         "score_affine_ms0.cu": (0, 1)})
    lib = emu.build(emu.compiler(), [csrc / "triplet.cu",
                                     csrc / "score_affine_ms0.cu"],
                    work / "libfuzz_fills.so", "-fwrapv")
    lib.host_spin_budget_ms(BUDGET_MS)
    yield lib
    lib.host_flag_delays(0, 0)
    lib.host_spin_budget_ms(CARD_BUDGET_MS)


def _kind(affine):
    return "affine" if affine else "nonaffine"


def _block_size(rng, case):
    """A block size C drawn from 1 to n+m+4 (beyond the band); at the wide
    max_shifts, where every block's twin is slow, the default."""
    D = case.n + case.m + 1
    if case.max_shift > 4:
        return ckp.default_block(D)
    return int(rng.integers(1, D + 4))


def _cells(affine, S):
    return ((9,) if affine else ()) + (2 * S + 1, 2 * S + 1)


# -- the single-pair tile kernels, the walks, the split ------------------------

def _tile_forms(lib, case, affine, rng):
    """K1/K2 band mode on a band of garbage, score-only on a ring of
    garbage, K9/K11 on a ring and checkpoints of garbage, K10/K12 every
    block into a window of garbage; each equal to its twin in every cell.
    Returns the twin's band."""
    n, m, S = case.n, case.m, case.max_shift
    mu1, mu2 = case.tables()
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    kind, params = _kind(affine), case.params(affine)
    consts = cuda_dp._tile_consts(affine, params, S)
    slab = (*_cells(affine, S), n + 1)
    plain = (cuda_dp.fill_affine_plain if affine
             else cuda_dp.fill_nonaffine_plain)(t1, t2, S, *params)
    what = case.tag()

    junk = emu.garbage(rng, (n + m + 1, *slab))
    band = junk.clone()
    emu.call(lib, f"bialign_fill_{kind}", band, t1, t2, consts, n, m, S)
    d = torch.arange(n + m + 1)[:, None]
    i = torch.arange(n + 1)[None, :]
    live = ((i <= d) & (d - i <= m)).reshape(n + m + 1, *[1] * (len(slab) - 1),
                                             n + 1)
    assert torch.equal(band, torch.where(live, plain.ys, junk)), what

    ring = emu.garbage(rng, (3, *slab))
    emu.call(lib, f"bialign_score_{kind}", ring, t1, t2, consts, n, m, S)
    assert torch.equal(ring[(n + m) % 3][..., n], plain.ys[n + m][..., n])

    C = _block_size(rng, case)
    fill_plain, block_plain = (
        (ckp.fill_affine_checkpoint_plain, ckp.affine_block_plain) if affine
        else (ckp.fill_nonaffine_checkpoint_plain, ckp.nonaffine_block_plain))
    blocks = (n + m) // C + 1
    ring = emu.garbage(rng, (3, *slab))
    ckpts = emu.garbage(rng, (blocks, 2, *slab))
    twin = fill_plain(t1, t2, S, *params, block=C, ring=ring.clone(),
                      ckpts=ckpts.clone())
    emu.call(lib, f"bialign_ckpt_{kind}", ring, ckpts, t1, t2, consts, n, m,
             S, C)
    assert torch.equal(ckpts, twin.ckpts), (what, C)
    assert torch.equal(ring[(n + m) % 3], twin.final), (what, C)
    Cw = min(C, n + m + 1)
    for b in range(blocks):
        junk = emu.garbage(rng, twin.window_shape)
        window = junk.clone()
        emu.call(lib, f"bialign_block_{kind}", window,
                 twin.ckpts[b].contiguous(), t1, t2, consts, n, m, S, b * C,
                 Cw)
        assert torch.equal(window, block_plain(twin, b, window=junk)), (
            what, C, b)
    return plain, t1, t2


def _split_streams(lib, case, affine, rng, shards, consts, params):
    """The split's route "streams" (K tile launches a diagonal, a stream a
    shard) in an adversarial stream order: the score-only fill, the
    checkpointed fill and every block, each on garbage equal to its twin."""
    n, m, S = case.n, case.m, case.max_shift
    kind, K = _kind(affine), len(shards)
    cells = _cells(affine, S)
    C = _block_size(rng, case)
    blocks = (n + m) // C + 1
    shards = [dataclasses.replace(s, stream=k + 1)
              for k, s in enumerate(shards)]
    lib.host_stream_order(case.seed % 3 + 1, case.seed)
    try:
        junk = [emu.garbage(rng, (3, *cells, s.rows)) for s in shards]
        rings = [r.clone() for r in junk]
        emu.call_as_is(lib, f"bialign_seqsplit_score_{kind}",
                       ss.shard_table(shards, rings, [None] * K), K, consts,
                       n, m, S)
        assert lib.host_stream_flush() == 0
        twin = ss.seqsplit_last_slabs_plain(shards, S, params, affine,
                                            rings=junk)
        assert all(torch.equal(a, b) for a, b in zip(rings, twin))

        junk = [(emu.garbage(rng, (3, *cells, s.rows)),
                 emu.garbage(rng, (blocks, 2, *cells, s.rows)))
                for s in shards]
        rings = [r.clone() for r, _c in junk]
        ckpts = [c.clone() for _r, c in junk]
        emu.call_as_is(lib, f"bialign_seqsplit_ckpt_{kind}",
                       ss.shard_table(shards, rings, ckpts), K, consts, n, m,
                       S, C)
        assert lib.host_stream_flush() == 0
        t_rings, t_ckpts = ss.seqsplit_checkpoints_plain(
            shards, S, params, affine, C, rings=[r for r, _c in junk],
            ckpts=[c for _r, c in junk])
        for got, want in zip(rings + ckpts, t_rings + t_ckpts):
            assert torch.equal(got, want)

        Cw = min(C, n + m + 1)
        for b in range(blocks):
            junk = [emu.garbage(rng, (Cw + 2, *cells, s.rows))
                    for s in shards]
            parts = [w.clone() for w in junk]
            mine = [c[b] for c in t_ckpts]
            emu.call_as_is(lib, f"bialign_seqsplit_block_{kind}",
                           ss.shard_table(shards, parts, mine), K, consts, n,
                           m, S, b * C, Cw)
            assert lib.host_stream_flush() == 0
            twin = ss.seqsplit_block_plain(shards, S, params, affine, mine,
                                           b * C, Cw, windows=junk)
            assert all(torch.equal(a, b) for a, b in zip(parts, twin))
    finally:
        lib.host_stream_order(0, 0)


def _pair(tile_lib, walk_lib, case, affine, split=True):
    """Every single-pair kernel of the case's kind: the tile kernels, the
    single-pair and block walks, the split on both routes (``split``)."""
    rng = np.random.default_rng([case.seed, 21])
    plain, t1, t2 = _tile_forms(tile_lib, case, affine, rng)
    params, S = case.params(affine), case.max_shift
    band = _on_garbage(plain, rng)
    want = _twin_out(band, affine, params, t1, t2)
    assert _walk(walk_lib, band, params, t1, t2) == want, case.tag()
    C = _block_size(rng, case)
    walk = _block_walks(walk_lib, affine, t1, t2, S, params, C, rng)
    steps = int(walk[ckp.STATE])
    assert walk[ckp.STATE:ckp.STATE + 3 + steps].tolist() == want

    if not split:
        return
    mu1, mu2 = case.tables()
    K = int(rng.integers(1, min(5, case.n + 1) + 1))
    rows = F.uneven_rows(rng, case.n, K)
    shards = ss.make_shards(mu1, mu2, ["cpu"] * K, rows=rows)
    consts = cuda_dp._tile_consts(affine, params, S)
    _split_streams(tile_lib, case, affine, rng, shards, consts, params)
    # a CTA's rows: the route's own (0), or the fewest that keep the grid
    # within what the stand-in's "card" holds at once (4 SMs x 2 CTAs)
    lens = [b - a + 1 for a, b in rows]
    fewest = next(r for r in range(1, max(lens) + 1)
                  if sum(-(-L // r) for L in lens) <= 8)
    cta_rows = int(rng.choice([0, fewest]))
    tile_lib.host_flag_delays(30, case.seed)
    try:
        _check_forms(tile_lib, shards, S, affine, consts, params, rng,
                     rows=cta_rows)
    finally:
        tile_lib.host_flag_delays(0, 0)


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", _seeds())
def test_single_pair_kernels_equal_the_twins(tile_lib, walk_lib, seed,
                                             affine):
    _pair(tile_lib, walk_lib, _draw(_kind(affine), seed), affine)


@pytest.mark.parametrize("affine,S", WIDE_SHIFTS,
                         ids=["affine-5", "affine-8", "affine-17",
                              "nonaffine-5", "nonaffine-16", "nonaffine-48"])
def test_run_time_shift_form_equals_the_twins(tile_lib, walk_lib, affine, S):
    """The tile kernels' form with S read at run time (one row a CTA), at
    max_shift 5 up to each kind's limit, on toy shapes: the single-pair
    kernels and walks (the split's, whose twins take longest, under
    `slow`)."""
    _pair(tile_lib, walk_lib, F.at_limit(_kind(affine), S, max_len=4,
                                         max_shift=S), affine, split=False)


@pytest.mark.slow
@pytest.mark.parametrize("affine,S", [(True, 5), (True, 17), (False, 5),
                                      (False, 48)],
                         ids=["affine-5", "affine-17", "nonaffine-5",
                              "nonaffine-48"])
def test_run_time_shift_form_in_the_split(tile_lib, walk_lib, affine, S):
    _pair(tile_lib, walk_lib, F.at_limit(_kind(affine), 10 + S, max_len=5,
                                         max_shift=S), affine)


# -- the buckets ---------------------------------------------------------------

def _stacks(case, rng, pairs):
    N, M = max(case.n, 1), max(case.m, 1)
    lengths = F.mixed_bucket(rng, N, M, pairs)
    tables = [F.draw_tables(rng, n, m, case.table_kind, case.costs)
              for n, m in lengths]
    stacks = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        np.stack([np.pad(t[0], ((0, N - t[0].shape[0] + 1),
                                (0, M - t[0].shape[1] + 1)))
                  for t in tables]),
        np.stack([np.pad(t[1], ((0, N - t[1].shape[0] + 1),
                                (0, M - t[1].shape[1] + 1)))
                  for t in tables]),
        np.array([n for n, _m in lengths], np.int32),
        np.array([m for _n, m in lengths], np.int32)))
    return stacks, N, M


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", _seeds(range(2), range(2, 8)))
def test_bucket_kernels_equal_the_twins(tile_lib, walk_lib, seed, affine):
    """K4/K5 in score mode on rings of garbage and in band mode on bands of
    garbage, K8 on 1, 2 and B lanes, K6 (K7 at affine max_shift 0) where a
    pair fits one CTA, and the batch walks over the band: each equal to
    its twin (the rings K6/K7 leave to the single-pair twins' on the same
    garbage).  Tier-1: three pairs at max_shift <= 2, K6 on 32 threads
    (each launch here starts a std::thread a CUDA thread: a tile of the
    run-time-S form is a CTA a row); `slow`: 3-6 pairs at max_shift up to
    4 and, one seed in four, up to the kind's limit, K6 also on its own
    threads (one a value, up to 1024)."""
    small = seed < 2
    case = _draw(_kind(affine), seed, 100,
                 max_shift=(2 if small else F.LIMITS[_kind(affine)]
                            if seed % 4 == 3 else 4))
    rng = np.random.default_rng([seed, 23])
    stacks, N, M = _stacks(case, rng, 3 if small else
                           int(rng.integers(3, 7)))
    B = stacks[0].shape[0]
    S, params, kind = case.max_shift, case.params(affine), _kind(affine)
    consts = cuda_dp._tile_consts(affine, params, S)
    cells = _cells(affine, S)
    scores_plain, bands_plain, walk_plain = (
        (cuda_dp.affine_batch_scores_plain, cuda_dp.affine_batch_bands_plain,
         dtb.affine_walk_batch_plain) if affine else
        (cuda_dp.nonaffine_batch_scores_plain,
         cuda_dp.nonaffine_batch_bands_plain, dtb.nonaffine_walk_batch_plain))
    want = scores_plain(*stacks, S, *params)

    out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
    ring = emu.garbage(rng, (B, 3, *cells, N + 1))
    emu.call(tile_lib, f"bialign_batch_{kind}", ring, out, *stacks, consts,
             B, N, M, S, N + M)
    assert torch.equal(out, want), case.tag()

    d_max = int((stacks[2] + stacks[3]).max())
    junk = emu.garbage(rng, (B, d_max + 1, *cells, N + 1))
    band = junk.clone()
    out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
    emu.call(tile_lib, f"bialign_batch_fill_{kind}", band, out, *stacks,
             consts, B, N, M, S, d_max)
    twin, twin_scores = bands_plain(*stacks, S, *params, d_max=d_max,
                                    band=junk)
    assert torch.equal(band, twin.ys) and torch.equal(out, twin_scores)
    bband = DeviceBatchBand(ys=band, ns=stacks[2], ms=stacks[3],
                            max_shift=S, affine=affine)
    assert _unpacked(_batch_walk(walk_lib, bband, params, *stacks[:2])) == \
        _unpacked(walk_plain(twin, *params, *stacks[:2]))

    for lanes in sorted({1, 2, B}):
        out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
        ring = emu.garbage(rng, (lanes, 3, *cells, N + 1))
        emu.call(tile_lib, f"bialign_conveyor_{kind}", ring, out, *stacks,
                 consts, B, N, M, S, lanes, cuda_dp.conveyor_T0(M), N + M)
        assert torch.equal(out, want), lanes

    if not cuda_dp.cta_fits(N, S, affine):
        return
    ms0 = affine and S == 0
    if ms0:
        def ring_plain(mu1, mu2, ring):
            cuda_dp.affine_ms0_last_slab_plain(mu1, mu2, *params, ring=ring)
    else:
        last = (cuda_dp.affine_last_slab_plain if affine
                else cuda_dp.nonaffine_last_slab_plain)

        def ring_plain(mu1, mu2, ring):
            last(mu1, mu2, S, *params, ring=ring)
    for threads in (32,) if small else (0, 32):
        out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
        junk = emu.garbage(rng, (B, 3, *((3,) if ms0 else cells), N + 1))
        ring = junk.clone()
        if ms0:
            emu.call(tile_lib, "bialign_cta_affine_ms0", ring, out, *stacks,
                     cuda_dp.ms0_kernel_consts(*params), B, N, M, threads)
        else:
            emu.call(tile_lib, f"bialign_cta_{kind}", ring, out, *stacks,
                     cuda_dp._kernel_consts(affine, params), B, N, M, S,
                     threads)
        assert torch.equal(out, want), threads
        assert torch.equal(ring, _rings_of_pairs(stacks, junk, ring_plain,
                                                 -1)), threads


# -- K3 ------------------------------------------------------------------------

def _k3(tile_lib, fills_lib, n, m, case, seed):
    """K3 on its routes "cta" (where n+1 fits one CTA), "grid" and
    "resident" (1-4 CTAs, the default threads and 32), each ring equal to
    the twin's on the same garbage."""
    rng = np.random.default_rng([seed, 29])
    mu1, mu2 = F.draw_tables(rng, n, m, case.table_kind, case.costs)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    consts = cuda_dp.ms0_kernel_consts(*case.costs)
    junk = emu.garbage(rng, (3, 3, n + 1))
    twin = junk.clone()
    cuda_dp.affine_ms0_last_slab_plain(t1, t2, *case.costs, ring=twin)
    names = ["bialign_score_affine_ms0_grid"]
    if cuda_dp.cta_fits(n, 0, True):
        names.append("bialign_score_affine_ms0")
    for name in names:
        ring = junk.clone()
        emu.call(tile_lib, name, ring, t1, t2, consts, n, m)
        assert torch.equal(ring, twin), (name, case.tag())
    ctas = int(rng.integers(1, 5))
    check_k3(fills_lib, mu1, mu2, case.costs, ctas, 0, seed)
    if -(-(n + 1) // ctas) <= 4 * 32:
        check_k3(fills_lib, mu1, mu2, case.costs, ctas, 32, seed + 1)


@pytest.mark.parametrize("seed", _seeds())
def test_k3_routes_equal_the_twin(tile_lib, fills_lib, seed):
    case = _draw("ms0", seed)
    _k3(tile_lib, fills_lib, case.n, case.m, case, seed)


@pytest.mark.slow
@pytest.mark.parametrize("rows", [F.MS0_RESIDENT_ROWS - 1,
                                  F.MS0_RESIDENT_ROWS,
                                  F.MS0_RESIDENT_ROWS + 1])
def test_k3_across_its_resident_boundary(tile_lib, fills_lib, rows):
    """K3 at 1023-1025 rows, where its own route turns "resident"."""
    case = _draw("ms0", 50 + rows)
    assert cuda_dp.batch_route(rows - 1, 0, True, B=1) == (
        "cta" if rows < F.MS0_RESIDENT_ROWS else "resident")
    _k3(tile_lib, fills_lib, rows - 1, max(case.m % 20, 1), case, rows)


# -- the triplet ---------------------------------------------------------------

@pytest.mark.parametrize("seed", _seeds(range(3), range(3, 8)))
def test_triplet_routes_equal_the_twin(fills_lib, seed):
    """Routes "global" and "shared" at 32 and 48 threads, "cluster" on 2-8
    CTAs and "resident" on 1-5 CTAs (rows they do not divide, CTAs without
    rows), each on slabs of garbage: the twin's values on the domain, the
    garbage kept elsewhere.  The tier-1 seeds sit at max_shift 8, 9 and 16,
    across the routes' boundary."""
    if seed < 3:
        case = F.at_limit("triplet", seed, max_len=12,
                          max_shift=(8, 9, 16)[seed])
    else:
        case = F.draw("triplet", seed, max_len=60, max_shift=16,
                      cells=100_000)
    mu1, mu2 = case.tables()
    S = case.max_shift
    gamma, delta = case.params(False)
    rng = np.random.default_rng([seed, 31])
    for threads in (32, 48):
        for route in ("global", "shared"):
            if route == "shared" and T.triplet_route(case.n, S,
                                                     threads) != "shared":
                continue
            check_against_twin(fills_lib, mu1, mu2, S, gamma, delta, threads,
                               seed, route)
    cluster = 2 + seed % 7
    check_against_twin(fills_lib, mu1, mu2, S, gamma, delta,
                       int(rng.choice([32, 48])), seed, "cluster", cluster)
    check_triplet(fills_lib, mu1, mu2, S, gamma, delta,
                  int(rng.integers(1, 6)), int(rng.choice([32, 48])), seed)
