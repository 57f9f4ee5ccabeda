"""The sequence split's route "resident", its CUDA source built for the host
and run on the CPU.

``bialign_tpu_torch/csrc/seqsplit.cu`` route "resident" (one cooperative
launch a card, each CTA its own rows of one shard walking every diagonal,
progress flags between neighbouring CTAs, the halo pulled by a shard's
first CTA) runs only on the card, where ``chip_smoke.py`` holds it to its
plain twins.  Here the same source is built with the host's C++20 compiler
against ``tests/cuda_host/``: a cooperative launch runs all its CTAs at
once as std::threads, each with a shared buffer of its own, in a thread of
its own (so that launches on two "cards" run side by side); a flag's
acquire load and release store are ``std::atomic_ref`` operations of those
orders (``tests/cuda_host/neighbour_flags.cuh``), and a seeded policy
delays random CTAs at their waits and stores.  Every entry point, affine
and non-affine, then has to equal its twin
(``parallel/seqsplit.py`` ``seqsplit_*_plain``) in every cell, slot 0
included, on rings, checkpoints and windows of garbage: K = 1, 2 and 3
(a shard of one row at each end, shorter than every tile), a CTA's rows at
the default (a tile) and at several tiles or a few rows (CTAs owning
several tiles, CTAs with no live row for whole diagonals), max_shift 0-4,
every block.  Also: shards on two "cards" in one call, a flag that never
comes (the wait's budget traps and the fault word names the CTA), and a
grid the card cannot hold (refused).  This checks the route's indexing,
waits and halo; it says nothing of its speed and does not replace the
card's check (the stand-in cannot see a missing fence: its barrier and
atomics order memory by themselves).
"""

import ctypes

import numpy as np
import pytest
import torch
from cuda_host import emulation as emu

from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.parallel import seqsplit as ss

AFFINE_PARAMS, NONAFFINE_PARAMS = (-150, -50, -150), (-200, -250)
# (n, m, max_shift): chip_smoke.py's SPLIT_SHAPES
SHAPES = [(5, 7, 1), (17, 20, 1), (8, 8, 2), (7, 9, 0), (9, 10, 3),
          (9, 11, 4), (0, 5, 1), (6, 0, 2)]
BLOCK = 3
LAUNCH_FAILURE, TOO_LARGE = 719, 720


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = emu.compiler()
    work = tmp_path_factory.mktemp("resident_host")
    csrc = emu.copy_csrc(work / "csrc", {"tile_diag.cuh": (1, 1),
                                         "seqsplit.cu": (1, 0)})
    lib = emu.build(cxx, [csrc / "seqsplit.cu"], work / "libresident.so")
    yield lib
    lib.host_flag_delays(0, 0)


def _tables(n: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    return mu1, mu2, rng


def _splits(n: int, R: int) -> list:
    """(row ranges, a CTA's rows) of the runs: K = 1 at the default rows (a
    tile) and at two tiles; K = 2 (even) at a few rows (several CTAs to a
    shard, fewer rows than a tile where R > 3); K = 3 (a shard of one row
    at each end) at the default."""
    splits = [([(0, n)], 0), ([(0, n)], 2 * R)]
    if n >= 1:
        splits.append(([(0, n // 2), (n // 2 + 1, n)], -(-(n + 1) // 6)))
    if n >= 2:
        splits.append(([(0, 0), (1, n - 1), (n, n)], 0))
    return splits


def _resident(lib, name, shards, slabs, extras, *ints, rows=0,
              devices=None, fault=None):
    """The route "resident" entry ``name`` on the stand-in, waited for;
    ``devices``: each shard's "card" (default all 0)."""
    flags = ss.flag_memory(shards)     # alive until the launch has ended
    table = ss.shard_table(shards, slabs, extras, flags=flags, rows=rows,
                           fault=fault)
    if devices is not None:
        table[:, 6] = torch.tensor(devices)
    emu.call_as_is(lib, name, table, len(shards), *ints)
    return lib.host_synchronize()


def _check_forms(lib, shards, S, affine, consts, params, rng, rows=0,
                 devices=None):
    """The three forms on garbage against their twins on the same garbage,
    every cell; every block of the checkpointed fill."""
    n, m = shards[-1].b, shards[0].mu1.shape[1] - 1
    K = len(shards)
    kind = "affine" if affine else "nonaffine"
    cells = ((9,) if affine else ()) + (2 * S + 1, 2 * S + 1)
    blocks = (n + m) // BLOCK + 1
    C = min(BLOCK, n + m + 1)
    what = (K, rows, devices)

    junk = [emu.garbage(rng, (3, *cells, s.rows)) for s in shards]
    rings = [r.clone() for r in junk]
    assert _resident(lib, f"bialign_seqsplit_resident_score_{kind}", shards,
                     rings, [None] * K, consts, n, m, S, rows=rows,
                     devices=devices) == 0
    twin = ss.seqsplit_last_slabs_plain(shards, S, params, affine,
                                        rings=[r.clone() for r in junk])
    for got, want in zip(rings, twin):
        assert torch.equal(got, want), what

    junk = [(emu.garbage(rng, (3, *cells, s.rows)),
             emu.garbage(rng, (blocks, 2, *cells, s.rows))) for s in shards]
    rings = [r.clone() for r, _c in junk]
    ckpts = [c.clone() for _r, c in junk]
    assert _resident(lib, f"bialign_seqsplit_resident_ckpt_{kind}", shards,
                     rings, ckpts, consts, n, m, S, BLOCK, rows=rows,
                     devices=devices) == 0
    t_rings, t_ckpts = ss.seqsplit_checkpoints_plain(
        shards, S, params, affine, BLOCK,
        rings=[r.clone() for r, _c in junk],
        ckpts=[c.clone() for _r, c in junk])
    for got, want in zip(rings + ckpts, t_rings + t_ckpts):
        assert torch.equal(got, want), what

    for b in range(blocks):
        junk = [emu.garbage(rng, (C + 2, *cells, s.rows)) for s in shards]
        parts = [w.clone() for w in junk]
        mine = [c[b] for c in t_ckpts]
        assert _resident(lib, f"bialign_seqsplit_resident_block_{kind}",
                         shards, parts, mine, consts, n, m, S, b * BLOCK, C,
                         rows=rows, devices=devices) == 0
        twin = ss.seqsplit_block_plain(shards, S, params, affine, mine,
                                       b * BLOCK, C,
                                       windows=[w.clone() for w in junk])
        for got, want in zip(parts, twin):
            assert torch.equal(got, want), (*what, b)


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
@pytest.mark.parametrize("n,m,S", SHAPES)
def test_resident_entries_equal_the_twins(lib, n, m, S, affine):
    """The three forms at K = 1, 2, 3 and each CTA size, under delayed
    CTAs, every cell equal to the twins'."""
    mu1, mu2, rng = _tables(n, m, 11 * n + 5 * m + S)
    params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
    consts = cuda_dp._tile_consts(affine, params, S)
    R = cuda_dp.TILE_ROWS[0 if affine else 1][S] if S <= 3 else 1
    for ranges, rows in _splits(n, R):
        K = len(ranges)
        shards = ss.make_shards(mu1, mu2, ["cpu"] * K, rows=ranges)
        lib.host_flag_delays(30, 1000 * n + 10 * K + rows)
        try:
            _check_forms(lib, shards, S, affine, consts, params, rng,
                         rows=rows)
        finally:
            lib.host_flag_delays(0, 0)


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
def test_resident_across_two_cards(lib, affine):
    """Shards on "cards" 0, 1, 0: two launches side by side, the flags and
    halo between them, equal to the twins."""
    n, m, S = 11, 13, 1
    mu1, mu2, rng = _tables(n, m, 77)
    params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
    consts = cuda_dp._tile_consts(affine, params, S)
    shards = ss.make_shards(mu1, mu2, ["cpu"] * 3,
                            rows=[(0, 3), (4, 8), (9, 11)])
    lib.host_flag_delays(30, 5)
    try:
        _check_forms(lib, shards, S, affine, consts, params, rng, rows=2,
                     devices=[0, 1, 0])
    finally:
        lib.host_flag_delays(0, 0)


def test_a_flag_that_never_comes_traps(lib):
    """CTA 1 stops publishing after its third diagonal: its neighbours'
    waits run out of budget (and, in turn, theirs), the launch fails, and
    the fault word names one of the 4 CTAs and a diagonal; the next call
    runs again."""
    n, m, S = 9, 10, 1
    mu1, mu2, rng = _tables(n, m, 3)
    consts = cuda_dp._tile_consts(True, AFFINE_PARAMS, S)
    shards = ss.make_shards(mu1, mu2, ["cpu"] * 2, rows=[(0, 4), (5, 9)])
    rings = [emu.garbage(rng, (3, 9, 3, 3, s.rows)) for s in shards]
    fault = torch.zeros(4, dtype=torch.int32)
    lib.host_spin_budget_ms(300)
    lib.host_flag_drop(1, 4)
    try:
        got = _resident(lib, "bialign_seqsplit_resident_score_affine",
                        shards, rings, [None] * 2, consts, n, m, S, rows=3,
                        fault=fault)
    finally:
        lib.host_flag_drop(-1, 0)
        lib.host_spin_budget_ms(5000)
    assert got == LAUNCH_FAILURE
    assert fault[0] == 1 and 0 <= fault[1] < 4 and fault[3] in (1, 2)
    assert 3 <= fault[2] <= n + m + 1
    _check_forms(lib, shards, S, True, consts, AFFINE_PARAMS, rng, rows=3)


def test_a_grid_the_card_cannot_hold_is_refused(lib):
    """On a "card" of one SM holding two CTAs: a forced rows whose grid
    is larger is refused before anything runs (the rings keep their
    garbage); the default rows fit it."""
    n, m, S = 9, 10, 1
    mu1, mu2, rng = _tables(n, m, 4)
    consts = cuda_dp._tile_consts(True, AFFINE_PARAMS, S)
    shards = ss.make_shards(mu1, mu2, ["cpu"] * 2, rows=[(0, 4), (5, 9)])
    lib.host_resident(1, 2)
    try:
        rings = [emu.garbage(rng, (3, 9, 3, 3, s.rows)) for s in shards]
        before = [r.clone() for r in rings]
        table = ss.shard_table(shards, rings, [None] * 2,
                               flags=ss.flag_memory(shards), rows=2)
        err = lib.bialign_seqsplit_resident_score_affine(
            ctypes.c_void_p(table.data_ptr()), ctypes.c_int(2),
            ctypes.c_void_p(consts.data_ptr()),
            *[ctypes.c_int(v) for v in (n, m, S)])
        assert err == TOO_LARGE
        assert lib.host_synchronize() == 0
        assert all(torch.equal(a, b) for a, b in zip(rings, before))
        _check_forms(lib, shards, S, True, consts, AFFINE_PARAMS, rng)
    finally:
        lib.host_resident(4, 2)
