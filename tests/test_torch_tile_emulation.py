"""The tile kernels' CUDA source, built for the host and run on the CPU.

The kernels of K1, K2 and K9-K12 (``bialign_tpu_torch/csrc/tile_diag.cuh``
and the entry points that launch it), the bucket kernels over its
device function, K4/K5 (``csrc/batch_diag.cuh``, score and band mode) and
K8 (``csrc/conveyor.cuh``), and the one-CTA-a-pair kernel over its
per-value functions (``csrc/cta_scores.cuh``: K6, and K7 and K3 with the
max_shift 0 recurrence of ``csrc/affine_ms0_diag.cuh``, which also holds
K3's per-diagonal kernel) run only on the card, where ``chip_smoke.py``
holds them to their plain twins.  Here the same source is built with the
host's C++20 compiler against ``tests/cuda_host/``, a stand-in for the few
runtime pieces it uses (a CTA as std::threads meeting at a std::barrier for
each ``__syncthreads()``), with two mechanical rewrites: each kernel's
``extern __shared__`` buffer and its ``<<<...>>>`` launch.  It then has to
equal the twins in every cell: bands and windows of garbage keep their
garbage off the live rows, rings of garbage give the twins' last slab and
scores, checkpoints the twins' slabs.  A CTA's thread count is an argument
of the one-CTA kernels, so they also run here on fewer threads than values
(strides of the CTA).  This checks the kernels' indexing,
staging and phases on the CPU; it says nothing of their speed, and it does
not replace the card's check.

The sequence split's entry points (``csrc/seqsplit.cu``: the tile kernel
in its row-shard form under one host loop, a stream a shard, the halo
copied between events) run here with each shard's stream a queue that the
stand-in runs in an order of its choosing (``host_stream_order``: the
lowest stream first, the highest first, or at random), so that a missing
event between two shards shows as a wrong value.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from cuda_host import emulation as emu

import dataclasses

from bialign_tpu_torch.convert import tables_to_torch
from bialign_tpu_torch.ops import checkpoint_dp as ckp
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.parallel import seqsplit as ss

AFFINE_PARAMS, NONAFFINE_PARAMS = (-150, -50, -150), (-200, -250)
# tile edges (the live rows of a middle diagonal around R = 8 at affine
# max_shift 1, 16 non-affine; R = 2 and 4 at max_shift 3), max_shift 0, 2,
# the run-time form at 4, and empty sequences
SHAPES = [(0, 4, 1), (7, 10, 1), (8, 11, 1), (16, 19, 1), (5, 7, 0),
          (8, 8, 2), (2, 5, 3), (4, 7, 3), (5, 6, 4), (6, 0, 2)]
BLOCK = 3


# the files that hold a kernel and its launch, with their count of dynamic
# shared buffers and of launches, and the entry points' headers: a source
# that includes one of them is built
KERNEL_FILES = {"tile_diag.cuh": (1, 1), "batch_diag.cuh": (1, 1),
                "conveyor.cuh": (1, 1), "cta_scores.cuh": (2, 2),
                "score_affine_ms0.cu": (0, 1), "seqsplit.cu": (1, 0)}
ENTRY_HEADERS = ("tile_diag", "ckpt_diag", "batch_diag", "conveyor",
                 "cta_scores")


def _host_sources(dst: Path) -> list:
    """csrc copied to ``dst`` with the two rewrites in every kernel's file;
    the sources that launch a kernel of those files."""
    emu.copy_csrc(dst, KERNEL_FILES)
    pattern = r'#include "(%s)\.cuh"' % "|".join(ENTRY_HEADERS)
    return sorted(p for p in dst.glob("*.cu")
                  if re.search(pattern, p.read_text()))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = emu.compiler()
    work = tmp_path_factory.mktemp("tile_host")
    sources = _host_sources(work / "csrc")
    assert len(sources) == 15, [p.name for p in sources]
    return emu.build(cxx, sources, work / "libtile_host.so")


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
@pytest.mark.parametrize("n,m,S", SHAPES)
def test_tile_kernels_equal_the_twins(lib, n, m, S, affine):
    rng = np.random.default_rng(100 * n + 10 * m + S)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    kind = "affine" if affine else "nonaffine"
    params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
    consts = cuda_dp._tile_consts(affine, params, S)
    slab = ((9,) if affine else ()) + (2 * S + 1, 2 * S + 1, n + 1)
    plain = (cuda_dp.fill_affine_plain if affine
             else cuda_dp.fill_nonaffine_plain)(t1, t2, S, *params)

    # K1 / K2 band mode on a band of garbage: the live rows, nothing else
    junk = emu.garbage(rng, (n + m + 1, *slab))
    band = junk.clone()
    emu.call(lib, f"bialign_fill_{kind}", band, t1, t2, consts, n, m, S)
    d = torch.arange(n + m + 1)[:, None]
    i = torch.arange(n + 1)[None, :]
    live = ((i <= d) & (d - i <= m)).reshape(n + m + 1, *[1] * (len(slab) - 1),
                                             n + 1)
    assert torch.equal(band, torch.where(live, plain.ys, junk))

    # score-only on a ring of garbage: the last slab's live row
    ring = emu.garbage(rng, (3, *slab))
    emu.call(lib, f"bialign_score_{kind}", ring, t1, t2, consts, n, m, S)
    assert torch.equal(ring[(n + m) % 3][..., n], plain.ys[n + m][..., n])

    # K9 / K11 on a ring and checkpoints of garbage, against the twin on
    # the same garbage; K10 / K12 every block into a window of garbage
    fill_plain, block_plain = (
        (ckp.fill_affine_checkpoint_plain, ckp.affine_block_plain) if affine
        else (ckp.fill_nonaffine_checkpoint_plain, ckp.nonaffine_block_plain))
    blocks = (n + m) // BLOCK + 1
    ring, ckpts = emu.garbage(rng, (3, *slab)), emu.garbage(rng, (blocks, 2, *slab))
    twin = fill_plain(t1, t2, S, *params, block=BLOCK, ring=ring.clone(),
                      ckpts=ckpts.clone())
    emu.call(lib, f"bialign_ckpt_{kind}", ring, ckpts, t1, t2, consts, n, m, S,
          BLOCK)
    assert torch.equal(ckpts, twin.ckpts)
    assert torch.equal(ring[(n + m) % 3], twin.final)
    for b in range(blocks):
        junk = emu.garbage(rng, twin.window_shape)
        window = junk.clone()
        emu.call(lib, f"bialign_block_{kind}", window, twin.ckpts[b].contiguous(),
              t1, t2, consts, n, m, S, b * BLOCK, BLOCK)
        assert torch.equal(window, block_plain(twin, b, window=junk)), b


def _row_splits(n: int) -> list:
    """(K, row ranges, stream order) of the split runs: one shard; two even
    ones, the receiving shard's stream run first (a halo read before it is
    written would show); three with a shard of one row at each end (shorter
    than every tile's R rows), the sending shard's stream run first (a
    ring slab overwritten before its halo is copied out would show)."""
    splits = [(1, [(0, n)], 3)]
    if n >= 1:
        splits.append((2, [(0, n // 2), (n // 2 + 1, n)], 2))
    if n >= 2:
        splits.append((3, [(0, 0), (1, n - 1), (n, n)], 1))
    return splits


def _live(n: int, m: int, d: int) -> slice:
    return slice(max(0, d - m), min(n, d) + 1)


def _gather(parts) -> torch.Tensor:
    """Each shard's own rows (slots 1..) put together."""
    return torch.cat([p[..., 1:] for p in parts], dim=-1)


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
@pytest.mark.parametrize("n,m,S", SHAPES)
def test_seqsplit_kernels_equal_the_twins(lib, n, m, S, affine):
    """The split's three entry points at K = 1, 2, 3, their streams run in
    an adversarial order: the score-only fill on rings of garbage, the
    checkpointed fill on rings and checkpoints of garbage, and every block
    into windows of garbage, each equal in every cell to its twin on the
    same garbage, and on every live row to the unsharded kernels (K1/K2
    score-only, K9-K12) of the same source."""
    rng = np.random.default_rng(7 * n + 3 * m + S)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    kind = "affine" if affine else "nonaffine"
    params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
    consts = cuda_dp._tile_consts(affine, params, S)
    cells = ((9,) if affine else ()) + (2 * S + 1, 2 * S + 1)
    blocks = (n + m) // BLOCK + 1
    C = min(BLOCK, n + m + 1)

    # the unsharded kernels of the same source
    ring = emu.garbage(rng, (3, *cells, n + 1))
    emu.call(lib, f"bialign_score_{kind}", ring, t1, t2, consts, n, m, S)
    score_slab = ring[(n + m) % 3][..., n]
    ring = emu.garbage(rng, (3, *cells, n + 1))
    whole = emu.garbage(rng, (blocks, 2, *cells, n + 1))
    emu.call(lib, f"bialign_ckpt_{kind}", ring, whole, t1, t2, consts, n, m,
             S, BLOCK)
    windows = []
    for b in range(blocks):
        window = emu.garbage(rng, (C + 2, *cells, n + 1))
        emu.call(lib, f"bialign_block_{kind}", window,
                 whole[b].contiguous(), t1, t2, consts, n, m, S, b * BLOCK, C)
        windows.append(window)

    for K, rows, order in _row_splits(n):
        shards = [dataclasses.replace(s, stream=k + 1) for k, s in enumerate(
            ss.make_shards(mu1, mu2, ["cpu"] * K, rows=rows))]
        lib.host_stream_order(order, 100 * n + K)
        try:
            # the score-only fill
            junk = [emu.garbage(rng, (3, *cells, s.rows)) for s in shards]
            rings = [r.clone() for r in junk]
            emu.call_as_is(lib, f"bialign_seqsplit_score_{kind}",
                           ss.shard_table(shards, rings, [None] * K), K,
                           consts, n, m, S)
            assert lib.host_stream_flush() == 0
            twin = ss.seqsplit_last_slabs_plain(
                shards, S, params, affine, rings=[r.clone() for r in junk])
            for got, want in zip(rings, twin):
                assert torch.equal(got, want), (K, order)
            last = shards[-1]
            assert torch.equal(rings[-1][(n + m) % 3][..., n - last.a + 1],
                               score_slab)

            # the checkpointed fill
            junk = [(emu.garbage(rng, (3, *cells, s.rows)),
                     emu.garbage(rng, (blocks, 2, *cells, s.rows)))
                    for s in shards]
            rings = [r.clone() for r, _c in junk]
            ckpts = [c.clone() for _r, c in junk]
            emu.call_as_is(lib, f"bialign_seqsplit_ckpt_{kind}",
                           ss.shard_table(shards, rings, ckpts), K, consts,
                           n, m, S, BLOCK)
            assert lib.host_stream_flush() == 0
            t_rings, t_ckpts = ss.seqsplit_checkpoints_plain(
                shards, S, params, affine, BLOCK,
                rings=[r.clone() for r, _c in junk],
                ckpts=[c.clone() for _r, c in junk])
            for got, want in zip(rings + ckpts, t_rings + t_ckpts):
                assert torch.equal(got, want), (K, order)
            for b in range(1, blocks):
                for x in (0, 1):
                    live = _live(n, m, b * BLOCK - 1 - x)
                    assert torch.equal(
                        _gather([c[b, x] for c in ckpts])[..., live],
                        whole[b, x][..., live]), (K, order, b, x)

            # every block, from the split checkpoints
            for b in range(blocks):
                junk = [emu.garbage(rng, (C + 2, *cells, s.rows))
                        for s in shards]
                parts = [w.clone() for w in junk]
                mine = [c[b] for c in ckpts]
                emu.call_as_is(lib, f"bialign_seqsplit_block_{kind}",
                               ss.shard_table(shards, parts, mine), K,
                               consts, n, m, S, b * BLOCK, C)
                assert lib.host_stream_flush() == 0
                twin = ss.seqsplit_block_plain(
                    shards, S, params, affine, mine, b * BLOCK, C,
                    windows=[w.clone() for w in junk])
                for got, want in zip(parts, twin):
                    assert torch.equal(got, want), (K, order, b)
                for x in range(C + 2):
                    d = b * BLOCK - 2 + x
                    if 0 <= d <= n + m and (x >= 2 or b):
                        live = _live(n, m, d)
                        assert torch.equal(
                            _gather([p[x] for p in parts])[..., live],
                            windows[b][x][..., live]), (K, order, b, x)
        finally:
            lib.host_stream_order(0, 0)


def _bucket(affine: bool, S: int, seed: int):
    """A bucket at the tile's edges for max_shift S: pairs whose widest live
    range is R - 1, R and R + 1 rows, an empty first and an empty second
    sequence, and (third) a pair whose first length lies outside the bucket.
    Returns (stacks with the valid pairs only, the same with the outside
    pair inserted, its index, N, M)."""
    R = cuda_dp.TILE_ROWS[0 if affine else 1][S] if S <= 3 else 1
    N, M = R + 1, R + 2
    lengths = [(max(R - 2, 0), R + 2), (R - 1, R), (R + 1, R), (0, M),
               (N, 0)]
    rng = np.random.default_rng(seed)
    mu1 = np.zeros((len(lengths), N + 1, M + 1), np.int32)
    mu2 = np.zeros_like(mu1)
    for b, (n, m) in enumerate(lengths):
        mu1[b, 1:n + 1, 1:m + 1] = rng.integers(-4, 9, size=(n, m)) * 100
        mu2[b, 1:n + 1, 1:m + 1] = rng.integers(-4, 9, size=(n, m)) * 100
    ns = np.array([n for n, _m in lengths], np.int32)
    ms = np.array([m for _n, m in lengths], np.int32)
    valid = tuple(torch.from_numpy(a) for a in (mu1, mu2, ns, ms))
    out_at = 2
    with_out = (np.insert(mu1, out_at, 7, axis=0),
                np.insert(mu2, out_at, 7, axis=0),
                np.insert(ns, out_at, N + 3), np.insert(ms, out_at, 1))
    return valid, tuple(torch.from_numpy(np.ascontiguousarray(a))
                        for a in with_out), out_at, N, M


def _without(t: torch.Tensor, b: int) -> torch.Tensor:
    return torch.cat([t[:b], t[b + 1:]])


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
@pytest.mark.parametrize("S", [0, 1, 2, 3, 4])
def test_bucket_kernels_equal_the_twins(lib, S, affine):
    """K4 / K5 in score mode on rings of garbage and in band mode on bands
    of garbage, to the pairs' last diagonal and to the bucket's N + M: the
    twins' scores and, cell for cell, their bands; the pair outside the
    bucket keeps the score the wrapper set and its band's garbage."""
    valid, stacks, out_at, N, M = _bucket(affine, S, 10 * S + affine)
    rng = np.random.default_rng(S)
    kind = "affine" if affine else "nonaffine"
    params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
    consts = cuda_dp._tile_consts(affine, params, S)
    cells = ((9,) if affine else ()) + (2 * S + 1, 2 * S + 1)
    B = stacks[0].shape[0]
    scores_plain, bands_plain = (
        (cuda_dp.affine_batch_scores_plain, cuda_dp.affine_batch_bands_plain)
        if affine else (cuda_dp.nonaffine_batch_scores_plain,
                        cuda_dp.nonaffine_batch_bands_plain))
    want = scores_plain(*valid, S, *params)
    sentinel = torch.tensor([-12345], dtype=torch.int32)

    out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
    out[out_at] = sentinel
    ring = emu.garbage(rng, (B, 3, *cells, N + 1))
    emu.call(lib, f"bialign_batch_{kind}", ring, out, *stacks, consts, B, N, M,
          S, N + M)
    assert torch.equal(_without(out, out_at), want)
    assert out[out_at] == sentinel

    own = int((valid[2] + valid[3]).max())
    for d_max in (own, N + M):
        junk = emu.garbage(rng, (B, d_max + 1, *cells, N + 1))
        band = junk.clone()
        out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
        out[out_at] = sentinel
        emu.call(lib, f"bialign_batch_fill_{kind}", band, out, *stacks, consts, B,
              N, M, S, d_max)
        twin, twin_scores = bands_plain(*valid, S, *params, d_max=d_max,
                                        band=_without(junk, out_at))
        assert torch.equal(_without(band, out_at), twin.ys), d_max
        assert torch.equal(band[out_at], junk[out_at])
        assert torch.equal(_without(out, out_at), twin_scores)
        assert torch.equal(twin_scores, want)
        assert out[out_at] == sentinel


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
@pytest.mark.parametrize("S", [0, 1, 2, 3, 4])
def test_conveyor_equals_the_twins(lib, S, affine):
    """K8 on 1, 3 and B lanes of garbage, the pair outside the bucket among
    the others on its lane: the twins' scores, on 1 and 3 lanes also the
    conveyor twin's; that pair keeps the score the wrapper set."""
    valid, stacks, out_at, N, M = _bucket(affine, S, 10 * S + affine + 5)
    rng = np.random.default_rng(S + 50)
    kind = "affine" if affine else "nonaffine"
    params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
    consts = cuda_dp._tile_consts(affine, params, S)
    cells = ((9,) if affine else ()) + (2 * S + 1, 2 * S + 1)
    B = stacks[0].shape[0]
    want = (cuda_dp.affine_batch_scores_plain if affine
            else cuda_dp.nonaffine_batch_scores_plain)(*valid, S, *params)
    conveyor_plain = (cuda_dp.affine_conveyor_scores_plain if affine
                      else cuda_dp.nonaffine_conveyor_scores_plain)
    T0 = cuda_dp.conveyor_T0(M)
    for lanes in (1, 3, B):
        out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
        out[out_at] = -12345
        ring = emu.garbage(rng, (lanes, 3, *cells, N + 1))
        emu.call(lib, f"bialign_conveyor_{kind}", ring, out, *stacks, consts, B,
              N, M, S, lanes, T0, N + M)
        assert torch.equal(_without(out, out_at), want), lanes
        assert out[out_at] == -12345
        if lanes < B:
            assert torch.equal(want, conveyor_plain(*valid, S, *params,
                                                    lanes=lanes))


# (n, m) of K3's pairs: the shapes chip_smoke.py runs on the card, and a
# pair longer than a CTA's default threads
MS0_SHAPES = [(7, 9), (1, 1), (0, 3), (5, 0), (20, 13), (40, 35)]
# a CTA's threads: the kernel's own (one a value up to its cap), one warp,
# and a count that is not a whole number of warps; for K7 also 9, which
# gives a thread four rows of the bucket's 34
CTA_THREADS = (0, 32, 100)
MS0_THREADS = (0, 9, 32, 100)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """The same values at an address one int32 past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


def _rings_of_pairs(stacks, junk, ring_plain, out_at):
    """The rings [B, 3, cells, N+1] that the one-CTA kernel leaves: pair b's
    ring is its own twin's (``ring_plain(mu1, mu2, ring=...)`` on the pair's
    own tables) run on the same garbage, the rows beyond n_b untouched; the
    pair outside the bucket keeps its garbage."""
    mu1p, mu2p, ns, ms = stacks
    want = junk.clone()
    for b in range(mu1p.shape[0]):
        if b == out_at:
            continue
        n, m = int(ns[b]), int(ms[b])
        own = want[b, ..., :n + 1].contiguous()
        ring_plain(mu1p[b, :n + 1, :m + 1].contiguous(),
                   mu2p[b, :n + 1, :m + 1].contiguous(), ring=own)
        want[b, ..., :n + 1] = own
    return want


@pytest.mark.parametrize("affine,S", [(True, 1), (True, 2), (True, 3),
                                      (True, 4), (False, 0), (False, 1),
                                      (False, 2), (False, 3), (False, 4)],
                         ids=lambda v: str(v))
def test_cta_kernel_equals_the_twins(lib, S, affine):
    """K6 on the bucket at the tile's edges (empty and full-length pairs),
    on rings of garbage, at several thread counts: the twins' scores, and
    every cell of the rings it leaves equal to the single-pair twin's ring
    on the same garbage (so each value, INVALID and NEG_INF apart, and
    nothing else was written); the pair outside the bucket keeps the score
    the wrapper set and its garbage.  Affine max_shift 0 on route "cta" is
    K7 (below)."""
    valid, stacks, out_at, N, M = _bucket(affine, S, 10 * S + affine + 7)
    rng = np.random.default_rng(S + 70)
    kind = "affine" if affine else "nonaffine"
    params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
    consts = cuda_dp._kernel_consts(affine, params)
    cells = ((9,) if affine else ()) + (2 * S + 1, 2 * S + 1)
    B = stacks[0].shape[0]
    want = (cuda_dp.affine_batch_scores_plain if affine
            else cuda_dp.nonaffine_batch_scores_plain)(*valid, S, *params)
    last_slab = (cuda_dp.affine_last_slab_plain if affine
                 else cuda_dp.nonaffine_last_slab_plain)

    def ring_plain(mu1, mu2, ring):
        last_slab(mu1, mu2, S, *params, ring=ring)
    for threads in CTA_THREADS:
        out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
        out[out_at] = -12345
        junk = emu.garbage(rng, (B, 3, *cells, N + 1))
        ring = junk.clone()
        emu.call(lib, f"bialign_cta_{kind}", ring, out, *stacks, consts, B, N, M,
              S, threads)
        assert torch.equal(_without(out, out_at), want), threads
        assert out[out_at] == -12345
        assert torch.equal(ring, _rings_of_pairs(stacks, junk, ring_plain,
                                                 out_at)), threads


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "misaligned"])
def test_cta_ms0_kernel_equals_the_twin(lib, aligned):
    """K7 on the max_shift 0 bucket at the tile's edges, rings of garbage:
    the twin's scores and, cell for cell, the single-pair twin's rings at
    every thread count (up to four rows a thread); also with mu1's stack
    off a 16-byte boundary and mu2's on one (the kernel reads aligned
    16-byte chunks of each table)."""
    valid, stacks, out_at, N, M = _bucket(True, 0, 77)
    if not aligned:
        stacks = (_misaligned(stacks[0]), *stacks[1:])
    rng = np.random.default_rng(77)
    consts = cuda_dp.ms0_kernel_consts(*AFFINE_PARAMS)
    B = stacks[0].shape[0]
    want = cuda_dp.affine_ms0_batch_scores_plain(*valid, *AFFINE_PARAMS)
    assert torch.equal(want, cuda_dp.affine_batch_scores_plain(
        *valid, 0, *AFFINE_PARAMS))

    def ring_plain(mu1, mu2, ring):
        cuda_dp.affine_ms0_last_slab_plain(mu1, mu2, *AFFINE_PARAMS,
                                           ring=ring)
    for threads in MS0_THREADS:
        out = torch.full((B,), cuda_dp.INVALID, dtype=torch.int32)
        out[out_at] = -12345
        junk = emu.garbage(rng, (B, 3, 3, N + 1))
        ring = junk.clone()
        emu.call(lib, "bialign_cta_affine_ms0", ring, out, *stacks, consts, B, N,
              M, threads)
        assert torch.equal(_without(out, out_at), want), threads
        assert out[out_at] == -12345
        assert torch.equal(ring, _rings_of_pairs(stacks, junk, ring_plain,
                                                 out_at)), threads


@pytest.mark.parametrize("n,m", MS0_SHAPES)
def test_k3_routes_equal_the_twin(lib, n, m):
    """K3 on both routes, on the same ring of garbage: each leaves the ring,
    cell for cell, as the twin does (a diagonal's live rows written, the
    rest as it was), so row n of the last slab is the twin's."""
    rng = np.random.default_rng(3000 + 10 * n + m)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    consts = cuda_dp.ms0_kernel_consts(*AFFINE_PARAMS)
    junk = emu.garbage(rng, (3, 3, n + 1))
    twin = junk.clone()
    cuda_dp.affine_ms0_last_slab_plain(t1, t2, *AFFINE_PARAMS, ring=twin)
    for name, tables in (("bialign_score_affine_ms0", (t1, t2)),
                         ("bialign_score_affine_ms0", (_misaligned(t1), t2)),
                         ("bialign_score_affine_ms0_grid", (t1, t2))):
        ring = junk.clone()
        emu.call(lib, name, ring, *tables, consts, n, m)
        assert torch.equal(ring, twin), name
