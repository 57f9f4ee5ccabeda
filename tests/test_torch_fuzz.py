"""The port's plain twins and entry points against the JAX package on the
seeded cases of ``tests/torch_fuzz_cases.py`` (the generator that
``chip_smoke.py``'s fuzz phase draws from on the card): random costs in
[-500, 200] and the corner sets (zero gap costs, a positive shift reward,
gamma > delta, beta = gamma = delta), uneven shapes with empty sequences and
the tile kernels' edges, random, tie-heavy and int32-edge tables, max_shift
up to each family's limit.

Each twin is held to ``bialign_tpu``'s XLA engine and to its numpy oracle
(``ops/reference_dp.py``), as ``tests/test_fuzz.py`` holds the JAX engines:
the single-pair bands and scores (affine, non-affine, max_shift 0), the
host walk and the walk twins, the checkpointed fill, its blocks and
traceback, the batch scores, bands and walks on buckets of mixed lengths,
the conveyor twin, the split's twins on 1-5 uneven shards, and the
triplet's ``fill_slabs`` against ``fill_xla`` and ``fill_oracle``; then
``BiAligner``, ``score_batch`` and ``align_batch`` against their JAX
counterparts.  Tolerance: exact equality of int32 values, traces (tie-breaks
included) and decoded lines.

Tier-1 runs a handful of seeds at n, m <= 10 (the oracle's affine fill is
O(cells) Python) and max_shift <= 4, with one toy case a family at its
limit (affine 17, non-affine 48, the triplet across its route boundary at
8) against the oracle alone (the XLA engine compiles for a minute there).
``slow`` runs more seeds, n and m up to 300 against the XLA engine (the
oracle where it is cheap), and the Pallas kernels in interpret mode at toy
sizes.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import torch_fuzz_cases as F
import bialign_tpu.models.triplet as JT
from bialign_tpu import BiAligner as JaxBiAligner
from bialign_tpu.ops import checkpoint_dp as jck
from bialign_tpu.ops import device_traceback as jdtb
from bialign_tpu.ops import pallas_dp, reference_dp, xla_dp
from bialign_tpu.ops import traceback as jtb
from bialign_tpu.parallel import batch as jbatch
from bialign_tpu.parallel import seqsplit as jss

import bialign_tpu_torch.models.triplet as T
from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.convert import checkpoint_band_from_jax, tables_to_torch
from bialign_tpu_torch.ops import checkpoint_dp as ckp
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb
from bialign_tpu_torch.ops import traceback as htb
from bialign_tpu_torch.parallel import Mesh, align_batch, score_batch
from bialign_tpu_torch.parallel import seqsplit as ss

KINDS = [True, False]
IDS = ["affine", "nonaffine"]
CPU = dict(engine="torch", device="cpu")
TIER1 = range(4)                 # seeds in tier-1 (the XLA engine on 0, 1)
SLOW = range(4, 10)              # more seeds, larger shapes, under `slow`
# the oracle runs where a case holds at most this many 4-D cells (x 9
# states affine): ~1 s of its Python loop
ORACLE_CELLS = 60_000


def _seeds(tier1=TIER1, slow=SLOW):
    return [*tier1, *(pytest.param(s, marks=pytest.mark.slow) for s in slow)]


def _draw(family, seed, offset=0, **kw):
    """The case of seed + ``offset`` (a test's own cases); tier-1 seeds at
    n, m <= 10 and max_shift <= 4, the slow ones up to 300 (the XLA
    engine's own fuzz stops at 13)."""
    big = seed not in TIER1
    return F.draw(family, seed + offset, max_len=300 if big else 10,
                  cells=400_000 if big else 20_000,
                  rows=lambda S: cuda_dp.tile_rows(S, family == "affine"),
                  **kw)


def _cells(case, affine):
    return ((case.n + 1) * (case.m + 1) * (2 * case.max_shift + 1) ** 2
            * (9 if affine else 1))


def _genuine(n, m, S):
    """Band cells whose (k, l) lie inside the pair (tests/test_pallas.py)."""
    i = np.arange(n + 1)[:, None, None, None]
    j = np.arange(m + 1)[None, :, None, None]
    k = i + np.arange(2 * S + 1)[None, None, :, None] - S
    l = j + np.arange(2 * S + 1)[None, None, None, :] - S
    return (k >= 0) & (k <= n) & (l >= 0) & (l <= m)


def _assert_band(got, want, n, m, S, affine, what):
    ok = _genuine(n, m, S)[None] if affine else _genuine(n, m, S)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bad = np.argwhere(ok & (got != want))
    assert not len(bad), f"{what}: {len(bad)} cells differ, first {bad[:3]}"


def _fill_plain(affine, t1, t2, case):
    fill = cuda_dp.fill_affine_plain if affine else cuda_dp.fill_nonaffine_plain
    return fill(t1, t2, case.max_shift, *case.params(affine))


def _oracle(affine, mu1, mu2, case):
    """(H, score, trace) of the numpy oracle and the JAX host walk; the
    affine trace as (trace, complete)."""
    S, p = case.max_shift, case.params(affine)
    n, m = case.n, case.m
    if affine:
        H = reference_dp.fill_affine(mu1, mu2, S, *p)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return (H, reference_dp.affine_score_from_band(H, n, m, S),
                    jtb.affine_traceback(H, mu1, mu2, S, *p))
    H = reference_dp.fill_nonaffine(mu1, mu2, S, *p)
    return (H, reference_dp.nonaffine_score_from_band(H, n, m, S),
            jtb.nonaffine_traceback(H, mu1, mu2, S, *p))


def _twin_walk(affine, band, case, t1, t2):
    walk = (dtb.affine_traceback_plain if affine
            else dtb.nonaffine_traceback_plain)
    return walk(band, *case.params(affine), t1, t2)


def _check_pair(case, affine, xla):
    """The band, score-only and max_shift 0 twins, the host walk and the
    walk twin of one case against the oracle (where it is cheap) and the
    XLA engine (``xla``)."""
    mu1, mu2 = case.tables()
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    S, p, n, m = case.max_shift, case.params(affine), case.n, case.m
    what = case.tag()
    band = _fill_plain(affine, t1, t2, case)
    trace = _twin_walk(affine, band, case, t1, t2)
    score = (cuda_dp.affine_score_plain if affine
             else cuda_dp.nonaffine_score_plain)(t1, t2, S, *p)
    assert score == band.final_score(), what
    if affine and S == 0:
        assert cuda_dp.affine_ms0_score_plain(t1, t2, *p) == score, what
    if _cells(case, affine) <= ORACLE_CELLS:
        H, want, want_trace = _oracle(affine, mu1, mu2, case)
        _assert_band(band.to_numpy(), H, n, m, S, affine, what)
        assert score == want, what
        assert trace == want_trace, what
        # the port's copy of the host walk, on the oracle's band
        host = (htb.affine_traceback(H, mu1, mu2, S, *p) if affine
                else htb.nonaffine_traceback(H, mu1, mu2, S, *p))
        assert host == want_trace, what
    if xla:
        fill = (xla_dp.fill_affine_device if affine
                else xla_dp.fill_nonaffine_device)
        jband = fill(mu1, mu2, S, *p)
        assert jband.final_score() == score, what
        jwalk = jdtb.affine_traceback if affine else jdtb.nonaffine_traceback
        assert jwalk(jband, *p, mu1, mu2) == trace, what
    return band, trace


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", _seeds())
def test_pair_twins_equal_the_oracle_and_xla(seed, affine):
    case = _draw("affine" if affine else "nonaffine", seed)
    _check_pair(case, affine, xla=seed not in TIER1[2:])


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", _seeds(range(1), range(1, 5)))
def test_pair_twins_at_the_tile_limit_equal_the_oracle(seed, affine):
    """max_shift 17 affine, 48 non-affine (the largest the tile kernels
    take, their run-time-S form) on toy shapes: the oracle alone."""
    case = F.at_limit("affine" if affine else "nonaffine", seed)
    mu1, mu2 = case.tables()
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    band = _fill_plain(affine, t1, t2, case)
    H, want, want_trace = _oracle(affine, mu1, mu2, case)
    _assert_band(band.to_numpy(), H, case.n, case.m, case.max_shift, affine,
                 case.tag())
    assert band.final_score() == want
    assert _twin_walk(affine, band, case, t1, t2) == want_trace


@pytest.mark.slow
@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", range(3))
def test_pair_twins_equal_the_pallas_kernels(seed, affine):
    """The Pallas kernels K1/K2 in interpret mode, at toy sizes."""
    case = F.draw("affine" if affine else "nonaffine", 200 + seed,
                  max_len=8, max_shift=2)
    mu1, mu2 = case.tables()
    band, trace = _check_pair(case, affine, xla=False)
    p = case.params(affine)
    fill = (pallas_dp.fill_affine_device if affine
            else pallas_dp.fill_nonaffine_device)
    jband = fill(mu1, mu2, case.max_shift, *p)
    _assert_band(band.to_numpy(), jband.to_numpy(), case.n, case.m,
                 case.max_shift, affine, case.tag())
    assert jband.final_score() == band.final_score()
    jwalk = jdtb.affine_traceback if affine else jdtb.nonaffine_traceback
    assert jwalk(jband, *p, mu1, mu2) == trace


# -- the checkpointed band ----------------------------------------------------

def _genuine_slab(n, m, S, d):
    i = np.arange(n + 1)[None, None, :]
    j = d - i
    k = i + np.arange(2 * S + 1)[:, None, None] - S
    l = j + np.arange(2 * S + 1)[None, :, None] - S
    return (j >= 0) & (j <= m) & (k >= 0) & (k <= n) & (l >= 0) & (l <= m)


def _assert_slab(got, want, n, m, S, d, what):
    ok = _genuine_slab(n, m, S, d)
    assert np.where(ok, np.asarray(got) == np.asarray(want), True).all(), what


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", _seeds(range(1), range(1, 5)))
def test_checkpoint_twins_equal_the_xla_scan(seed, affine):
    """The checkpointed fill at a drawn block size against the JAX XLA
    checkpoints; every block's window against the full band's diagonals;
    the blockwise traceback against the full band's walk."""
    case = _draw("affine" if affine else "nonaffine", seed)
    mu1, mu2 = case.tables()
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    n, m, S, p = case.n, case.m, case.max_shift, case.params(affine)
    rng = np.random.default_rng([seed, 3])
    C = int(rng.integers(1, n + m + 5))
    fill = (ckp.fill_affine_checkpoint_plain if affine
            else ckp.fill_nonaffine_checkpoint_plain)
    cb = fill(t1, t2, S, *p, block=C)
    jfill = (jck.fill_affine_checkpoint if affine
             else jck.fill_nonaffine_checkpoint)
    jcb = jfill(mu1, mu2, S, *p, block=C)
    carried = checkpoint_band_from_jax(jcb, mu1, mu2)
    assert carried.ckpts.shape == cb.ckpts.shape
    for b in range(1, cb.n_blocks):
        for x in (0, 1):
            _assert_slab(cb.ckpts[b, x], carried.ckpts[b, x], n, m, S,
                         b * C - 1 - x, (case.tag(), b, x))
    assert cb.final_score() == jcb.final_score()

    band = _fill_plain(affine, t1, t2, case)
    block = ckp.affine_block_plain if affine else ckp.nonaffine_block_plain
    for b in range(cb.n_blocks):
        window = block(cb, b)
        for x in range(2, window.shape[0]):
            d = b * C + x - 2
            if d <= n + m:
                _assert_slab(window[x], band.ys[d], n, m, S, d,
                             (case.tag(), b, x))
    traceback = (ckp.affine_traceback_plain(cb, *p) if affine
                 else ckp.nonaffine_traceback_plain(cb, *p))
    assert traceback == _twin_walk(affine, band, case, t1, t2)


# -- the batch: scores, bands, walks, the conveyor ---------------------------

def _bucket_tables(case, seed):
    rng = np.random.default_rng([seed, 5])
    N, M = max(case.n, 1), max(case.m, 1)
    lengths = F.mixed_bucket(rng, N, M, int(rng.integers(3, 7)))
    return [F.draw_tables(rng, n, m, case.table_kind, case.costs)
            for n, m in lengths]


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", _seeds(range(1), range(1, 5)))
def test_batch_twins_equal_the_jax_batch(seed, affine):
    """score_batch and align_batch (the bucket twins) on pairs of mixed
    lengths against the JAX package's (XLA; align_batch under `slow`: its
    fused fill and walk compile for ~40 s) and, pair by pair, the band twin
    and its walk; the conveyor twin on one and two lanes."""
    # tier-1 at max_shift <= 2, where the JAX batch compiles fastest
    case = _draw("affine" if affine else "nonaffine", seed, 300,
                 max_shift=2 if seed in TIER1 else 4)
    tables = _bucket_tables(case, seed)
    S, p = case.max_shift, case.params(affine)
    scores = score_batch(tables, S, p, affine=affine, **CPU)
    want = jbatch.score_batch(tables, S, p, affine=affine)
    assert np.array_equal(np.asarray(scores), np.asarray(want)), case.tag()
    got = align_batch(tables, S, p, affine=affine, **CPU)
    assert np.array_equal(np.asarray(got[0]), np.asarray(want))
    if seed not in TIER1:
        jgot = jbatch.align_batch(tables, S, p, affine=affine)
        assert list(got[1]) == list(jgot[1])
        assert list(got[2]) == list(jgot[2])
    for (mu1, mu2), score, trace, done in zip(tables, scores, *got[1:]):
        t1, t2 = tables_to_torch(mu1, mu2, "cpu")
        one = dataclasses.replace(case, n=mu1.shape[0] - 1,
                                  m=mu1.shape[1] - 1)
        band = _fill_plain(affine, t1, t2, one)
        assert band.final_score() == score
        walked = _twin_walk(affine, band, one, t1, t2)
        assert (walked if affine else (walked, True)) == (trace, done)

    N = max(mu.shape[0] for mu, _ in tables) - 1
    M = max(mu.shape[1] for mu, _ in tables) - 1
    from bialign_tpu_torch.parallel import batch as pbatch
    stacks = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        pbatch.stack_padded([t[0] for t in tables], N, M),
        pbatch.stack_padded([t[1] for t in tables], N, M),
        np.array([mu.shape[0] - 1 for mu, _ in tables], np.int32),
        np.array([mu.shape[1] - 1 for mu, _ in tables], np.int32)))
    conveyor = (cuda_dp.affine_conveyor_scores_plain if affine
                else cuda_dp.nonaffine_conveyor_scores_plain)
    for lanes in (1, 2):
        got = conveyor(*stacks, S, *p, lanes=lanes)
        assert np.array_equal(got.numpy(), np.asarray(want)), lanes


# -- the sequence split --------------------------------------------------------

@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("seed", _seeds(range(1), range(1, 5)))
def test_split_twins_on_uneven_shards(seed, affine):
    """The split's three twins on K = 1-5 shards of uneven rows: the score
    equal to the oracle's (or the XLA engine's) and to the JAX
    ``score_seqsplit`` on K devices, each shard's checkpoints and windows
    equal to the unsharded twins' on its rows; the split band's traceback
    equal to the full band's walk."""
    case = _draw("affine" if affine else "nonaffine", seed, 400)
    mu1, mu2 = case.tables()
    n, m, S, p = case.n, case.m, case.max_shift, case.params(affine)
    rng = np.random.default_rng([seed, 9])
    K = int(rng.integers(1, min(5, n + 1) + 1))
    rows = F.uneven_rows(rng, n, K)
    shards = ss.make_shards(mu1, mu2, ["cpu"] * K, rows=rows)
    rings = ss.seqsplit_last_slabs_plain(shards, S, p, affine)
    score = ss._score_of(shards, rings, n, m, S, affine)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    band = _fill_plain(affine, t1, t2, case)
    assert score == band.final_score(), (case.tag(), rows)
    mesh = JaxMesh(np.array(jax.devices()[:K]), ("sp",))
    assert score == jss.score_seqsplit(mu1, mu2, S, p, mesh=mesh,
                                       affine=affine), (case.tag(), K)

    C = int(rng.integers(1, n + m + 5))
    fill = (ckp.fill_affine_checkpoint_plain if affine
            else ckp.fill_nonaffine_checkpoint_plain)
    whole = fill(t1, t2, S, *p, block=C)
    s_rings, s_ckpts = ss.seqsplit_checkpoints_plain(shards, S, p, affine, C)
    block = ckp.affine_block_plain if affine else ckp.nonaffine_block_plain
    Cw = min(C, n + m + 1)
    for b in range(whole.n_blocks):
        for x in (0, 1):
            d = b * C - 1 - x
            if b:
                got = torch.cat([c[b, x][..., 1:] for c in s_ckpts], -1)
                _assert_slab(got, whole.ckpts[b, x], n, m, S, d, (b, x))
        parts = ss.seqsplit_block_plain(shards, S, p, affine,
                                        [c[b] for c in s_ckpts], b * C, Cw)
        window = block(whole, b)
        got = torch.cat([w[..., 1:] for w in parts], -1)
        for x in range(2, Cw + 2):
            d = b * C + x - 2
            if d <= n + m:
                _assert_slab(got[x], window[x], n, m, S, d, (b, x))
    sband = ss.fill_seqsplit(mu1, mu2, S, p, mesh=Mesh(["cpu"] * K, ("sp",)),
                             affine=affine, block=C, engine="torch")
    traced = (ckp.affine_traceback_plain(sband, *p) if affine
              else ckp.nonaffine_traceback_plain(sband, *p))
    assert traced == _twin_walk(affine, band, case, t1, t2)


# -- the triplet ---------------------------------------------------------------

def _triplet_band(n, m, S):
    j = np.arange(m + 1)[:, None]
    k = np.arange(m + 1)[None, :]
    return np.broadcast_to(np.abs(k - j) <= S, (n + 1, m + 1, m + 1))


@pytest.mark.parametrize("seed", _seeds(range(2), range(2, 8)))
def test_triplet_fill_slabs_equals_fill_xla_and_the_oracle(seed):
    """``fill_slabs`` (the kernels' twin) in the oracle's layout: every
    banded cell equal to ``fill_oracle``'s and the whole array to
    ``fill_xla``'s; seeds 0 and 1 on either side of the route boundary at
    max_shift 8, seed 2 at 16."""
    if seed < 3:
        S = (F.TRIPLET_STATIC_SHIFTS, F.TRIPLET_STATIC_SHIFTS + 1,
             F.LIMITS["triplet"])[seed]
        case = F.at_limit("triplet", seed, max_len=9, max_shift=S)
    else:
        case = F.draw("triplet", seed, max_len=40, max_shift=16,
                      cells=40_000)
    mu1, mu2 = case.tables()
    n, m, S = case.n, case.m, case.max_shift
    gamma, delta = case.params(False)
    ys = T.fill_slabs(mu1, mu2, S, gamma, delta, device="cpu")
    got = T.oracle_layout(ys.numpy(), n, m, S)
    band = _triplet_band(n, m, S)
    want = JT.fill_oracle(mu1, mu2, S, gamma, delta)
    assert np.array_equal(got[band], want[band]), case.tag()
    assert np.array_equal(got, JT.fill_xla(mu1, mu2, S, gamma, delta))


# -- the entry points ----------------------------------------------------------

RNA, PROTEIN = "ACGU", "ARNDCQEGHILKMFPSTWYV"


def _structure(rng, L, rna):
    """A random structure of length L: nested pairs for RNA, H/E/C runs
    for proteins."""
    if not rna:
        return "".join(rng.choice(list("HEC"), L))
    out, stack = [], []
    for i in range(L):
        r = rng.random()
        if r < 0.2 and L - i > len(stack):
            out.append("(")
            stack.append(i)
        elif r < 0.4 and stack and i - stack[-1] > 3:
            out.append(")")
            stack.pop()
        else:
            out.append(".")
    for i in reversed(stack):
        out[i] = "."
    return "".join(out)


def _molecules(seed, max_len):
    rng = np.random.default_rng([seed, 13])
    rna = bool(seed % 2)
    alphabet = RNA if rna else PROTEIN
    mols = []
    for _ in range(2):
        L = int(rng.integers(1, max_len + 1))
        mols.append(("".join(rng.choice(list(alphabet), L)),
                     _structure(rng, L, rna)))
    (seqA, strA), (seqB, strB) = mols
    params = (dict(type="RNA", structure_weight=400) if rna else
              dict(type="Protein", structure_weight=800,
                   simmatrix="BLOSUM62"))
    return (seqA, seqB, strA, strB), params


def _run(cls, mol, params, **kw):
    ba = cls(*mol, **params, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        score = ba.optimize()
        return score, list(ba.decode_trace()), ba


@pytest.mark.parametrize("lowmem", [False, True], ids=["band", "lowmem"])
@pytest.mark.parametrize("seed", _seeds(range(2), range(2, 8)))
def test_aligner_equals_the_jax_aligner(seed, lowmem):
    """``BiAligner(engine="torch", device="cpu")`` against
    ``bialign_tpu.BiAligner(engine="xla")`` on random sequences and
    structures, RNA and protein, at the generator's costs (beta 0: the
    non-affine DP) and max_shift: SCORE and every decoded line."""
    case = _draw("affine", seed, 500)
    mol, params = _molecules(seed, 12 if seed in TIER1 else 120)
    beta, gamma, delta = case.costs
    params.update(gap_opening_cost=beta, gap_cost=gamma, shift_cost=delta,
                  max_shift=case.max_shift)
    more = dict(lowmem=True, checkpoint_block=3) if lowmem else {}
    got = _run(BiAligner, mol, params, **CPU, **more)
    want = _run(JaxBiAligner, mol, params, engine="xla", **more)
    assert got[:2] == want[:2], (case.tag(), mol)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(3))
def test_batch_entry_points_equal_the_jax_ones_on_records(seed):
    """``score_batch`` and ``align_batch`` over the tables of random
    records (RNA or protein, a few pairs of mixed lengths) against the JAX
    package's, at the generator's costs and max_shift; each equal to the
    records' own ``BiAligner`` scores and traces."""
    case = _draw("affine", seed, 600)
    beta, gamma, delta = case.costs
    affine = beta != 0
    aligners = []
    for k in range(3):      # RNA on odd seeds, proteins on even ones
        mol, params = _molecules(2 * (4 * seed + k) + seed % 2, 16)
        params.update(gap_opening_cost=beta, gap_cost=gamma,
                      shift_cost=delta, max_shift=case.max_shift)
        aligners.append(BiAligner(*mol, **params, **CPU))
    tables = [(ba.mu1, ba.mu2) for ba in aligners]
    S, p = case.max_shift, case.params(affine)
    scores = score_batch(tables, S, p, affine=affine, **CPU)
    assert np.array_equal(np.asarray(scores), np.asarray(
        jbatch.score_batch(tables, S, p, affine=affine)))
    got = align_batch(tables, S, p, affine=affine, **CPU)
    want = jbatch.align_batch(tables, S, p, affine=affine)
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert list(got[1]) == list(want[1]) and list(got[2]) == list(want[2])
    for ba, score, trace in zip(aligners, scores, got[1]):
        assert ba.optimize() == score
        assert ba.traceback() == trace


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
def test_tables_beyond_the_int32_certificate_take_the_int64_engine(affine):
    """Tables just outside ``check_int32_safe``: both aligners warn and run
    their int64 engines, with equal scores and lines (on the card,
    chip_smoke.py's fuzz phase also sees no kernel launched)."""
    mol, params = _molecules(2, 9)
    params.update(gap_opening_cost=-150 if affine else 0, gap_cost=-50,
                  shift_cost=-150, max_shift=2)
    out = []
    for cls, kw in ((BiAligner, CPU), (JaxBiAligner, dict(engine="xla"))):
        ba = cls(*mol, **params, **kw)
        n, m = ba.mu1.shape[0] - 1, ba.mu1.shape[1] - 1
        ba.mu1, ba.mu2 = F.int32_outside_tables(np.random.default_rng(17),
                                                n, m)
        with pytest.warns(RuntimeWarning, match="int64"):
            out.append((ba.optimize(), list(ba.decode_trace())))
        if cls is BiAligner:
            assert ba._int64
    assert out[0] == out[1]


def test_the_generator_knows_the_ports_limits():
    """The generator's copies of the port's constants, and its int32 edge:
    the largest certified magnitude passes ``check_int32_safe`` in both
    packages, one more does not."""
    from bialign_tpu.ops.cases import check_int32_safe as jax_safe
    from bialign_tpu_torch.ops.cases import check_int32_safe
    assert F.MS0_RESIDENT_ROWS == cuda_dp.MS0_RESIDENT_ROWS
    assert F.TRIPLET_STATIC_SHIFTS == T.STATIC_SHIFTS
    for affine, limit in ((True, F.LIMITS["affine"]),
                          (False, F.LIMITS["nonaffine"])):
        cuda_dp._tile_consts(affine, (-1, -1, -1)[-(2 + affine):], limit)
        with pytest.raises(ValueError):
            cuda_dp._tile_consts(affine, (-1, -1, -1)[-(2 + affine):],
                                 limit + 1)
    rng = np.random.default_rng(1)
    for n, m in ((1, 1), (10, 3), (300, 299)):
        for costs in F.CORNER_COSTS.values():
            mu1, mu2 = F.draw_tables(rng, n, m, "int32_inside", costs)
            params = dict(gap_opening_cost=costs[0], gap_cost=costs[1],
                          shift_cost=costs[2])
            assert check_int32_safe(mu1, mu2, params)
            assert jax_safe(mu1, mu2, params)
        mu1, mu2 = F.int32_outside_tables(rng, n, m)
        params = dict(gap_opening_cost=0, gap_cost=0, shift_cost=0)
        assert not check_int32_safe(mu1, mu2, params)
        assert not jax_safe(mu1, mu2, params)


def test_the_generator_draws_every_kind_within_its_limits():
    """A seed names one case; the first seeds cover every cost and table
    kind; shapes stay within their bounds, uneven, and reach empty
    sequences and the tile's edges; max_shift stays within the family's
    limit and the cell budget."""
    assert F.draw("affine", 3) == F.draw("affine", 3)
    cases = [F.draw(f, s, max_len=300, max_shift=F.LIMITS[f],
                    cells=2_000_000, rows=lambda S: 8)
             for f in ("affine", "nonaffine", "triplet") for s in range(60)]
    assert {c.cost_kind for c in cases[:15]} == set(F.COST_KINDS)
    assert {c.table_kind for c in cases[:15]} == set(F.TABLE_KINDS)
    assert any(min(c.n, c.m) == 0 for c in cases)
    assert any(min(c.n, c.m) + 1 in (7, 8, 9) for c in cases)
    for c in cases:
        assert 0 <= c.max_shift <= F.LIMITS[c.family]
        assert c.n != c.m or 0 in (c.n, c.m)
        W2 = (2 * c.max_shift + 1) ** 2 * (9 if c.family == "affine" else 1)
        assert (c.n + 1) * (c.m + 1) * W2 <= 2_000_000 or max(c.n, c.m) <= 4
        beta, gamma, delta = c.costs
        assert beta != 0 or c.cost_kind == "zero_gaps"
        if c.cost_kind == "random":
            assert all(F.COST_RANGE[0] <= v <= F.COST_RANGE[1]
                       for v in c.costs)
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 40):
        for K in range(1, min(5, n + 1) + 1):
            rows = F.uneven_rows(rng, n, K)
            assert rows[0][0] == 0 and rows[-1][1] == n
            assert all(b >= a for a, b in rows)
            assert all(rows[k + 1][0] == rows[k][1] + 1 for k in range(K - 1))
