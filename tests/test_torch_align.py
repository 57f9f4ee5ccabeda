"""The port's batched-alignments path and codes serving path (plain twins on
the CPU) against the JAX package: the band-emitting batched fills K4/K5 in
interpret mode, the vmapped device walks, ``parallel.batch.align_batch`` and
the codes dispatchers as tests/test_batch.py and tests/test_conveyor.py run
them, and the numpy oracle.  Bands, codes, scores, traces and flags are
int32 DP values or derived from them: compared for equality, tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import golden as G
from bialign_tpu.ops import device_traceback as jdtb
from bialign_tpu.ops import pallas_dp, xla_dp
from bialign_tpu.ops.cases import NonAffineTables
from bialign_tpu.parallel import batch as JB
from test_batch import SIZES, _oracle_scores, _oracle_traces, _rand_pair
from test_conveyor import _protein_records

from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.convert import (
    batch_band_from_jax,
    code_stacks_from_jax,
    tables_to_torch,
)
from bialign_tpu_torch.models.molecule import preprocess_molecule
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb
from bialign_tpu_torch.ops.band import INVALID, DeviceBatchBand
from bialign_tpu_torch.parallel import batch as TB
from bialign_tpu_torch.scoring.tables import _sim_lut, build_score_tables

AFFINE = (-150, -50, -150)          # beta, gamma, delta
NONAFFINE = (-200, -250)            # gamma, delta
CPU = dict(engine="torch", device="cpu")
KINDS = {"affine": (True, AFFINE), "nonaffine": (False, NONAFFINE)}

# (n, m) in one (8, 8) bucket: empty sequences (a pair of two empty ones
# cannot complete its affine walk), the bucket's own size, and pairs far
# shorter than it
MIXED = [(0, 5), (6, 0), (8, 8), (1, 1), (8, 2), (0, 0), (3, 8), (5, 7)]


def _pairs(seed=42, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [_rand_pair(rng, n, m) for n, m in sizes]


def _np_stacks(pairs, N, M):
    return (TB.stack_padded([p[0] for p in pairs], N, M),
            TB.stack_padded([p[1] for p in pairs], N, M),
            np.asarray([p[0].shape[0] - 1 for p in pairs], dtype=np.int32),
            np.asarray([p[0].shape[1] - 1 for p in pairs], dtype=np.int32))


def _stacks(pairs, N, M):
    return tuple(torch.from_numpy(a) for a in _np_stacks(pairs, N, M))


def _garbage(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)
    a.flat[::7] = np.iinfo(np.int32).max
    a.flat[3::11] = np.iinfo(np.int32).min
    return torch.from_numpy(a)


def _jax_chunk_band(pairs, N, M, S, affine, params):
    """The folded chunk band of the JAX band-mode fill, Pallas in interpret
    mode, on the bucket's stacks."""
    dense = (pallas_dp._affine_pallas_batched_dense if affine
             else pallas_dp._nonaffine_pallas_batched_dense)
    return dense(*(jnp.asarray(a) for a in _np_stacks(pairs, N, M)),
                 N + M + 1, S, params, False)


def _bands(kind, stacks, S, **kw):
    affine, params = KINDS[kind]
    fill = (cuda_dp.affine_batch_bands if affine
            else cuda_dp.nonaffine_batch_bands)
    return fill(*stacks, S, *params, **kw)


def _pair_band(kind, mu1, mu2, S):
    affine, params = KINDS[kind]
    fill = cuda_dp.fill_affine_plain if affine else cuda_dp.fill_nonaffine_plain
    return fill(*tables_to_torch(mu1, mu2, "cpu"), S, *params)


def _genuine(bband, depth=None):
    """The chunk band with every cell that is not genuine set to 0."""
    ys = torch.where(bband.genuine(), bband.ys, 0)
    return ys if depth is None else ys[:, :depth]


@pytest.mark.parametrize("S", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", list(KINDS))
def test_batch_band_twin_matches_jax_and_the_single_pair_twin(kind, S):
    """The module that holds K4/K5: the twin's chunk band equals the JAX
    band-mode fill's on every genuine cell, and pair(b) equals the band of
    the pair alone on its own tables, cell for cell, with n_b = 0, m_b = 0
    and n_b = N in the bucket; neither a band of garbage nor the d_max cut
    changes a genuine cell."""
    affine, params = KINDS[kind]
    pairs = _pairs(3 + S, MIXED)
    stacks = _stacks(pairs, 8, 8)
    jax_band = batch_band_from_jax(
        np.asarray(_jax_chunk_band(pairs, 8, 8, S, affine, params)),
        stacks[2].numpy(), stacks[3].numpy(), 8, S, affine)
    assert jax_band.ys.shape[1] >= 17 and jax_band.ys.shape[-1] == 9

    bband, scores = _bands(kind, stacks, S)
    assert isinstance(bband, DeviceBatchBand) and bband.D == 17
    assert bband.ys.dtype == torch.int32 and scores.dtype == torch.int32
    assert torch.equal(_genuine(bband), _genuine(jax_band, 17))

    singles = [_pair_band(kind, mu1, mu2, S) for mu1, mu2 in pairs]
    assert scores.tolist() == [b.final_score() for b in singles]
    shape = tuple(bband.ys.shape)
    dirty, dirty_scores = _bands(kind, stacks, S, band=_garbage(S, shape))
    cut, cut_scores = _bands(kind, stacks, S, d_max=16)
    assert torch.equal(dirty_scores, scores) and torch.equal(cut_scores, scores)
    for b, single in enumerate(singles):
        for got in (bband, dirty, cut, jax_band):
            own = got.pair(b)
            assert (own.n, own.m) == (single.n, single.m)
            assert torch.equal(own.ys, single.ys)
    # what the fill did not write it left alone
    assert torch.equal(torch.where(dirty.genuine(), 0, dirty.ys),
                       torch.where(dirty.genuine(), 0, _garbage(S, shape)))


def test_batch_bands_stop_at_d_max():
    """With d_max below the longest pair's last diagonal the band has
    d_max + 1 diagonals; pairs that end inside it keep band and score, the
    others get INVALID, and pair() refuses them."""
    pairs = _pairs(9, MIXED)
    stacks = _stacks(pairs, 8, 8)
    full, scores = _bands("affine", stacks, 1)
    cut, cut_scores = _bands("affine", stacks, 1, d_max=10)
    assert cut.D == 11 and torch.equal(cut.ys, full.ys[:, :11])
    inside = torch.tensor([n + m <= 10 for n, m in MIXED])
    assert torch.equal(cut_scores[inside], scores[inside])
    assert (cut_scores[~inside] == INVALID).all()
    with pytest.raises(ValueError, match="diagonals"):
        cut.pair(2)
    walks = dtb.unpack_walks(dtb.affine_walk_batch(cut, *AFFINE, *stacks[:2]))
    assert walks[2][1:] == (2, INVALID) and len(walks[2][0]) == 0


@pytest.mark.parametrize("S", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", list(KINDS))
def test_batch_walk_twin_matches_jax_batch_walk(kind, S):
    """The batch walks on one state: the JAX band-mode fill's chunk band,
    walked by the vmapped JAX walks in its folded layout and, carried over
    by batch_band_from_jax, by the port's batch walk; codes, steps, done
    flags and scores equal.  The same from the port's own chunk band."""
    affine, params = KINDS[kind]
    pairs = _pairs(3 + S, MIXED)
    np_stacks = _np_stacks(pairs, 8, 8)
    mu1p, mu2p, ns, ms = (jnp.asarray(a) for a in np_stacks)
    folded = _jax_chunk_band(pairs, 8, 8, S, affine, params)
    if affine:
        codes, steps, done, scores = (np.asarray(a) for a in (
            jdtb._affine_walk_batch(
                folded, mu1p, mu2p, jnp.asarray(jdtb._affine_const(*params)),
                S, "folded", ns, ms)))
    else:
        codes, steps = (np.asarray(a) for a in jdtb._nonaffine_walk_batch(
            folded, mu1p, mu2p, jnp.asarray(NonAffineTables(*params).const),
            S, "folded", ns, ms))
        done = np.ones_like(steps)
        scores = np.asarray([_pair_band(kind, mu1, mu2, S).final_score()
                             for mu1, mu2 in pairs])

    stacks = tuple(torch.from_numpy(a) for a in np_stacks)
    walk = dtb.affine_walk_batch if affine else dtb.nonaffine_walk_batch
    carried = batch_band_from_jax(np.asarray(folded), np_stacks[2],
                                  np_stacks[3], 8, S, affine)
    own, _scores = _bands(kind, stacks, S)
    for bband in (carried, own):
        out = walk(bband, *params, *stacks[:2])
        assert out.dtype == torch.int32 and out.shape == (8, 3 + 33)
        out = out.numpy()
        assert (out[:, 0] == steps).all() and (out[:, 1] == done).all()
        assert (out[:, 2] == scores).all()
        assert (out[:, 3:] == codes).all()       # zeros behind the last code
    if affine:
        assert done[MIXED.index((0, 0))] == 2    # an incomplete walk


def _assert_alignments(got, want):
    (scores, traces, complete), (w_scores, w_traces, w_complete) = got, want
    assert scores.dtype == np.int64 and (scores == w_scores).all()
    assert traces == w_traces and complete == w_complete


def _oracle_alignments(pairs, S, affine, params):
    beta, gamma, delta = params if affine else (0, *params)
    traces, complete = _oracle_traces(pairs, S, beta, gamma, delta, affine)
    return (_oracle_scores(pairs, S, beta, gamma, delta, affine), traces,
            complete)


@pytest.mark.parametrize("kind,S", [("affine", 1), ("nonaffine", 2),
                                    ("affine", 0), ("affine", 3),
                                    ("nonaffine", 0)])
def test_align_batch_matches_jax_and_oracle(kind, S):
    """The slice as a whole on the cases of tests/test_batch.py:168 (affine
    max_shift 1), :184 (non-affine max_shift 2) and :275 (max_shift 0 and
    3): scores, traces with the reference's tie-breaks, complete flags."""
    affine, params = KINDS[kind]
    if S in (0, 3):
        rng = np.random.default_rng(5 + S)
        pairs = [_rand_pair(rng, 5 + i, 6 + (i % 3)) for i in range(6)]
    else:
        pairs = _pairs()
    got = TB.align_batch(pairs, S, params, affine=affine, bucket_quantum=8,
                         **CPU)
    _assert_alignments(got, _oracle_alignments(pairs, S, affine, params))
    _assert_alignments(got, JB.align_batch(pairs, S, params, affine=affine,
                                           bucket_quantum=8))


def test_align_batch_64_pairs_chunked():
    """tests/test_batch.py:196: a 64-pair bucket in chunks of 24, so three
    dispatches whose results come back in one copy, in input order."""
    rng = np.random.default_rng(7)
    pairs = [_rand_pair(rng, 4 + (i % 5), 5 + (i % 4)) for i in range(64)]
    pending = TB.dispatch_align_batch(pairs, 1, AFFINE, affine=True,
                                      bucket_quantum=8, chunk=24, **CPU)
    assert pending.n_dispatches == 3
    got = pending.get()
    _assert_alignments(got, _oracle_alignments(pairs, 1, True, AFFINE))
    _assert_alignments(got, JB.align_batch(pairs, 1, AFFINE, affine=True,
                                           bucket_quantum=8, chunk=24))
    whole = TB.align_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=8,
                           **CPU)
    _assert_alignments(got, whole)


def test_align_batch_incomplete_walk_and_empty_sequences():
    """A pair of two empty sequences has no column to trace: its affine
    walk is incomplete (the reference's warning case), its non-affine walk
    has no such flag; pairs with one empty sequence align by gaps alone."""
    pairs = _pairs(3, MIXED)
    got = TB.align_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=8,
                         **CPU)
    want = _oracle_alignments(pairs, 1, True, AFFINE)
    _assert_alignments(got, want)
    assert got[2] == [n + m > 0 for n, m in MIXED]
    assert got[1][MIXED.index((0, 0))] == []
    _assert_alignments(got, JB.align_batch(pairs, 1, AFFINE, affine=True,
                                           bucket_quantum=8))
    got = TB.align_batch(pairs, 1, NONAFFINE, affine=False, bucket_quantum=8,
                         **CPU)
    _assert_alignments(got, _oracle_alignments(pairs, 1, False, NONAFFINE))
    assert got[2] == [True] * len(MIXED)


def test_align_batch_bucket_of_more_than_128_rows():
    """tests/test_batch.py:319: pairs longer than one TPU lane row, a
    (192, 192) bucket, against the JAX XLA fill and device walk per pair."""
    rng = np.random.default_rng(17)
    pairs = [_rand_pair(rng, 130 + i, 131 - i) for i in range(2)]
    scores, traces, complete = TB.align_batch(
        pairs, 1, AFFINE, affine=True, bucket_quantum=64, **CPU)
    for (mu1, mu2), score, trace, comp in zip(pairs, scores, traces,
                                              complete):
        band = xla_dp.fill_affine_device(mu1, mu2, 1, *AFFINE)
        want, want_comp = jdtb.affine_traceback(band, *AFFINE, mu1, mu2)
        assert score == band.final_score()
        assert trace == want and comp == want_comp


def test_align_batch_empty():
    scores, traces, complete = TB.align_batch([], 1, AFFINE, affine=True,
                                              **CPU)
    assert scores.dtype == np.int64 and len(scores) == 0
    assert traces == [] and complete == []
    assert TB.dispatch_align_batch([], 1, AFFINE, affine=True,
                                   **CPU).n_dispatches == 0


def test_align_batch_int32_guard_raises_value_error():
    """tests/test_batch.py:301-316: unsafe magnitudes raise, not wrap."""
    mu = np.full((9, 9), 2_000_000, dtype=np.int32)
    big = (-20_000_000, -2_000_000, -2_000_000)
    with pytest.raises(ValueError, match="int32"):
        TB.align_batch([(mu, mu)], 1, big, affine=True, bucket_quantum=8,
                       **CPU)


def test_align_refusals():
    pairs = _pairs()[:2]
    codes = [TB.encode_pair("ACD", "AC", "HHC", "HC")]
    lut = TB.match_mismatch_lut(100, 0)
    with pytest.raises(NotImplementedError, match="P15"):
        TB.align_batch(pairs, 1, AFFINE, affine=True, mesh=object(), **CPU)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.align_batch(pairs, 1, AFFINE, affine=True, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        TB.dispatch_align_batch(pairs, 1, AFFINE, affine=True, engine="xla",
                                device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        TB.align_batch(pairs, 1, AFFINE, affine=True, chunk=0, **CPU)
    for dispatch in (TB.dispatch_score_batch_codes,
                     TB.dispatch_align_batch_codes):
        kw = dict(affine=True, lut=lut, structure_weight=800)
        with pytest.raises(NotImplementedError, match="P15"):
            dispatch(codes, 1, AFFINE, mesh=object(), **kw, **CPU)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            dispatch(codes, 1, AFFINE, engine="cuda", device="cpu", **kw)


def test_align_defaults_are_the_cuda_engine_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.align_batch(_pairs()[:1], 1, AFFINE, affine=True)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.dispatch_align_batch_codes(
            [TB.encode_pair("ACD", "AC", "HHC", "HC")], 1, AFFINE,
            affine=True, lut=TB.match_mismatch_lut(100, 0),
            structure_weight=800)


def test_dispatch_returns_before_get(monkeypatch):
    """dispatch_* copies nothing back and decodes nothing: that is get()'s
    one copy.  Seen here by counting the host decodes."""
    decoded = []
    real = dtb.decode_codes
    monkeypatch.setattr(dtb, "decode_codes",
                        lambda codes: decoded.append(1) or real(codes))
    pairs = _pairs()
    pending = TB.dispatch_align_batch(pairs, 1, AFFINE, affine=True,
                                      bucket_quantum=8, **CPU)
    assert isinstance(pending, TB.PendingAlignments)
    assert pending.n_dispatches == 3 and decoded == []
    for _idxs, _affine, dev in pending._parts:
        assert isinstance(dev, torch.Tensor) and dev.dim() == 2
    scores, _traces, _complete = pending.get()
    assert len(decoded) == len(pairs)
    assert (scores == _oracle_scores(pairs, 1, *AFFINE, True)).all()


def test_wrappers_take_the_kernel_for_a_cuda_tensor_only():
    """On CPU tensors a wrapper is its twin; the walks check what they are
    given."""
    pairs = _pairs(1, [(3, 4), (5, 5)])
    stacks = _stacks(pairs, 8, 8)
    bband, scores = cuda_dp.nonaffine_batch_bands(*stacks, 1, *NONAFFINE)
    twin, twin_scores = cuda_dp.nonaffine_batch_bands_plain(*stacks, 1,
                                                            *NONAFFINE)
    assert torch.equal(bband.ys, twin.ys) and torch.equal(scores, twin_scores)
    assert torch.equal(
        dtb.nonaffine_walk_batch(bband, *NONAFFINE, *stacks[:2]),
        dtb.nonaffine_walk_batch_plain(twin, *NONAFFINE, *stacks[:2]))
    with pytest.raises(ValueError, match="band"):
        cuda_dp.affine_batch_bands(*stacks, 1, *AFFINE,
                                   band=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not fit"):
        dtb.nonaffine_walk_batch(bband, *NONAFFINE, stacks[0][:1], stacks[1])


# -- the codes path ------------------------------------------------------------

PROTEIN = dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
               gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
               max_shift=1)


def _records(seed, count, lo=6, hi=14):
    import random
    return [(r.seqA, r.seqB, r.strA, r.strB)
            for r in _protein_records(random.Random(seed), count, lo, hi)]


def _host_tables(rec, params):
    seqA, seqB, strA, strB = rec
    return build_score_tables(preprocess_molecule(seqA, strA, is_rna=False),
                              preprocess_molecule(seqB, strB, is_rna=False),
                              params, is_rna=False)


@pytest.mark.parametrize("simmatrix", ["BLOSUM62", None])
def test_mu_planes_from_codes_match_jax_and_the_host_tables(simmatrix):
    """The module that builds a bucket's tables: equal to the JAX one-hot
    contraction on the JAX code stacks (lane and PACK padding stripped by
    code_stacks_from_jax), and to build_score_tables pair by pair, zero
    outside each pair's own rows and columns."""
    params = dict(PROTEIN, simmatrix=simmatrix)
    lut = (_sim_lut("BLOSUM62")[0] if simmatrix
           else TB.match_mismatch_lut(100, 0))
    recs = _records(3, 5) + [("", "AR", "", "CC"), ("W", "", "H", "")]
    pairs = [JB.encode_pair(*r) for r in recs]
    (key, packed), = JB._code_buckets(pairs, 16).items()
    N, M = key
    indices, ca, cb, sa, sb, ns, ms = packed
    want1, want2 = (np.asarray(a) for a in pallas_dp._mu_planes_from_codes(
        jnp.asarray(lut), *(jnp.asarray(a) for a in (ca, cb, sa, sb, ns, ms)),
        800))
    stacks = code_stacks_from_jax(ca, cb, sa, sb, ns, ms, len(recs), N, "cpu")
    assert stacks[0].dtype == torch.uint8 and stacks[0].shape == (7, N + 1)
    got1, got2 = cuda_dp.mu_planes_from_codes(torch.from_numpy(lut), *stacks,
                                              800)
    assert got1.dtype == got2.dtype == torch.int32
    assert got1.shape == (7, N + 1, M + 1) and got1.is_contiguous()
    assert (got1.numpy() == want1[:7, :N + 1]).all()
    assert (got2.numpy() == want2[:7, :N + 1]).all()
    for pos, rec in enumerate(recs):
        mu1, mu2 = _host_tables(rec, params)
        assert (got1[pos].numpy() == TB.pad_table(mu1, N, M)).all()
        assert (got2[pos].numpy() == TB.pad_table(mu2, N, M)).all()
    with pytest.raises(ValueError, match="lut"):
        cuda_dp.mu_planes_from_codes(torch.from_numpy(lut).long(), *stacks,
                                     800)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "nonaffine"])
def test_codes_dispatchers_match_jax_and_the_tables_path(affine):
    """dispatch_score_batch_codes and dispatch_align_batch_codes from raw
    protein pairs: equal to the JAX dispatchers and to the port's tables
    path on the host tables of the same pairs."""
    params = AFFINE if affine else NONAFFINE
    recs = _records(3, 8)
    lut = _sim_lut("BLOSUM62")[0]
    kw = dict(affine=affine, lut=lut, structure_weight=800, bucket_quantum=8)
    tables = [_host_tables(r, PROTEIN) for r in recs]
    want = TB.align_batch(tables, 1, params, affine=affine, bucket_quantum=8,
                          **CPU)
    _assert_alignments(want, _oracle_alignments(tables, 1, affine, params))

    pairs = [TB.encode_pair(*r) for r in recs]
    scores = TB.dispatch_score_batch_codes(pairs, 1, params, **kw, **CPU)
    assert isinstance(scores, TB.PendingScores)
    assert (scores.get() == want[0]).all()
    assert (scores.get() == JB.dispatch_score_batch_codes(
        [JB.encode_pair(*r) for r in recs], 1, params, **kw).get()).all()
    assert (scores.get() == TB.score_batch(tables, 1, params, affine=affine,
                                           bucket_quantum=8, **CPU)).all()

    for chunk in (None, 3):
        got = TB.dispatch_align_batch_codes(pairs, 1, params, chunk=chunk,
                                            **kw, **CPU)
        assert isinstance(got, TB.PendingAlignments)
        _assert_alignments(got.get(), want)
    _assert_alignments(want, JB.dispatch_align_batch_codes(
        [JB.encode_pair(*r) for r in recs], 1, params, **kw).get())
    # the table may lie on the device already: used as it is
    resident = torch.from_numpy(lut)
    got = TB.dispatch_align_batch_codes(
        pairs, 1, params, **dict(kw, lut=resident), **CPU).get()
    _assert_alignments(got, want)
    assert resident._bialign_peak == (0, int(np.abs(lut).max()))


def test_codes_path_scores_a_large_table_exactly():
    """The table of tests/test_conveyor.py:246, match 1 << 24: the JAX
    package refuses it (its one-hot float32 contraction would round); the
    port indexes the table and scores it exactly.  Odd entries above 2^24
    have no float32 form at all."""
    lut = TB.match_mismatch_lut((1 << 24) + 1, -3)
    rec = ("AR", "AR", "CC", "CC")
    with pytest.raises(ValueError, match="2\\^24"):
        JB.dispatch_score_batch_codes([JB.encode_pair(*rec)], 1, AFFINE,
                                      affine=True, lut=lut,
                                      structure_weight=100)
    kw = dict(affine=True, lut=lut, structure_weight=100, bucket_quantum=2)
    got = TB.dispatch_score_batch_codes([TB.encode_pair(*rec)], 1, AFFINE,
                                        **kw, **CPU).get()
    mu1 = np.zeros((3, 3), dtype=np.int32)
    mu1[1:, 1:] = lut[np.ix_([65, 82], [65, 82])]
    mu2 = np.zeros((3, 3), dtype=np.int32)
    mu2[1:, 1:] = 100
    want = _oracle_scores([(mu1, mu2)], 1, *AFFINE, True)
    assert got.tolist() == want.tolist() == [2 * ((1 << 24) + 1) + 200]
    aligned = TB.dispatch_align_batch_codes([TB.encode_pair(*rec)], 1,
                                            AFFINE, **kw, **CPU).get()
    _assert_alignments(aligned, _oracle_alignments([(mu1, mu2)], 1, True,
                                                   AFFINE))
    # at the default bucket_quantum the drift bound over a 64 x 64 bucket
    # refuses it, as any table this large
    with pytest.raises(ValueError, match="int32"):
        TB.dispatch_score_batch_codes([TB.encode_pair(*rec)], 1, AFFINE,
                                      **dict(kw, bucket_quantum=64), **CPU)


def test_codes_path_unknown_residue_raises_key_error():
    with pytest.raises(KeyError):
        TB.encode_pair("ARΩ", "ARN", "CCC", "CCC")


def test_codes_path_checks_the_table():
    pairs = [TB.encode_pair("ACD", "AC", "HHC", "HC")]
    kw = dict(affine=True, structure_weight=800)
    with pytest.raises(ValueError, match="256"):
        TB.dispatch_score_batch_codes(pairs, 1, AFFINE,
                                      lut=np.zeros((4, 4), np.int32), **kw,
                                      **CPU)
    empty = TB.dispatch_score_batch_codes([], 1, AFFINE,
                                          lut=TB.match_mismatch_lut(1, 0),
                                          **kw, **CPU)
    assert empty.get().shape == (0,)


# -- a golden at max_shift 3 -----------------------------------------------------

# The toy protein pair of the README at max_shift 3: computed with the JAX
# package (engines "xla" and "numpy" agree).  Its optimum needs no shift
# beyond 1, so the score is the max_shift 1 golden's.
TOY_MS3 = dict(G.TOY_PROTEIN_PARAMS, max_shift=3, outmode="default")
TOY_MS3_SCORE = 48500
TOY_MS3_OUT = [
    "A               -RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYAR-FR",
    "B               -KAKLPLKEKKLTRTANYHPGIRYIMTGYSAKRIYSSTYAY-FR",
    "A ss            CHHHHHHHHHHHH-HCCCCTCEEEEEEECCTC-EEEEEEEECCC",
    "B ss            -HHHHHHHHHHHHCCCCCCTCEEEEEEECCCCCEEEEEEEE-CC",
    "A shifts        >............<..................<........>..",
    "B shifts        ............................................",
]
# The same sequence twice, the second structure five residues late: only
# max_shift 3 (3 + 2 shifts) brings the structures together; max_shift 2
# scores 43950.
OFFSET5 = dict(seqA=G.TOY_PROTEIN["seqA"], seqB=G.TOY_PROTEIN["seqA"],
               strA=G.TOY_PROTEIN["strA"],
               strB="CCCCC" + G.TOY_PROTEIN["strA"][:-5])
OFFSET5_SCORES = {2: 43950, 3: 49200}
OFFSET5_MS3_OUT = [
    "A               RAKL--PLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR---",
    "B               RAKL--PLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR---",
    "A ss            C-----HHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEEEECCC",
    "B ss            CCCCCCHHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEE-----",
    "A shifts        .<<<........................................>>>",
    "B shifts        ....>>....................................<<...",
]


@pytest.mark.parametrize("mol,score,lines", [
    (G.TOY_PROTEIN, TOY_MS3_SCORE, TOY_MS3_OUT),
    (OFFSET5, OFFSET5_SCORES[3], OFFSET5_MS3_OUT),
], ids=["toy_protein", "structure_offset_5"])
def test_max_shift_3_golden(mol, score, lines):
    """Through BiAligner and through align_batch (a batch of two)."""
    ba = BiAligner(**mol, **TOY_MS3, **CPU)
    assert ba.optimize() == score
    assert list(ba.decode_trace()) == lines
    costs = (ba.beta, ba.gamma, ba.delta)
    scores, traces, complete = TB.align_batch(
        [(ba.mu1, ba.mu2)] * 2, 3, costs, affine=True, **CPU)
    assert scores.tolist() == [score] * 2 and complete == [True] * 2
    assert all(list(ba.decode_trace(t)) == lines for t in traces)


def test_max_shift_3_golden_needs_the_wide_band():
    ba = BiAligner(**OFFSET5, **dict(TOY_MS3, max_shift=2), **CPU)
    assert ba.optimize() == OFFSET5_SCORES[2]
