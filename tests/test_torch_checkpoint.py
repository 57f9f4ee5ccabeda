"""The port's checkpointed low-memory path (plain twins on the CPU) against
the JAX package's: the checkpointed fills (XLA scan, and the Pallas kernels
K9/K11 in interpret mode), the block fills (``_affine_block`` /
``_nonaffine_block`` and K10/K12 in interpret mode), the blockwise walks and
``BiAligner(lowmem=True)``, with the numpy oracle beside them.  All values
are int32 DP scores, states and column codes: compared for equality."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden as G
from bialign_tpu import BiAligner as JaxBiAligner
from bialign_tpu.ops import checkpoint_dp as jck
from bialign_tpu.ops import reference_dp
from bialign_tpu.ops.cases import NonAffineTables
from bialign_tpu.ops.device_traceback import _affine_const
from test_pallas import _rand_pair
from test_torch_align import (OFFSET5, OFFSET5_MS3_OUT, OFFSET5_SCORES,
                              TOY_MS3, TOY_MS3_OUT, TOY_MS3_SCORE)

from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.convert import checkpoint_band_from_jax, tables_to_torch
from bialign_tpu_torch.ops import checkpoint_dp as ck
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb

AFFINE = (-150, -50, -150)
NONAFFINE = (-200, -250)
CPU = dict(engine="torch", device="cpu")
# (n, m, S): every max_shift, a sequence of length 0 on either side
SHAPES = [(9, 11, 1), (7, 9, 0), (8, 6, 2), (6, 8, 3), (0, 5, 1), (6, 0, 2)]
BLOCKS = [1, 2, 4, 7, None, 1000]      # None: default_block; 1000 > n + m
# the cases that also run against the JAX package (one jit each)
JAX_CASES = [(9, 11, 1, 1), (9, 11, 1, 4), (9, 11, 1, None), (7, 9, 0, 2),
             (8, 6, 2, 7), (6, 8, 3, 1000), (0, 5, 1, 2), (6, 0, 2, 4)]
PALLAS_CASES = [(9, 11, 1, None), (20, 17, 1, 16), (6, 8, 2, None)]
KINDS = [True, False]                   # affine
IDS = ["affine", "nonaffine"]


def _pair(n, m, S):
    return _rand_pair(np.random.default_rng(n * 43 + m * 5 + S), n, m)


def _costs(affine):
    return AFFINE if affine else NONAFFINE


def _garbage(rng, shape):
    """Memory holding arbitrary int32 values, the extremes included."""
    a = rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)
    a.flat[::7] = np.iinfo(np.int32).max
    a.flat[3::11] = np.iinfo(np.int32).min
    return torch.from_numpy(a)


def _fill(affine, t1, t2, S, block, **kw):
    fill = (ck.fill_affine_checkpoint_plain if affine
            else ck.fill_nonaffine_checkpoint_plain)
    return fill(t1, t2, S, *_costs(affine), block=block, **kw)


def _band(affine, t1, t2, S):
    fill = cuda_dp.fill_affine_plain if affine else cuda_dp.fill_nonaffine_plain
    return fill(t1, t2, S, *_costs(affine))


@functools.lru_cache(maxsize=None)
def _shape_band(affine, n, m, S):
    """(the full band of a shape of SHAPES, the oracle's score)."""
    mu1, mu2 = _pair(n, m, S)
    if affine:
        H = reference_dp.fill_affine(mu1, mu2, S, *AFFINE)
        want = reference_dp.affine_score_from_band(H, n, m, S)
    else:
        H = reference_dp.fill_nonaffine(mu1, mu2, S, *NONAFFINE)
        want = reference_dp.nonaffine_score_from_band(H, n, m, S)
    return _band(affine, *tables_to_torch(mu1, mu2, "cpu"), S), want


def _genuine(n, m, S, d):
    """bool ``[W, W, n+1]``: the genuine cells of diagonal d's slab (a live
    row, k and l inside the pair); all False for d < 0."""
    i = np.arange(n + 1)[None, None, :]
    j = d - i
    k = i + np.arange(2 * S + 1)[:, None, None] - S
    l = j + np.arange(2 * S + 1)[None, :, None] - S
    return ((j >= 0) & (j <= m) & (k >= 0) & (k <= n) & (l >= 0) & (l <= m))


def _assert_slab(got, want, n, m, S, d, what):
    ok = _genuine(n, m, S, d)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.where(ok, got == want, True).all(), what


@functools.lru_cache(maxsize=None)
def _jax_band(n, m, S, block, affine, pallas=False):
    """(the JAX CheckpointBand, mu1, mu2) of one case."""
    mu1, mu2 = _pair(n, m, S)
    name = ("fill_affine_checkpoint" if affine
            else "fill_nonaffine_checkpoint") + ("_pallas" if pallas else "")
    return (getattr(jck, name)(mu1, mu2, S, *_costs(affine), block=block),
            mu1, mu2)


def _port_slab(x, p_last):
    """A JAX slab ``[..., P, W, W]`` or ``[..., W, W, Ppad]`` with the rows
    last, as the port has them (padding kept)."""
    x = np.asarray(x)
    return x if p_last else np.moveaxis(x, -3, -1)


# -- the checkpointed fill ---------------------------------------------------

@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n,m,S", SHAPES)
def test_checkpoints_are_the_bands_diagonals(n, m, S, block, affine):
    """On a ring and a checkpoint buffer of garbage: ``final`` is the band's
    last diagonal, ``ckpts[b]`` its diagonals bC-1 and bC-2, ``ckpts[0]`` is
    not written, and the score is the score-only twin's and the oracle's."""
    mu1, mu2 = _pair(n, m, S)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    rng = np.random.default_rng(7)
    W = 2 * S + 1
    slab = ((9,) if affine else ()) + (W, W, n + 1)
    C = block or ck.default_block(n + m + 1)
    NB = (n + m) // C + 1
    junk = _garbage(rng, (NB, 2, *slab))
    cb = _fill(affine, t1, t2, S, block, ring=_garbage(rng, (3, *slab)),
               ckpts=junk.clone())
    assert (cb.block, cb.n_blocks, tuple(cb.ckpts.shape)) == (
        C, NB, (NB, 2, *slab))
    band, want = _shape_band(affine, n, m, S)
    _assert_slab(cb.final, band.ys[n + m], n, m, S, n + m, "final")
    assert torch.equal(cb.ckpts[0], junk[0])
    for b in range(1, NB):
        for x in (0, 1):
            d = b * C - 1 - x
            _assert_slab(cb.ckpts[b, x], band.ys[d], n, m, S, d,
                         f"ckpts[{b}, {x}]")
    score = (cuda_dp.affine_score_plain if affine
             else cuda_dp.nonaffine_score_plain)
    assert score(t1, t2, S, *_costs(affine)) == want
    assert cb.final_score() == band.final_score() == want


def _assert_checkpoints_equal(cb, jcb, carried):
    """The port's checkpoints, the JAX package's and those carried over,
    on the genuine cells of the diagonals they hold."""
    n, m, S, C = cb.n, cb.m, cb.max_shift, cb.block
    assert carried.block == C == jcb.block
    assert carried.ckpts.shape == cb.ckpts.shape
    assert carried.final.shape == cb.final.shape
    jfinal = _port_slab(jcb.final, jcb.p_last)[..., :n + 1]
    for got in (carried.final, jfinal):
        _assert_slab(cb.final, got, n, m, S, n + m, "final")
    jckpts = _port_slab(jcb.ckpts, jcb.p_last)[..., :n + 1]
    for b in range(1, cb.n_blocks):
        for x in (0, 1):
            for got in (carried.ckpts[b, x], jckpts[b, x]):
                _assert_slab(cb.ckpts[b, x], got, n, m, S, b * C - 1 - x,
                             f"ckpts[{b}, {x}]")
    assert cb.final_score() == carried.final_score() == jcb.final_score()


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("n,m,S,block", JAX_CASES)
def test_checkpoint_twin_matches_the_xla_scan(n, m, S, block, affine):
    jcb, mu1, mu2 = _jax_band(n, m, S, block, affine)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    cb = _fill(affine, t1, t2, S, block)
    _assert_checkpoints_equal(cb, jcb, checkpoint_band_from_jax(jcb, mu1, mu2))


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("n,m,S,block", PALLAS_CASES)
def test_checkpoint_twin_matches_the_pallas_kernels(n, m, S, block, affine):
    """K9 / K11 in interpret mode; their block size is rounded up to the
    kernel's quantum, and the port takes that size as given."""
    jcb, mu1, mu2 = _jax_band(n, m, S, block, affine, pallas=True)
    assert jcb.p_last
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    cb = _fill(affine, t1, t2, S, jcb.block)
    _assert_checkpoints_equal(cb, jcb, checkpoint_band_from_jax(jcb, mu1, mu2))


def test_checkpoint_band_from_jax_rejects_other_shapes():
    jcb, mu1, mu2 = _jax_band(9, 11, 1, 4, True)
    with pytest.raises(ValueError, match="tables"):
        checkpoint_band_from_jax(jcb, mu1[:-1], mu2[:-1])
    import dataclasses
    short = dataclasses.replace(jcb, ckpts=jcb.ckpts[:2])
    with pytest.raises(ValueError, match="JAX checkpoints"):
        checkpoint_band_from_jax(short, mu1, mu2)


# -- one block's band --------------------------------------------------------

def _block(affine, cb, b, **kw):
    fn = ck.affine_block_plain if affine else ck.nonaffine_block_plain
    return fn(cb, b, **kw)


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n,m,S", SHAPES)
def test_blocks_are_the_bands_diagonals(n, m, S, block, affine):
    """Every block recomputed into a window of garbage: slab x is diagonal
    d0 - 2 + x of the full band on its genuine cells, and nothing but the
    checkpoint slabs and the live rows of the block's diagonals is
    written."""
    t1, t2 = tables_to_torch(*_pair(n, m, S), "cpu")
    cb = _fill(affine, t1, t2, S, block)
    band, _score = _shape_band(affine, n, m, S)
    C = cb.block
    assert cb.window_shape[0] == min(C, n + m + 1) + 2
    rng = np.random.default_rng(11)
    i = np.arange(n + 1)
    for b in range(cb.n_blocks):
        junk = _garbage(rng, cb.window_shape)
        window = _block(affine, cb, b, window=junk.clone())
        for x in range(cb.window_shape[0]):
            d = b * C - 2 + x
            if x < 2 and b:
                assert torch.equal(window[x], cb.ckpts[b, 1 - x])
                continue
            live = torch.from_numpy((i <= d) & (d - i <= m) & (d - i >= 0)
                                    & (d <= n + m) & (x >= 2))
            assert torch.equal(window[x][..., ~live], junk[x][..., ~live])
            if 0 <= d <= n + m:
                _assert_slab(window[x], band.ys[d], n, m, S, d,
                             f"block {b} slab {x}")


def _jax_block(jcb, b, from_ckpts=None):
    """Block b of the JAX band, ``[C+2, ...]`` rows last; ``from_ckpts``:
    from these checkpoints (a port's, in the JAX layout) instead."""
    if from_ckpts is not None:
        import dataclasses
        jcb = dataclasses.replace(jcb, ckpts=jnp.asarray(from_ckpts))
    return _port_slab(jcb._recompute(b), jcb.p_last)[..., :jcb.n + 1]


def _jax_layout(ckpts, jcb):
    """The port's checkpoints ``[NB, 2, ..., W, W, n+1]`` in the layout and
    padding of the JAX band's."""
    a = ckpts.numpy()
    if not jcb.p_last:
        return np.moveaxis(a, -1, -3)
    out = np.full(jcb.ckpts.shape, cuda_dp.INVALID, dtype=np.int32)
    out[:a.shape[0], ..., :a.shape[-1]] = a
    return out


def _assert_blocks_equal(affine, cb, jcb, carried):
    n, m, S, C = cb.n, cb.m, cb.max_shift, cb.block
    own = _jax_layout(cb.ckpts, jcb)
    for b in range(cb.n_blocks):
        got = _block(affine, cb, b)
        others = (_block(affine, carried, b), _jax_block(jcb, b),
                  _jax_block(jcb, b, from_ckpts=own))
        for x in range(2 if b else 2, cb.window_shape[0]):
            d = b * C - 2 + x
            if d > n + m:
                break
            for other in others:
                _assert_slab(got[x], other[x], n, m, S, d,
                             f"block {b} slab {x}")


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("n,m,S,block", JAX_CASES)
def test_block_twin_matches_the_xla_blocks(n, m, S, block, affine):
    """From the port's own checkpoints, from the JAX package's carried over,
    and the JAX block from the port's checkpoints: the same diagonals."""
    jcb, mu1, mu2 = _jax_band(n, m, S, block, affine)
    cb = _fill(affine, *tables_to_torch(mu1, mu2, "cpu"), S, block)
    _assert_blocks_equal(affine, cb, jcb,
                         checkpoint_band_from_jax(jcb, mu1, mu2))


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("n,m,S,block", PALLAS_CASES[:2])
def test_block_twin_matches_the_pallas_blocks(n, m, S, block, affine):
    """K10 / K12 in interpret mode."""
    jcb, mu1, mu2 = _jax_band(n, m, S, block, affine, pallas=True)
    cb = _fill(affine, *tables_to_torch(mu1, mu2, "cpu"), S, jcb.block)
    _assert_blocks_equal(affine, cb, jcb,
                         checkpoint_band_from_jax(jcb, mu1, mu2))


# -- the blockwise walk ------------------------------------------------------

def _jax_walk_states(jcb, mu1, mu2):
    """The JAX blockwise walk, block by block as its traceback drives it:
    [(b, state after the block, codes so far)]."""
    n, m, S, C = jcb.n, jcb.m, jcb.max_shift, jcb.block
    mu1j, mu2j = jnp.asarray(mu1), jnp.asarray(mu2)
    if jcb.affine:
        const = jnp.asarray(_affine_const(*jcb.params))
        fin = _port_slab(jcb.final, jcb.p_last)[:, S, S, n]
        intrinsic = np.asarray([abs(s[0] - s[2]) + abs(s[1] - s[3])
                                for s in jck.STATES])
        q = int(np.argmin(np.where(fin == fin.max(), intrinsic, 1 << 20)))
        st = dict(i=n, j=m, k=n, l=m, q=q, netA=0, netB=0, first=True)
        walk = jck._affine_blk_walk
    else:
        const = jnp.asarray(NonAffineTables(*jcb.params).const)
        st = dict(i=n, j=m, k=n, l=m)
        walk = jck._nonaffine_blk_walk
    keys = list(st)
    codes, seen = [], []
    for b in range((n + m) // C, -1, -1):
        st = {k: (jnp.bool_(v) if k == "first" else jnp.int32(v))
              for k, v in st.items()}
        out = walk(jcb._recompute(b), mu1j, mu2j, const, S, n, C,
                   jnp.int32(b * C), st, jcb.p_last)
        codes += np.asarray(out["trace"])[:int(out["step"])].tolist()
        st = {k: int(out[k]) for k in keys}
        seen.append((b, [st[k] for k in keys], list(codes)))
        if int(out["done"]):
            break
    return seen


def _assert_walks_equal(affine, cb, jcb, mu1, mu2):
    walk_fn = (ck.affine_block_walk_plain if affine
               else ck.nonaffine_block_walk_plain)
    walk = ck.new_walk(cb)
    got = {}
    for b in range(cb.n_blocks - 1, -1, -1):
        walk_fn(cb, b, _block(affine, cb, b), walk)
        steps = int(walk[ck.STATE])
        got[b] = (walk[:ck.STATE].tolist(),
                  walk[ck.STATE + 3:ck.STATE + 3 + steps].tolist())
    seen = _jax_walk_states(jcb, mu1, mu2)
    assert seen and seen[0][0] == cb.n_blocks - 1
    for b, state, codes in seen:
        assert got[b][0][:len(state)] == state, f"state after block {b}"
        assert got[b][1] == codes, f"codes after block {b}"
    # the blocks below the one that ended the JAX walk add nothing
    assert got[0][1] == seen[-1][2]


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("n,m,S,block", JAX_CASES)
def test_block_walk_twin_matches_the_jax_walk(n, m, S, block, affine):
    """State (i, j, k, l, q, netA, netB, first) and codes after every
    block."""
    jcb, mu1, mu2 = _jax_band(n, m, S, block, affine)
    cb = _fill(affine, *tables_to_torch(mu1, mu2, "cpu"), S, block)
    _assert_walks_equal(affine, cb, jcb, mu1, mu2)
    carried = checkpoint_band_from_jax(jcb, mu1, mu2)
    _assert_walks_equal(affine, carried, jcb, mu1, mu2)


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n,m,S", SHAPES)
def test_blockwise_traceback_is_the_full_band_walk(n, m, S, block, affine):
    """The same column at every step, whatever the block size."""
    t1, t2 = tables_to_torch(*_pair(n, m, S), "cpu")
    cb = _fill(affine, t1, t2, S, block)
    band, _score = _shape_band(affine, n, m, S)
    if affine:
        assert (ck.affine_traceback_plain(cb, *AFFINE)
                == dtb.affine_traceback_plain(band, *AFFINE, t1, t2))
    else:
        assert (ck.nonaffine_traceback_plain(cb, *NONAFFINE)
                == dtb.nonaffine_traceback_plain(band, *NONAFFINE, t1, t2))


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
def test_a_walk_that_does_not_end_is_not_returned_as_a_trace(affine,
                                                             monkeypatch):
    """A walk that has neither ended nor reached the origin after block 0
    (here: its room for codes ran out) raises; no trace is returned."""
    t1, t2 = tables_to_torch(*_pair(9, 11, 1), "cpu")
    cb = _fill(affine, t1, t2, 1, 4)
    monkeypatch.setattr(ck, "walk_capacity", lambda n, m: 5)
    if affine:
        with pytest.raises(RuntimeError, match="neither reached the origin"):
            ck.affine_traceback_plain(cb, *AFFINE)
    else:
        with pytest.raises(RuntimeError, match="not at the origin"):
            ck.nonaffine_traceback_plain(cb, *NONAFFINE)


def test_a_stuck_affine_walk_is_incomplete():
    """A window whose values do not follow from one another stops the affine
    walk (done 2); the blocks below add nothing, and the traceback reports
    ``complete`` False, as the band path's walk does."""
    t1, t2 = tables_to_torch(*_pair(9, 11, 1), "cpu")
    cb = _fill(True, t1, t2, 1, 4)
    walk = ck.new_walk(cb)
    b = cb.n_blocks - 1
    window = _block(True, cb, b)
    noise = np.random.default_rng(5).integers(1, 1000, window.shape)
    ck.affine_block_walk_plain(
        cb, b, window + torch.from_numpy(noise.astype(np.int32)), walk)
    assert int(walk[ck.STATE + 1]) == 2
    stuck = walk.clone()
    ck.affine_block_walk_plain(cb, b - 1, _block(True, cb, b - 1), walk)
    assert torch.equal(walk, stuck)
    steps = int(walk[ck.STATE])
    trace, complete = ck._affine_result(
        walk[ck.STATE + 3:ck.STATE + 3 + steps].numpy(), 2,
        walk[:ck.STATE].numpy())
    assert not complete and len(trace) == steps


# -- cells -------------------------------------------------------------------

@pytest.mark.parametrize("affine", KINDS, ids=IDS)
@pytest.mark.parametrize("block", [1, 4, None])
def test_cells_equal_the_bands_cells(block, affine):
    n, m, S = 9, 11, 2
    t1, t2 = tables_to_torch(*_pair(n, m, S), "cpu")
    cb = _fill(affine, t1, t2, S, block)
    band = _band(affine, t1, t2, S)
    rng = np.random.default_rng(3)
    i = rng.integers(0, n + 1, 200)
    j = rng.integers(0, m + 1, 200)
    k = np.clip(i + rng.integers(-S, S + 1, 200), 0, n)
    l = np.clip(j + rng.integers(-S, S + 1, 200), 0, m)
    idx = np.stack(([rng.integers(0, 9, 200)] if affine else [])
                   + [i, j, k, l], axis=1)
    got = cb.cells(idx)
    assert got.dtype == np.int32 and got.shape == (200,)
    assert np.array_equal(got, band.cells(idx))
    assert np.array_equal(cb.cells(idx, plain=True), got)


# -- BiAligner(lowmem=True) --------------------------------------------------

def _aligners(mol, params, block, jax_engine):
    port = BiAligner(**mol, **params, lowmem=True, checkpoint_block=block,
                     **CPU)
    jax_ck = JaxBiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                          mol.get("strB"), engine=jax_engine, lowmem=True,
                          checkpoint_block=block, **params)
    oracle = JaxBiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                          mol.get("strB"), engine="numpy", **params)
    band = BiAligner(**mol, **params, **CPU)
    return port, jax_ck, oracle, band


def _assert_same_alignment(port, jax_ck, oracle, band, score):
    assert port.optimize() == score
    assert jax_ck.optimize() == oracle.optimize() == band.optimize() == score
    assert isinstance(port._band, ck.CheckpointBand)
    trace = port.traceback()
    cols = [tuple(int(v) for v in c) for c in trace]
    for other in (jax_ck, oracle, band):
        assert cols == [tuple(int(v) for v in c) for c in other.traceback()]
    lines = list(port.decode_trace())
    assert lines == list(jax_ck.decode_trace()) == list(oracle.decode_trace())
    assert lines == list(band.decode_trace())


@pytest.mark.parametrize("block", [None, 4, 7, 1000])
def test_affine_rna_lowmem_parity(block):
    _assert_same_alignment(
        *_aligners(G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS, block, "xla"),
        G.TOY_RNA_AFFINE_SCORE)


@pytest.mark.parametrize("block", [None, 5])
def test_nonaffine_rna_lowmem_parity(block):
    _assert_same_alignment(
        *_aligners(G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS, block, "xla"),
        G.TOY_RNA_NONAFFINE_SCORE)


def test_affine_protein_lowmem_parity():
    _assert_same_alignment(
        *_aligners(G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS, None, "xla"),
        G.TOY_PROTEIN_SCORE)


@pytest.mark.parametrize("jax_engine,block", [("xla", 6), ("pallas", None)])
def test_nonaffine_eval_trace_reads_cells_through_the_blocks(jax_engine,
                                                             block):
    port, jax_ck, oracle, band = _aligners(
        G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS, block, jax_engine)
    for ba in (port, jax_ck, oracle, band):
        ba.optimize()
    lines = list(port.eval_trace())
    assert lines == list(jax_ck.eval_trace()) == list(oracle.eval_trace())
    assert lines == list(band.eval_trace())


def test_affine_eval_trace_replays_the_lowmem_trace():
    port, jax_ck, _oracle, _band = _aligners(
        G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS, 4, "xla")
    lines = list(port.eval_trace())
    assert lines == list(jax_ck.eval_trace())
    assert lines[-1].split(" --> ")[-1] == str(G.TOY_RNA_AFFINE_SCORE)


@pytest.mark.parametrize("affine", KINDS, ids=IDS)
def test_lowmem_memory_is_sublinear(affine):
    """O(sqrt(D)) slabs are kept and O(sqrt(D)) more recomputed at a time,
    and the band holds no table with a diagonal axis."""
    params = (G.TOY_PROTEIN_PARAMS if affine
              else dict(G.TOY_PROTEIN_PARAMS, gap_opening_cost=0))
    ba = BiAligner(**G.TOY_PROTEIN, **params, lowmem=True, **CPU)
    ba.optimize()
    cb = ba._band
    D = cb.n + cb.m + 1
    assert cb.block == ck.default_block(D) == 14
    assert 2 * cb.n_blocks + 1 < D
    slab = cb.final.numel()
    held = cb.ckpts.numel() + 3 * slab + int(np.prod(cb.window_shape))
    assert held == (2 * cb.n_blocks + 3 + cb.block + 2) * slab
    assert held < D * slab // 2                  # the band: D slabs
    assert tuple(cb.mu1.shape) == tuple(cb.mu2.shape) == (cb.n + 1, cb.m + 1)
    tensors = [v for v in vars(cb).values() if isinstance(v, torch.Tensor)]
    assert len(tensors) == 4                    # ckpts, final, mu1, mu2


@pytest.mark.parametrize("block", [None, 40])
def test_affine_rna_lowmem_parity_with_the_pallas_engine(block):
    _assert_same_alignment(
        *_aligners(G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS, block, "pallas"),
        G.TOY_RNA_AFFINE_SCORE)


def test_nonaffine_rna_lowmem_parity_with_the_pallas_engine():
    _assert_same_alignment(
        *_aligners(G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS, None, "pallas"),
        G.TOY_RNA_NONAFFINE_SCORE)


def test_affine_protein_lowmem_parity_with_the_pallas_engine():
    _assert_same_alignment(
        *_aligners(G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS, None, "pallas"),
        G.TOY_PROTEIN_SCORE)


@pytest.mark.parametrize("block", [2, 7])
@pytest.mark.parametrize("mol,score,lines", [
    (G.TOY_PROTEIN, TOY_MS3_SCORE, TOY_MS3_OUT),
    (OFFSET5, OFFSET5_SCORES[3], OFFSET5_MS3_OUT),
], ids=["toy_protein", "structure_offset_5"])
def test_max_shift_3_goldens_through_small_blocks(mol, score, lines, block):
    """Many shifts and many block edges: the tie-break's running net shifts
    and the ``first`` flag must cross every one of them."""
    ba = BiAligner(**mol, **TOY_MS3, lowmem=True, checkpoint_block=block,
                   **CPU)
    assert ba.optimize() == score
    trace = ba.traceback()
    assert list(ba.decode_trace(trace)) == lines
    band = BiAligner(**mol, **TOY_MS3, **CPU)
    assert trace == band.traceback()


def test_checkpoint_block_0_is_the_default_block():
    ba = BiAligner(**G.TOY_RNA, **G.TOY_RNA_AFFINE_PARAMS, lowmem=True,
                   checkpoint_block=0, **CPU)
    assert ba.optimize() == G.TOY_RNA_AFFINE_SCORE
    assert ba._band.block == ck.default_block(ba._band.n + ba._band.m + 1)


# -- nothing hidden ----------------------------------------------------------

def test_cuda_engine_with_lowmem_refuses_a_cpu_device():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        BiAligner(**G.TOY_RNA, **G.TOY_RNA_AFFINE_PARAMS, lowmem=True,
                  engine="cuda", device="cpu")


def test_wrappers_run_the_plain_twins_for_cpu_tensors():
    t1, t2 = tables_to_torch(*_pair(7, 6, 1), "cpu")
    before = dict(ck.LAUNCHES)
    for affine, fill, block_fn, walk_fn, trace_fn, trace_plain in (
            (True, ck.fill_affine_checkpoint, ck.affine_block,
             ck.affine_block_walk, ck.affine_traceback,
             ck.affine_traceback_plain),
            (False, ck.fill_nonaffine_checkpoint, ck.nonaffine_block,
             ck.nonaffine_block_walk, ck.nonaffine_traceback,
             ck.nonaffine_traceback_plain)):
        costs = _costs(affine)
        cb = fill(t1, t2, 1, *costs, block=3)
        twin = _fill(affine, t1, t2, 1, 3)
        assert torch.equal(cb.ckpts, twin.ckpts)
        assert torch.equal(cb.final, twin.final)
        b = cb.n_blocks - 1
        window = block_fn(cb, b)
        assert torch.equal(window, _block(affine, twin, b))
        walk = ck.new_walk(cb)
        walk_fn(cb, b, window, walk)
        assert int(walk[ck.STATE]) > 0               # steps were taken
        assert trace_fn(cb, *costs) == trace_plain(twin, *costs)
    assert ck.LAUNCHES == before            # no kernel was launched


def test_wrappers_reject_what_does_not_fit():
    t1, t2 = tables_to_torch(*_pair(5, 4, 1), "cpu")
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="block"):
            ck.fill_affine_checkpoint(t1, t2, 1, *AFFINE, block=bad)
    with pytest.raises(ValueError, match="ring"):
        ck.fill_nonaffine_checkpoint(
            t1, t2, 1, *NONAFFINE,
            ring=torch.zeros((2, 3, 3, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="ckpts"):
        ck.fill_nonaffine_checkpoint(
            t1, t2, 1, *NONAFFINE, block=3,
            ckpts=torch.zeros((4, 2, 3, 3, 5), dtype=torch.int32))
    cb = ck.fill_affine_checkpoint(t1, t2, 1, *AFFINE, block=3)
    with pytest.raises(ValueError, match="non-affine"):
        ck.nonaffine_block(cb, 0)
    with pytest.raises(ValueError, match="block 4"):
        ck.affine_block(cb, 4)
    with pytest.raises(ValueError, match="window"):
        ck.affine_block(cb, 1, window=torch.zeros((5, 9, 3, 3, 5),
                                                  dtype=torch.int32))
    with pytest.raises(ValueError, match="costs"):
        ck.affine_traceback(cb, -1, -2, -3)
    with pytest.raises(ValueError, match="walk"):
        ck.affine_block_walk(cb, 3, ck.affine_block(cb, 3),
                             torch.zeros(5, dtype=torch.int32))
    with pytest.raises(TypeError):
        ck.affine_traceback(_band(True, t1, t2, 1), *AFFINE)
