"""The port's batched-scores path (plain twins on the CPU) against the JAX
package: ``parallel.batch.score_batch`` with ``engine="pallas"`` (K4-K7 in
interpret mode, as tests/test_batch.py runs them) and ``engine="xla"`` (the
vmapped scan), the batched Pallas entry points on the same stacks, the
conveyor K8 as tests/test_conveyor.py runs it, and the numpy oracle.  Scores
are int32 DP values, compared for equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bialign_tpu.ops import pallas_dp
from bialign_tpu.parallel import batch as JB
from test_batch import SIZES, _oracle_scores, _rand_pair
from test_conveyor import _conveyor_scores as jax_conveyor_scores
from test_conveyor import _oracle as conveyor_oracle
from test_conveyor import _rand_pair as conveyor_pair

from bialign_tpu_torch.convert import stacks_from_jax, tables_to_torch
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.parallel import batch as TB

AFFINE = (-150, -50, -150)          # beta, gamma, delta
NONAFFINE = (-200, -250)            # gamma, delta
CPU = dict(engine="torch", device="cpu")


def _pairs(seed=42, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [_rand_pair(rng, n, m) for n, m in sizes]


def _packed_pairs(seed):
    """The 16-pair (8, 8) bucket of tests/test_batch.py:123 and :351."""
    rng = np.random.default_rng(seed)
    return [_rand_pair(rng, 5 + (i % 4), 6 + (i % 3)) for i in range(16)]


def _oracle(pairs, S, affine):
    if affine:
        return _oracle_scores(pairs, S, *AFFINE, True)
    return _oracle_scores(pairs, S, 0, *NONAFFINE, False)


def _stacks(pairs, N, M):
    """One bucket's stacks and lengths as CPU tensors."""
    mu1p = TB.stack_padded([p[0] for p in pairs], N, M)
    mu2p = TB.stack_padded([p[1] for p in pairs], N, M)
    ns = np.asarray([p[0].shape[0] - 1 for p in pairs], dtype=np.int32)
    ms = np.asarray([p[0].shape[1] - 1 for p in pairs], dtype=np.int32)
    return tuple(torch.from_numpy(a) for a in (mu1p, mu2p, ns, ms))


def _garbage(seed, shape):
    """Rings holding arbitrary int32 values, the extremes included."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)
    ring.flat[::7] = np.iinfo(np.int32).max
    ring.flat[3::11] = np.iinfo(np.int32).min
    return torch.from_numpy(ring)


def _ring_shape(kind, B, S, P):
    W = 2 * S + 1
    return {"affine": (B, 3, 9, W, W, P), "nonaffine": (B, 3, W, W, P),
            "ms0": (B, 3, 3, P)}[kind]


def _twin(kind, stacks, S, ring=None):
    if kind == "affine":
        return cuda_dp.affine_batch_scores_plain(*stacks, S, *AFFINE,
                                                 ring=ring)
    if kind == "nonaffine":
        return cuda_dp.nonaffine_batch_scores_plain(*stacks, S, *NONAFFINE,
                                                    ring=ring)
    assert S == 0
    return cuda_dp.affine_ms0_batch_scores_plain(*stacks, *AFFINE, ring=ring)


def _pair_plain(kind, mu1, mu2, S):
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    if kind == "affine":
        return cuda_dp.affine_score_plain(t1, t2, S, *AFFINE)
    if kind == "nonaffine":
        return cuda_dp.nonaffine_score_plain(t1, t2, S, *NONAFFINE)
    return cuda_dp.affine_ms0_score_plain(t1, t2, *AFFINE)


# one Pallas compile per (bucket, S): the JAX kernels run where
# tests/test_batch.py runs them, the vmapped scan everywhere
JAX_ENGINES = {("affine", 0): ("xla",), ("affine", 1): ("pallas", "xla"),
               ("affine", 2): ("xla",), ("affine", 3): ("xla",),
               ("nonaffine", 0): ("xla",), ("nonaffine", 1): ("pallas",),
               ("nonaffine", 2): ("xla",), ("nonaffine", 3): ("xla",)}


@pytest.mark.parametrize("kind,S", list(JAX_ENGINES))
def test_score_batch_matches_jax_and_oracle(kind, S):
    """The slice as a whole on the SIZES of tests/test_batch.py at
    bucket_quantum 8: three buckets on the narrow bands, input order kept;
    on the wide ones the five pairs of the (8, 8) bucket, since the JAX
    side compiles once per bucket."""
    affine = kind == "affine"
    params = AFFINE if affine else NONAFFINE
    pairs = [p for p in _pairs() if S <= 1 or max(p[0].shape) <= 9]
    want = _oracle(pairs, S, affine)
    got = TB.score_batch(pairs, S, params, affine=affine, bucket_quantum=8,
                         **CPU)
    assert got.dtype == np.int64 and (got == want).all()
    for engine in JAX_ENGINES[kind, S]:
        assert (got == JB.score_batch(pairs, S, params, affine=affine,
                                      bucket_quantum=8, engine=engine)).all()


# (n, m) in one (8, 8) bucket: empty sequences, the bucket's own size, and
# pairs far shorter than it
MIXED = [(0, 5), (6, 0), (8, 8), (1, 1), (8, 2), (0, 0), (3, 8), (5, 7)]


@pytest.mark.parametrize("kind,S", [("affine", 0), ("affine", 1),
                                    ("affine", 2), ("nonaffine", 0),
                                    ("nonaffine", 1), ("nonaffine", 2),
                                    ("ms0", 0)])
def test_batch_twin_on_garbage_rings_matches_per_pair_twin(kind, S):
    """Bucket geometry against each pair alone on its true-size tables:
    padding, a neighbour's length and the rings' contents change nothing."""
    pairs = _pairs(3 + S, MIXED)
    stacks = _stacks(pairs, 8, 8)
    want = [_pair_plain(kind, mu1, mu2, S) for mu1, mu2 in pairs]
    ring = _garbage(S, _ring_shape(kind, len(pairs), S, 9))
    assert _twin(kind, stacks, S, ring).tolist() == want
    assert _twin(kind, stacks, S).tolist() == want
    if kind == "ms0":
        assert _twin("affine", stacks, 0).tolist() == want


@pytest.mark.parametrize("kind", ["affine", "nonaffine"])
def test_packed_bucket_matches_pallas_and_oracle(kind):
    """The bucket of test_packed_batched_kernel_matches_oracle (K6 on the
    JAX side), through the twins and through the wrappers on both routes."""
    affine = kind == "affine"
    params = AFFINE if affine else NONAFFINE
    pairs = _packed_pairs(11)
    want = _oracle(pairs, 1, affine)
    jax_scores = JB.score_batch(pairs, 1, params, affine=affine,
                                bucket_quantum=8, engine="pallas")
    assert (jax_scores == want).all()
    stacks = _stacks(pairs, 8, 8)
    ring = _garbage(5, _ring_shape(kind, 16, 1, 9))
    assert (_twin(kind, stacks, 1, ring).numpy() == want).all()
    wrapper = (cuda_dp.affine_batch_scores if affine
               else cuda_dp.nonaffine_batch_scores)
    for route in (None, "grid", "cta"):
        got = wrapper(*stacks, 1, *params, route=route)
        assert got.dtype == torch.int32 and (got.numpy() == want).all()


def test_ms0_bucket_matches_pallas_and_oracle():
    """The bucket of test_packed_ms0_specialized_matches_oracle (K7 on the
    JAX side): the three-state twin, the nine-state twin at max_shift 0 and
    the wrapper, which takes the three-state form on the "cta" route."""
    pairs = _packed_pairs(23)
    want = _oracle(pairs, 0, True)
    assert (JB.score_batch(pairs, 0, AFFINE, affine=True, bucket_quantum=8,
                           engine="pallas") == want).all()
    stacks = _stacks(pairs, 8, 8)
    assert (_twin("ms0", stacks, 0, _garbage(1, (16, 3, 3, 9))).numpy()
            == want).all()
    assert (_twin("affine", stacks, 0).numpy() == want).all()
    for route, shape in (("cta", (16, 3, 3, 9)),
                         ("grid", (16, 3, 9, 1, 1, 9))):
        got = cuda_dp.affine_batch_scores(*stacks, 0, *AFFINE, route=route,
                                          ring=_garbage(2, shape))
        assert (got.numpy() == want).all()
    assert [_pair_plain("ms0", mu1, mu2, 0) for mu1, mu2 in pairs] \
        == want.tolist()


def test_bucket_of_more_than_128_rows():
    """Pairs longer than one TPU lane row (tests/test_batch.py:319): a
    (192, 192) bucket."""
    rng = np.random.default_rng(17)
    pairs = [_rand_pair(rng, 130 + i, 131 - i) for i in range(2)]
    want = JB.score_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=64,
                          engine="xla")
    got = TB.score_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=64,
                         **CPU)
    assert (got == want).all()
    assert got.tolist() == [_pair_plain("affine", mu1, mu2, 1)
                            for mu1, mu2 in pairs]


@pytest.mark.parametrize("kind", ["affine", "nonaffine"])
@pytest.mark.parametrize("narrow", [True, False], ids=["int16", "int32"])
def test_wrappers_on_the_jax_stacks(kind, narrow):
    """The module that holds the kernels: what the JAX path ships to
    _affine_pallas_batched_dense / _nonaffine_pallas_batched_dense (the
    bucket's stacks, narrowed to int16 or not, batch axis padded to a
    multiple of PACK) goes through convert.stacks_from_jax into the port's
    wrappers."""
    affine = kind == "affine"
    params = AFFINE if affine else NONAFFINE
    pairs = _pairs(9, [(5, 7), (8, 8), (1, 1), (6, 6), (7, 7)])
    (key, b), = JB.make_buckets_dense(pairs, 8).items()
    N, M = key
    pad = -len(pairs) % pallas_dp.PACK
    mu1p = JB.stack_padded(b.mu1d, N, M, pad)
    mu2p = JB.stack_padded(b.mu2d, N, M, pad)
    if narrow:
        mu1p, mu2p = (pallas_dp._narrow_if_fits(a) for a in (mu1p, mu2p))
    assert mu1p.dtype == (np.int16 if narrow else np.int32)
    ns = np.asarray(b.n + [b.n[-1]] * pad, dtype=np.int32)
    ms = np.asarray(b.m + [b.m[-1]] * pad, dtype=np.int32)
    dense = (pallas_dp._affine_pallas_batched_dense if affine
             else pallas_dp._nonaffine_pallas_batched_dense)
    want = np.asarray(dense(*(jnp.asarray(a) for a in (mu1p, mu2p, ns, ms)),
                            N + M + 1, 1, params))
    stacks = stacks_from_jax(mu1p, mu2p, ns, ms, "cpu")
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in stacks)
    wrapper = (cuda_dp.affine_batch_scores if affine
               else cuda_dp.nonaffine_batch_scores)
    got = wrapper(*stacks, 1, *params).numpy()
    assert got.shape == want.shape == (8,) and (got == want).all()
    assert (got[:len(pairs)] == _oracle(pairs, 1, affine)).all()


def test_stacks_from_jax_rejects_other_inputs():
    mu = np.zeros((2, 9, 9), dtype=np.int32)
    n = np.zeros(2, dtype=np.int32)
    with pytest.raises(ValueError, match="int16 or int32"):
        stacks_from_jax(mu.astype(np.int64), mu, n, n, "cpu")
    with pytest.raises(ValueError, match="shapes differ"):
        stacks_from_jax(mu, mu, n, np.zeros(3, dtype=np.int32), "cpu")


def test_prepared_batch_matches_score_batch():
    """tests/test_batch.py:215-243 on the port: scored twice, accepted by
    score_batch, and its three refusals."""
    pairs = _pairs()
    want = JB.score_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=8,
                          engine="pallas")
    prep = TB.PreparedBatch(pairs, 1, AFFINE, affine=True, bucket_quantum=8,
                            **CPU)
    assert (prep.scores() == want).all()
    assert (prep.scores() == want).all()
    assert (TB.score_batch(prep, 1, AFFINE, affine=True, **CPU) == want).all()
    assert (TB.score_batch(prep, 1, AFFINE, affine=True, bucket_quantum=8,
                           **CPU) == want).all()
    with pytest.raises(ValueError, match="engine"):
        TB.score_batch(prep, 1, AFFINE, affine=True, device="cpu")
    with pytest.raises(ValueError, match="bucket_quantum"):
        TB.score_batch(prep, 1, AFFINE, affine=True, bucket_quantum=16, **CPU)
    with pytest.raises(ValueError, match="PreparedBatch"):
        TB.score_batch(prep, 2, AFFINE, affine=True, **CPU)
    with pytest.raises(ValueError, match="PreparedBatch"):
        TB.score_batch(prep, 1, (-200, -80, -200), affine=True, **CPU)


def test_dispatch_returns_pending_scores():
    pairs = _pairs()
    pending = TB.dispatch_score_batch(pairs, 2, NONAFFINE, affine=False,
                                      bucket_quantum=8, **CPU)
    assert pending.n_dispatches == 3          # buckets (8,8), (8,16), (16,8)
    assert (pending.get() == _oracle(pairs, 2, False)).all()


def test_buckets_carry_their_last_diagonal():
    """Each device bucket knows its largest n + m on the host, which bounds
    the kernels' launches; a wrapper on CPU tensors takes it and gives the
    twin's scores."""
    pairs = _pairs()
    buckets = TB._device_buckets(pairs, 8, torch.device("cpu"))
    assert len(buckets) == 3
    for indices, stacks, d_max in buckets:
        assert d_max == int((stacks[2] + stacks[3]).max())
        assert d_max == max(sum(pairs[i][0].shape) - 2 for i in indices)
        got = cuda_dp.affine_batch_scores(*stacks, 1, *AFFINE, d_max=d_max)
        assert (got == _twin("affine", stacks, 1)).all()


def test_int32_guard_raises_value_error():
    """tests/test_batch.py:301-316: unsafe magnitudes raise, not wrap."""
    mu = np.full((9, 9), 2_000_000, dtype=np.int32)
    big = (-20_000_000, -2_000_000, -2_000_000)
    with pytest.raises(ValueError, match="int32"):
        TB.score_batch([(mu, mu)], 1, big, affine=True, bucket_quantum=8,
                       **CPU)
    with pytest.raises(ValueError, match="int32"):
        TB.PreparedBatch([(mu, mu)], 1, big, affine=True, **CPU)


def test_empty_batch():
    got = TB.score_batch([], 1, AFFINE, affine=True, **CPU)
    assert got.dtype == np.int64 and got.shape == (0,)
    assert TB.PreparedBatch([], 1, AFFINE, affine=True, **CPU).scores().shape \
        == (0,)


def test_refusals():
    pairs = _pairs()[:2]
    with pytest.raises(NotImplementedError, match="P15"):
        TB.score_batch(pairs, 1, AFFINE, affine=True, mesh=object(), **CPU)
    with pytest.raises(NotImplementedError, match="P15"):
        TB.PreparedBatch(pairs, 1, AFFINE, affine=True, mesh=object(), **CPU)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.score_batch(pairs, 1, AFFINE, affine=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.PreparedBatch(pairs, 1, AFFINE, affine=True, engine="cuda",
                         device="cpu")
    with pytest.raises(ValueError, match="engine"):
        TB.score_batch(pairs, 1, AFFINE, affine=True, engine="auto",
                       device="cpu")


def test_defaults_are_the_cuda_engine_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.score_batch(_pairs()[:1], 1, AFFINE, affine=True)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.PreparedBatch(_pairs()[:1], 1, AFFINE, affine=True)


@pytest.mark.parametrize("N,S,affine,nbytes,route", [
    (64, 1, True, 5400 + 63180, "cta"),
    (64, 2, True, 5400 + 175500, "cta"),
    (64, 3, True, 5400 + 343980, "conveyor"),
    (127, 1, True, 5400 + 124416, "cta"),
    (127, 2, True, 5400 + 345600, "conveyor"),
    (512, 1, True, 5400 + 498636, "conveyor"),
    (512, 0, True, 84 + 18468, "cta"),          # K7: three live states
    (512, 2, False, 520 + 153900, "cta"),
    (1024, 2, False, 520 + 307500, "conveyor"),
])
def test_route_follows_shared_memory(N, S, affine, nbytes, route):
    """The route rule: the case table and three slabs of N+1 rows against
    the 227 KB of one CTA; beyond it the conveyor for two pairs or more,
    the per-diagonal kernel for one."""
    assert cuda_dp.cta_shared_bytes(N, S, affine) == nbytes
    assert cuda_dp.batch_route(N, S, affine, B=17) == route
    assert cuda_dp.batch_route(N, S, affine, B=2) == route
    assert cuda_dp.batch_route(N, S, affine, B=1) == \
        ("cta" if route == "cta" else "grid")
    for forced in ("grid", "conveyor"):
        assert cuda_dp.batch_route(N, S, affine, forced, B=1) == forced
    if route == "cta":
        assert cuda_dp.batch_route(N, S, affine, "cta", B=17) == "cta"
    else:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_dp.batch_route(N, S, affine, "cta", B=17)


@pytest.mark.parametrize("B,N,lanes", [(1, 512, 1), (28, 512, 28),
                                       (2048, 512, 422), (2048, 1024, 234),
                                       (5000, 192, 1056)])
def test_conveyor_lanes_fill_the_card_once(B, N, lanes):
    assert cuda_dp.conveyor_lanes(B, N) == lanes
    assert cuda_dp.conveyor_T0(N) == N + 3


def _conveyor_twin(kind, stacks, S, lanes, ring=None):
    if kind == "affine":
        return cuda_dp.affine_conveyor_scores_plain(*stacks, S, *AFFINE,
                                                    lanes=lanes, ring=ring)
    return cuda_dp.nonaffine_conveyor_scores_plain(*stacks, S, *NONAFFINE,
                                                   lanes=lanes, ring=ring)


@pytest.mark.parametrize("kind,S", [("affine", 0), ("affine", 1),
                                    ("affine", 2), ("nonaffine", 0),
                                    ("nonaffine", 1), ("nonaffine", 2)])
def test_conveyor_twin_on_garbage_rings_matches_per_pair_twin(kind, S):
    """The conveyor's geometry against each pair alone: one lane for all
    eight pairs, lanes with several pairs and an uneven last round, and a
    lane per pair; neither the pair ahead, the pair behind nor the rings'
    contents change a score."""
    pairs = _pairs(3 + S, MIXED)
    stacks = _stacks(pairs, 8, 8)
    want = [_pair_plain(kind, mu1, mu2, S) for mu1, mu2 in pairs]
    for lanes in (1, 3, 8):
        ring = _garbage(S + lanes, _ring_shape(kind, lanes, S, 9))
        assert _conveyor_twin(kind, stacks, S, lanes, ring).tolist() == want
    assert _conveyor_twin(kind, stacks, S, 2).tolist() == want
    assert _conveyor_twin(kind, stacks, S, None).tolist() == want


@pytest.mark.parametrize("kind,S,seed,count,hi", [
    ("affine", 0, 10, 5, 20), ("affine", 1, 11, 5, 20),
    ("affine", 2, 12, 5, 20), ("nonaffine", 1, 21, 4, 18),
    ("nonaffine", 2, 22, 4, 18)])
def test_conveyor_matches_pallas_conveyor_and_oracle(kind, S, seed, count, hi):
    """The ragged buckets of tests/test_conveyor.py:65-80 through the JAX
    conveyor (K8 in interpret mode), the oracle, the port's conveyor twin on
    one and on two lanes, and the wrapper with the route forced."""
    affine = kind == "affine"
    params = AFFINE if affine else NONAFFINE
    rng = np.random.default_rng(seed)
    pairs = [conveyor_pair(rng, rng.integers(6, hi), rng.integers(6, hi))
             for _ in range(count)]
    want = conveyor_oracle(pairs, S, params, affine)
    assert (jax_conveyor_scores(pairs, S, params, affine) == want).all()
    stacks = _stacks(pairs, 24, 24)
    for lanes in (1, 2):
        assert (_conveyor_twin(kind, stacks, S, lanes).numpy() == want).all()
    wrapper = (cuda_dp.affine_batch_scores if affine
               else cuda_dp.nonaffine_batch_scores)
    got = wrapper(*stacks, S, *params, route="conveyor", lanes=2,
                  ring=_garbage(seed, _ring_shape(kind, 2, S, 25)))
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    assert (got == _twin(kind, stacks, S)).all()


def test_conveyor_equal_rows_far_apart_columns():
    """The bucket of test_conveyor_capture_collision_regression: two pairs
    of equal n whose m differ by almost the bucket's M, one behind the other
    on one lane."""
    rng = np.random.default_rng(40)
    pairs = [conveyor_pair(rng, 150, 64), conveyor_pair(rng, 150, 3)]
    want = [_pair_plain("affine", mu1, mu2, 1) for mu1, mu2 in pairs]
    stacks = _stacks(pairs, 152, 64)
    assert _conveyor_twin("affine", stacks, 1, 1).tolist() == want


def test_wrapper_takes_the_conveyor_beyond_shared_memory():
    """A (64, 8) bucket at max_shift 3 does not fit one CTA: with no route
    forced the wrapper takes the conveyor for its three pairs and the
    per-diagonal form for one pair."""
    pairs = _pairs(5, [(64, 3), (9, 8), (40, 5)])
    stacks = _stacks(pairs, 64, 8)
    want = [_pair_plain("affine", mu1, mu2, 3) for mu1, mu2 in pairs]
    assert cuda_dp.batch_route(64, 3, True, B=3) == "conveyor"
    ring = _garbage(8, _ring_shape("affine", 3, 3, 65))
    assert cuda_dp.affine_batch_scores(*stacks, 3, *AFFINE,
                                       ring=ring).tolist() == want
    with pytest.raises(ValueError, match="ring"):        # a ring per lane
        cuda_dp.affine_batch_scores(*stacks, 3, *AFFINE, lanes=2, ring=ring)
    one = tuple(t[:1].contiguous() for t in stacks)
    assert cuda_dp.affine_batch_scores(*one, 3, *AFFINE).tolist() == want[:1]


def test_conveyor_lanes_are_checked():
    stacks = _stacks(_pairs(1, [(3, 4), (5, 5)]), 8, 8)
    for lanes in (0, 3):
        with pytest.raises(ValueError, match="lanes"):
            cuda_dp.affine_batch_scores(*stacks, 1, *AFFINE, route="conveyor",
                                        lanes=lanes)
    with pytest.raises(ValueError, match="lanes"):
        cuda_dp.nonaffine_batch_scores(*stacks, 1, *NONAFFINE, route="grid",
                                       lanes=1)


def test_forced_cta_beyond_shared_memory_raises():
    """A forced "cta" that does not fit raises in the wrapper, before any
    twin or kernel runs; an unknown route too."""
    stacks = _stacks(_pairs(1, [(3, 4)]), 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_dp.affine_batch_scores(*stacks, 3, *AFFINE, route="cta")
    with pytest.raises(ValueError, match="route"):
        cuda_dp.nonaffine_batch_scores(*stacks, 1, *NONAFFINE, route="packed")


def test_wrappers_check_their_arguments():
    mu1p, mu2p, ns, ms = _stacks(_pairs(1, [(3, 4), (5, 5)]), 8, 8)
    with pytest.raises(ValueError, match="int32"):
        cuda_dp.affine_batch_scores(mu1p.long(), mu2p, ns, ms, 1, *AFFINE)
    with pytest.raises(ValueError, match="shapes differ"):
        cuda_dp.affine_batch_scores(mu1p, mu2p, ns[:1], ms, 1, *AFFINE)
    with pytest.raises(ValueError, match="outside the bucket"):
        cuda_dp.nonaffine_batch_scores(mu1p, mu2p, ns + 8, ms, 1, *NONAFFINE)
    with pytest.raises(ValueError, match="ring"):
        cuda_dp.affine_batch_scores(mu1p, mu2p, ns, ms, 1, *AFFINE,
                                    ring=torch.zeros(3, dtype=torch.int32))
