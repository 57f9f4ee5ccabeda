"""The port's triplet aligner against the JAX package's, on the CPU: the
plain PyTorch wavefront ``fill_torch`` equal to the JAX ``fill_xla`` and to
the numpy oracle in every banded cell, and ``BiAlignerTriplet`` equal to the
JAX class end to end (tolerance 0: ints and strings).  Its default engine,
the CUDA kernel, is refused here; tests/test_torch_triplet_emulation.py
holds the kernel's source to the twin on the CPU."""

import numpy as np
import pytest
import torch

import bialign_tpu.models.triplet as J
import bialign_tpu_torch.models.triplet as T

SHAPES = [(5, 7, 1), (8, 8, 2), (3, 9, 1), (9, 3, 2), (1, 1, 1), (6, 6, 0),
          (7, 5, 3), (0, 4, 1), (4, 0, 2), (12, 10, 4)]


def _rand_tables(rng, n, m):
    """tests/test_triplet.py's tables."""
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(-400, 900, size=(n, m))
    mu2[1:, 1:] = rng.integers(-400, 900, size=(n, m))
    return mu1, mu2


def _band(n, m, S):
    """The cells (i, j, k) with |k - j| <= S, as a mask of the oracle's
    layout."""
    j = np.arange(m + 1)[:, None]
    k = np.arange(m + 1)[None, :]
    return np.broadcast_to(np.abs(k - j) <= S, (n + 1, m + 1, m + 1))


@pytest.mark.parametrize("n,m,S", SHAPES)
def test_fill_torch_equals_fill_xla_and_the_oracle(n, m, S):
    rng = np.random.default_rng(n * 31 + m * 7 + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    got = T.fill_torch(mu1, mu2, S, -200, -250, device="cpu")
    want = J.fill_oracle(mu1, mu2, S, -200, -250)
    band = _band(n, m, S)
    assert np.array_equal(got[band], want[band])
    assert np.array_equal(got, J.fill_xla(mu1, mu2, S, -200, -250))
    assert np.array_equal(T.fill_oracle(mu1, mu2, S, -200, -250), want)


RNA = ("GCGGGGGAUAUCCCCAUCG", "GGGGAUAUCCCCAUCG",
       "...(((.....))).....", ".(((.....)))....")
SMALL = ("ACGGCU", "ACGCU", "((..))", "((.))")
RNA_PARAMS = dict(type="RNA", structure_weight=400, gap_cost=-200,
                  shift_cost=-250)


def _outputs(ba):
    score = ba.optimize()
    trace = ba.traceback()
    return (score, trace, ba.decode_trace(trace),
            ba.decode_trace(trace, show_structures=True),
            list(ba.eval_trace(trace)))


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_triplet_end_to_end_as_jax(engine):
    """tests/test_triplet.py::test_triplet_end_to_end, through both engines
    of the port, against the JAX class."""
    kw = dict(RNA_PARAMS, max_shift=2)
    dev = {} if engine == "numpy" else dict(device="cpu")
    got = _outputs(T.BiAlignerTriplet(*RNA, engine=engine, **dev, **kw))
    assert got == _outputs(J.BiAlignerTriplet(*RNA, **kw))
    score, trace, rows, rows6, lines = got
    assert [sum(t[s] for t in trace) for s in range(3)] == [19, 16, 16]
    assert len(rows) == 3 and len({len(r) for r in rows}) == 1
    assert rows[0].replace("-", "") == RNA[0]
    assert rows[1].replace("-", "") == RNA[1]
    assert len(rows6) == 6
    assert len(lines) == len(trace) and lines[-1].endswith(str(score))


def test_triplet_torch_engine_as_the_xla_engine():
    """tests/test_triplet.py::test_triplet_xla_engine_end_to_end: the
    port's torch engine against the JAX xla and numpy engines."""
    kw = dict(RNA_PARAMS, max_shift=1)
    got = _outputs(T.BiAlignerTriplet(*SMALL, engine="torch", device="cpu",
                                      **kw))
    assert got == _outputs(J.BiAlignerTriplet(*SMALL, engine="xla", **kw))
    assert got == _outputs(J.BiAlignerTriplet(*SMALL, engine="numpy", **kw))


def test_triplet_unknown_engine_is_refused():
    with pytest.raises(ValueError, match="engine"):
        T.BiAlignerTriplet(*SMALL, engine="xla", **RNA_PARAMS)


def test_triplet_cuda_engine_is_the_default_and_refused_here():
    """With no engine= the aligner takes the CUDA kernel on "cuda": on a
    host without a card that raises, as does the kernel on a CPU device,
    rather than giving way to the plain twin."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs the kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.BiAlignerTriplet(*SMALL, **RNA_PARAMS)
    with pytest.raises(RuntimeError, match="engine='cuda'"):
        T.BiAlignerTriplet(*SMALL, engine="cuda", device="cpu", **RNA_PARAMS)


@pytest.mark.parametrize("n,m,S", SHAPES[:4])
def test_fill_slabs_cuda_on_the_cpu_is_the_twin(n, m, S):
    """The kernel's wrapper given a CPU device runs the twin; the domain
    holds exactly the banded cells of the oracle's layout."""
    rng = np.random.default_rng(n + m + S)
    mu1, mu2 = _rand_tables(rng, n, m)
    got = T.fill_slabs_cuda(mu1, mu2, S, -200, -250, device="cpu")
    assert torch.equal(got, T.fill_slabs(mu1, mu2, S, -200, -250,
                                         device="cpu"))
    assert int(T.domain(n, m, S).sum()) == int(_band(n, m, S)[0].sum()) * (
        n + 1)
    with pytest.raises(ValueError, match="one 2-D shape"):
        T.fill_slabs_cuda(mu1, mu2[:, :-1], S, -200, -250, device="cpu")


@pytest.mark.parametrize("S,last_shared,threads", [
    (1, 3873, None),       # default threads: one row a thread up to 1023,
    (0, 8300, None),       # then staged tables
    (8, 1023, None),       # one row a thread; staged would need 291,100 B
    (9, 734, None),        # run-time widths: always staged
    (8, 817, 512),         # several rows a thread: staged
])
def test_triplet_route_at_its_boundary(S, last_shared, threads):
    """``triplet_route`` is "shared" while ring (and staged tables) fit one
    CTA's 232,448 bytes, and "global" one row beyond."""
    W = 2 * S + 1

    def staged(n):
        t = T.default_threads(n) if threads is None else threads
        return S > T.STATIC_SHIFTS or n + 1 > t

    for n in (last_shared, last_shared + 1):
        want = 4 * (n + 1) * (3 * W + (W + 3 if staged(n) else 0))
        assert T.shared_bytes(n, S, threads) == want
    assert T.shared_bytes(last_shared, S, threads) <= T.CTA_SHARED_LIMIT
    assert T.shared_bytes(last_shared + 1, S, threads) > T.CTA_SHARED_LIMIT
    assert T.triplet_route(last_shared, S, threads) == "shared"
    assert T.triplet_route(last_shared + 1, S, threads) == "global"
    assert T.triplet_route(928, 1) == "shared"         # DNA-Pol-1
    assert T.triplet_route(1500, 8) == "global"        # its ring: 306 KB


def test_forced_shared_route_beyond_one_cta_raises():
    """A forced "shared" that does not fit raises and names the bytes, on
    any device (the arguments are checked before the CPU's twin runs); a
    forced "global", or the default route, runs there."""
    mu = np.zeros((3875, 2), dtype=np.int32)            # n = 3874, m = 1
    with pytest.raises(ValueError, match="232500 bytes"):
        T.fill_slabs_cuda(mu, mu, 1, -200, -250, device="cpu",
                          route="shared")
    with pytest.raises(ValueError, match="291100 bytes"):
        T.fill_slabs_cuda(mu[:1025], mu[:1025], 8, -200, -250,
                          device="cpu", route="shared")
    with pytest.raises(ValueError, match="route must be"):
        T.fill_slabs_cuda(mu[:3], mu[:3], 1, -200, -250, device="cpu",
                          route="cta")
    rng = np.random.default_rng(4)
    mu1, mu2 = _rand_tables(rng, 6, 5)
    want = T.fill_slabs(mu1, mu2, 1, -200, -250, device="cpu")
    for route in (None, "shared", "global"):
        assert torch.equal(T.fill_slabs_cuda(mu1, mu2, 1, -200, -250,
                                             device="cpu", route=route), want)
