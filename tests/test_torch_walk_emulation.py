"""The traceback walks' CUDA source, built for the host and run on the CPU.

``bialign_tpu_torch/csrc/walk.cu`` holds the six walk kernels: the affine
and non-affine walk of one pair's band, of every pair of a chunk band, and
of one block of a checkpointed band.  They run only on the card, where
``chip_smoke.py`` holds them to the host walks.  Here the same source is
built with the host's C++20 compiler against ``tests/cuda_host/``, whose
warp functions take the 32-thread CTA as the warp and fail a launch in which
the lanes do not all make the same call, with two mechanical rewrites: each
walk body's ``extern __shared__`` buffer and each ``<<<...>>>`` launch.
Every entry point must then equal its plain twin (the host walk of
``bialign_tpu_torch/ops/traceback.py``): steps, done flag, score, codes,
and the state a block walk leaves.  The bands and windows hold garbage off
the pair's live cells; the tables are random or tie-heavy (values in
{0, +-100} and costs of the same grain, so that many cases of a step are
co-optimal and the first-minimum rule decides); the walks include the
max_shift 3 goldens, stuck and capped walks and batch pairs outside the
chunk band.  This checks the kernels' indexing, selection and convergence
on the CPU; it says nothing of their speed, and it does not replace the
card's check.
"""

import ctypes

import numpy as np
import pytest
import torch
from cuda_host import emulation as emu

import golden as G
from test_torch_align import (OFFSET5, OFFSET5_MS3_OUT, OFFSET5_SCORES,
                              TOY_MS3, TOY_MS3_OUT, TOY_MS3_SCORE)

from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.convert import tables_to_torch
from bialign_tpu_torch.ops import checkpoint_dp as ckp
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb
from bialign_tpu_torch.ops.band import DeviceBand, DeviceBatchBand

# the tile emulation's shapes: tile edges at max_shift 1 and 3, max_shift
# 0, 2 and 4, and empty sequences
SHAPES = [(0, 4, 1), (7, 10, 1), (8, 11, 1), (16, 19, 1), (5, 7, 0),
          (8, 8, 2), (2, 5, 3), (4, 7, 3), (5, 6, 4), (6, 0, 2)]
# costs of the random tables, and of the tie-heavy ones
PARAMS = {("random", True): (-150, -50, -150),
          ("random", False): (-200, -250),
          ("ties", True): (-200, -100, -100),
          ("ties", False): (-100, -100)}
TABLES = ("random", "ties")
# block sizes of the blockwise walks: every diagonal a block, a small odd
# one, one block for the whole band
BLOCKS = (1, 3, None)
HEADER = 3
CPU = dict(engine="torch", device="cpu")


@pytest.fixture(scope="module")
def cxx():
    return emu.compiler()


@pytest.fixture(scope="module")
def lib(cxx, tmp_path_factory):
    work = tmp_path_factory.mktemp("walk_host")
    csrc = emu.copy_csrc(work / "csrc", {"walk.cu": (2, 6)})
    return emu.build(cxx, [csrc / "walk.cu"], work / "libwalk.so")


def _tables(rng, n, m, kind):
    """Random tables, or tie-heavy ones with values in {0, +-100}."""
    lo, hi = (-4, 9) if kind == "random" else (-1, 2)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros((n + 1, m + 1), np.int32)
    mu1[1:, 1:] = rng.integers(lo, hi, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(lo, hi, size=(n, m)) * 100
    return tables_to_torch(mu1, mu2, "cpu")


def _cases(affine, params):
    table = (cuda_dp.affine_case_table if affine
             else cuda_dp.nonaffine_case_table)(*params)
    return torch.from_numpy(table)


def _fill(affine, t1, t2, S, params):
    return (cuda_dp.fill_affine_plain if affine
            else cuda_dp.fill_nonaffine_plain)(t1, t2, S, *params)


def _on_garbage(band: DeviceBand, rng) -> DeviceBand:
    """The band with garbage in every cell off its live rows."""
    n, m, ys = band.n, band.m, band.ys
    d = torch.arange(n + m + 1)[:, None]
    i = torch.arange(n + 1)[None, :]
    live = ((i <= d) & (d - i <= m)).reshape(n + m + 1, *[1] * (ys.dim() - 2),
                                             n + 1)
    return DeviceBand(ys=torch.where(live, ys, emu.garbage(rng, ys.shape)), n=n,
                      m=m, max_shift=band.max_shift, affine=band.affine)


def _twin_out(band: DeviceBand, affine, params, t1, t2):
    """[steps, done, score, codes...] of the host walk over ``band``."""
    if affine:
        trace, complete = dtb.affine_traceback_plain(band, *params, t1, t2)
        done = 1 if complete else 2
    else:
        trace = dtb.nonaffine_traceback_plain(band, *params, t1, t2)
        done = 1
    codes = [8 * c[0] + 4 * c[1] + 2 * c[2] + c[3] for c in reversed(trace)]
    return [len(codes), done, band.final_score(), *codes]


def _walk(lib, band: DeviceBand, params, t1, t2, lmax=None):
    """The single-pair kernel over ``band``: its written output as a list."""
    n, m, S = band.n, band.m, band.max_shift
    lmax = dtb.walk_capacity(n, m) if lmax is None else lmax
    out = torch.full((HEADER + lmax,), -7, dtype=torch.int32)
    kind = "affine" if band.affine else "nonaffine"
    emu.call(lib, f"bialign_walk_{kind}", band.ys, t1, t2,
          _cases(band.affine, params), n, m, S, out, lmax)
    return out[:HEADER + int(out[0])].tolist()


def _block_walks(lib, affine, t1, t2, S, params, C, rng, *, noise_below=-1,
                 lmax=None):
    """Every block of a checkpointed band at block size C, last first, into
    a window of garbage (noise added to the slabs of the diagonals below
    ``noise_below``), walked by the kernel and by the twin, each on a walk
    tensor of its own; after each block both tensors must be equal (the
    state, steps, done, score and codes).  Returns the twin's tensor."""
    fill, block_plain, walk_plain = (
        (ckp.fill_affine_checkpoint_plain, ckp.affine_block_plain,
         ckp.affine_block_walk_plain) if affine else
        (ckp.fill_nonaffine_checkpoint_plain, ckp.nonaffine_block_plain,
         ckp.nonaffine_block_walk_plain))
    n, m = t1.shape[0] - 1, t1.shape[1] - 1
    cb = fill(t1, t2, S, *params, block=C or n + m + 4)
    lmax = dtb.walk_capacity(n, m) if lmax is None else lmax
    walk_k = torch.zeros(ckp.STATE + HEADER + lmax, dtype=torch.int32)
    walk_p = walk_k.clone()
    kind = "affine" if affine else "nonaffine"
    for b in range(cb.n_blocks - 1, -1, -1):
        d0 = b * cb.block
        window = block_plain(cb, b, window=emu.garbage(rng, cb.window_shape))
        for x in range(window.shape[0]):
            if d0 - 2 + x < noise_below:
                window[x] += torch.from_numpy(rng.integers(
                    1, 1000, window[x].shape).astype(np.int32))
        emu.call(lib, f"bialign_walk_{kind}_block", window, cb.mu1, cb.mu2,
              _cases(affine, params), n, m, S, d0, int(b == cb.n_blocks - 1),
              walk_k[:ckp.STATE], walk_k[ckp.STATE:], lmax)
        walk_plain(cb, b, window, walk_p)
        steps = int(walk_p[ckp.STATE])
        written = ckp.STATE + HEADER + steps
        assert torch.equal(walk_k[:written], walk_p[:written]), (C, b)
    return walk_p


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
@pytest.mark.parametrize("n,m,S", SHAPES)
def test_walks_equal_the_twins(lib, n, m, S, affine, tables):
    """The single-pair walk over a band of garbage off its live rows, and
    the blockwise walk block by block over windows of garbage at three
    block sizes: equal to the host walk in every written value."""
    rng = np.random.default_rng(100 * n + 10 * m + S + (tables == "ties"))
    t1, t2 = _tables(rng, n, m, tables)
    params = PARAMS[tables, affine]
    band = _on_garbage(_fill(affine, t1, t2, S, params), rng)
    want = _twin_out(band, affine, params, t1, t2)
    assert _walk(lib, band, params, t1, t2) == want
    for C in BLOCKS:
        walk = _block_walks(lib, affine, t1, t2, S, params, C, rng)
        steps = int(walk[ckp.STATE])
        assert walk[ckp.STATE:ckp.STATE + HEADER + steps].tolist() == want


def _chunk(rng, affine, S, tables):
    """A chunk band of a (7, 8) bucket filled to the valid pairs' last
    diagonal on garbage, with two pairs the walk must not walk inserted:
    one longer than the bucket, one whose last diagonal lies beyond the
    chunk band.  Returns (band, mu1p, mu2p, params)."""
    N, M = 7, 8
    lengths = [(0, 5), (6, 0), (5, 7), (7, 6), (3, 3), (1, 1)]
    params = PARAMS[tables, affine]
    mu1 = np.zeros((len(lengths), N + 1, M + 1), np.int32)
    mu2 = np.zeros_like(mu1)
    lo, hi = (-4, 9) if tables == "random" else (-1, 2)
    for b, (n, m) in enumerate(lengths):
        mu1[b, 1:n + 1, 1:m + 1] = rng.integers(lo, hi, size=(n, m)) * 100
        mu2[b, 1:n + 1, 1:m + 1] = rng.integers(lo, hi, size=(n, m)) * 100
    ns = np.array([n for n, _m in lengths], np.int32)
    ms = np.array([m for _n, m in lengths], np.int32)
    d_max = int((ns + ms).max())
    W = 2 * S + 1
    cells = ((9,) if affine else ()) + (W, W)
    junk = emu.garbage(rng, (len(lengths), d_max + 1, *cells, N + 1))
    fill = (cuda_dp.affine_batch_bands_plain if affine
            else cuda_dp.nonaffine_batch_bands_plain)
    valid = [torch.from_numpy(a) for a in (mu1, mu2, ns, ms)]
    band, _scores = fill(*valid, S, *params, d_max=d_max, band=junk)
    outside = {2: (N + 3, 1), 5: (N, M)}       # n > N; n + m > d_max
    ys, mu1p, mu2p = band.ys, valid[0], valid[1]
    for b, (n, m) in outside.items():
        ys = torch.cat([ys[:b], emu.garbage(rng, (1, *ys.shape[1:])), ys[b:]])
        mu1p = torch.cat([mu1p[:b], torch.full((1, N + 1, M + 1), 7,
                                               dtype=torch.int32), mu1p[b:]])
        mu2p = torch.cat([mu2p[:b], torch.full((1, N + 1, M + 1), 7,
                                               dtype=torch.int32), mu2p[b:]])
        ns = np.insert(ns, b, n)
        ms = np.insert(ms, b, m)
    bband = DeviceBatchBand(ys=ys.contiguous(), ns=torch.from_numpy(ns),
                            ms=torch.from_numpy(ms), max_shift=S,
                            affine=affine)
    return bband, mu1p.contiguous(), mu2p.contiguous(), params


def _batch_walk(lib, bband: DeviceBatchBand, params, mu1p, mu2p):
    B, N, M = bband.ys.shape[0], bband.N, mu1p.shape[2] - 1
    lmax = dtb.walk_capacity(N, M)
    out = torch.full((B, HEADER + lmax), -7, dtype=torch.int32)
    kind = "affine" if bband.affine else "nonaffine"
    emu.call(lib, f"bialign_walk_{kind}_batch", bband.ys, mu1p, mu2p,
          _cases(bband.affine, params), bband.ns, bband.ms, B, N, M, bband.D,
          bband.max_shift, out, lmax)
    return out


def _unpacked(out):
    return [(codes.tolist(), done, score)
            for codes, done, score in dtb.unpack_walks(out.numpy())]


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
@pytest.mark.parametrize("S", [0, 1, 2, 3, 4])
def test_batch_walks_equal_the_twins(lib, S, affine, tables):
    """The batch walk over a chunk band of garbage off the pairs' genuine
    cells: every pair's steps, done flag, score and codes equal to the host
    walk over its own band; the pairs outside the bucket or the chunk band
    are not walked (0 steps, done 2, score INVALID)."""
    rng = np.random.default_rng(20 * S + affine + 2 * (tables == "ties"))
    bband, mu1p, mu2p, params = _chunk(rng, affine, S, tables)
    twin = (dtb.affine_walk_batch_plain if affine
            else dtb.nonaffine_walk_batch_plain)
    want = _unpacked(twin(bband, *params, mu1p, mu2p))
    assert _unpacked(_batch_walk(lib, bband, params, mu1p, mu2p)) == want
    for b in (2, 5):
        assert want[b] == ([], 2, cuda_dp.INVALID)


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
def test_walks_that_stop_early_equal_the_twins(lib, affine):
    """Noise on the diagonals below the middle: the walk goes down to them
    and stops there (affine: stuck, done 2; non-affine: no case matches,
    done 1), single-pair and block by block, as the host walk does."""
    n, m, S = 9, 11, 1
    rng = np.random.default_rng(5 + affine)
    t1, t2 = _tables(rng, n, m, "random")
    params = PARAMS["random", affine]
    band = _fill(affine, t1, t2, S, params)
    full = len(_twin_out(band, affine, params, t1, t2)) - HEADER
    below = (n + m) // 2
    ys = band.ys.clone()
    ys[:below] += torch.from_numpy(
        rng.integers(1, 1000, ys[:below].shape).astype(np.int32))
    noisy = DeviceBand(ys=ys, n=n, m=m, max_shift=S, affine=affine)
    want = _twin_out(noisy, affine, params, t1, t2)
    assert want[1] == (2 if affine else 1) and 0 < want[0] < full
    assert _walk(lib, noisy, params, t1, t2) == want
    for C in (1, 4):
        walk = _block_walks(lib, affine, t1, t2, S, params, C, rng,
                            noise_below=below)
        assert walk[ckp.STATE:ckp.STATE + 2].tolist() == want[:2]


@pytest.mark.parametrize("affine", [True, False],
                         ids=["affine", "nonaffine"])
def test_capped_walks_stop_at_lmax(lib, affine, monkeypatch):
    """A walk with room for 5 codes stops after 5 steps with done 0: the
    single-pair kernel writes the twin's first 5 codes; block by block
    (capacity 5 for the twin too) the kernel's tensor equals the twin's."""
    n, m, S = 9, 11, 1
    rng = np.random.default_rng(9 + affine)
    t1, t2 = _tables(rng, n, m, "random")
    params = PARAMS["random", affine]
    band = _on_garbage(_fill(affine, t1, t2, S, params), rng)
    want = _twin_out(band, affine, params, t1, t2)
    assert _walk(lib, band, params, t1, t2, lmax=5) == [5, 0, want[2],
                                                        *want[3:8]]
    monkeypatch.setattr(ckp, "walk_capacity", lambda n, m: 5)
    for C in (2, 7):
        walk = _block_walks(lib, affine, t1, t2, S, params, C, rng, lmax=5)
        assert walk[ckp.STATE:].tolist() == [5, 0, want[2], *want[3:8]]


@pytest.mark.parametrize("mol,score,lines", [
    (G.TOY_PROTEIN, TOY_MS3_SCORE, TOY_MS3_OUT),
    (OFFSET5, OFFSET5_SCORES[3], OFFSET5_MS3_OUT),
], ids=["toy_protein", "structure_offset_5"])
def test_max_shift_3_goldens(lib, mol, score, lines):
    """The max_shift 3 goldens, whose walks cross many co-optimal steps:
    the single-pair, blockwise and batch (a batch of one) walks give the
    golden trace."""
    ba = BiAligner(**mol, **TOY_MS3, **CPU)
    assert ba.optimize() == score
    t1, t2 = tables_to_torch(ba.mu1, ba.mu2, "cpu")
    params, S = (ba.beta, ba.gamma, ba.delta), ba.max_shift
    rng = np.random.default_rng(3)
    band = _on_garbage(_fill(True, t1, t2, S, params), rng)
    want = _twin_out(band, True, params, t1, t2)
    got = _walk(lib, band, params, t1, t2)
    assert got == want and got[:3] == [got[0], 1, score]
    trace = dtb.decode_codes(got[HEADER:])
    assert trace == ba.traceback()
    assert list(ba.decode_trace(trace)) == lines
    for C in (2, 7):
        _block_walks(lib, True, t1, t2, S, params, C, rng)

    n, m = band.n, band.m
    bband = DeviceBatchBand(ys=band.ys[None].contiguous(),
                            ns=torch.tensor([n], dtype=torch.int32),
                            ms=torch.tensor([m], dtype=torch.int32),
                            max_shift=S, affine=True)
    out = _batch_walk(lib, bband, params, t1[None].contiguous(),
                      t2[None].contiguous())
    assert _unpacked(out) == [(got[HEADER:], 1, score)]


# A kernel whose lanes leave the warp's step: lane 5 skips the exchange
# (the others wait for it), or calls another warp function than the rest.
DIVERGENT = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void skips(int32_t* out) {
  const int lane = threadIdx.x & 31;
  int v = lane;
  if (lane != 5) v = __shfl_sync(0xffffffffu, v, 0);
  out[lane] = v;
}
__global__ void mixes(int32_t* out) {
  const int lane = threadIdx.x & 31;
  out[lane] = lane == 5 ? int(__ballot_sync(0xffffffffu, 1))
                        : __reduce_min_sync(0xffffffffu, lane);
}
__global__ void converges(int32_t* out) {
  const int lane = threadIdx.x & 31;
  const unsigned hit = __ballot_sync(0xffffffffu, lane % 7 == 3);
  const int least = __reduce_min_sync(0xffffffffu, 40 - lane);
  out[lane] = __shfl_sync(0xffffffffu, lane * 10, __ffs(hit) - 1) + least;
}
extern "C" int run(int which, int32_t* out) {
  if (which == 0) skips<<<2, 32, 0, nullptr>>>(out);
  if (which == 1) mixes<<<1, 32, 0, nullptr>>>(out);
  if (which == 2) converges<<<1, 32, 0, nullptr>>>(out);
  return cudaGetLastError();
}
"""


def test_the_host_warp_fails_a_divergent_call(cxx, tmp_path):
    """The emulated warp functions: a lane that skips an exchange fails the
    launch (after the timeout, shortened here) rather than hanging it, as
    do lanes in different warp functions; a convergent warp gets the
    values a warp would."""
    src = tmp_path / "divergent.cu"
    src.write_text(emu.for_host(DIVERGENT, 0, 3, "the divergent kernels"))
    lib = emu.build(cxx, [src], tmp_path / "libdivergent.so",
                    "-DHOST_WARP_TIMEOUT_S=1")
    out = torch.zeros(32, dtype=torch.int32)
    assert lib.run(0, ctypes.c_void_p(out.data_ptr())) != 0
    assert lib.run(1, ctypes.c_void_p(out.data_ptr())) != 0
    assert lib.run(2, ctypes.c_void_p(out.data_ptr())) == 0
    assert out.tolist() == [30 + 9] * 32
