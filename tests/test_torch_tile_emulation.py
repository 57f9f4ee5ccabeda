"""The tile kernels' CUDA source, built for the host and run on the CPU.

The kernels of K1, K2 and K9-K12 (``bialign_tpu_torch/csrc/tile_diag.cuh``
and the entry points that launch it) run only on the card, where
``chip_smoke.py`` holds them to their plain twins.  Here the same source is
built with the host's C++20 compiler against ``tests/cuda_host/``, a
stand-in for the few runtime pieces it uses (a CTA as std::threads meeting
at a std::barrier for each ``__syncthreads()``), with two mechanical
rewrites: the ``extern __shared__`` buffer and the ``<<<...>>>`` launch.  It
then has to equal the twins in every cell: bands and windows of garbage
keep their garbage off the live rows, rings of garbage give the twins' last
slab, checkpoints the twins' slabs.  This checks the kernels' indexing,
staging and phases on the CPU; it says nothing of their speed, and it does
not replace the card's check.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from bialign_tpu_torch.convert import tables_to_torch
from bialign_tpu_torch.ops import checkpoint_dp as ckp
from bialign_tpu_torch.ops import cuda_dp

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "bialign_tpu_torch" / "csrc"
HOST = Path(__file__).resolve().parent / "cuda_host"

AFFINE_PARAMS, NONAFFINE_PARAMS = (-150, -50, -150), (-200, -250)
# tile edges (the live rows of a middle diagonal around R = 8 at affine
# max_shift 1, 16 non-affine; R = 2 and 4 at max_shift 3), max_shift 0, 2,
# the run-time form at 4, and empty sequences
SHAPES = [(0, 4, 1), (7, 10, 1), (8, 11, 1), (16, 19, 1), (5, 7, 0),
          (8, 8, 2), (2, 5, 3), (4, 7, 3), (5, 6, 4), (6, 0, 2)]
BLOCK = 3


def _host_source(dst: Path) -> list:
    """csrc copied to ``dst`` with the two rewrites; the sources that launch
    the tile kernel."""
    shutil.copytree(CSRC, dst)
    tile = dst / "tile_diag.cuh"
    text = tile.read_text()
    text, k = re.subn(r"extern __shared__ int32_t smem\[\];",
                      "int32_t* smem = host_cta_shared;", text)
    assert k == 1, "the tile kernel's shared buffer moved"
    text, k = re.subn(r"(\w+)<<<(.*?)>>>\(",
                      lambda mt: f"host_launch({mt[1]}, {mt[2]}, ", text,
                      flags=re.S)
    assert k == 1, "the tile kernel's launch moved"
    tile.write_text(text)
    return sorted(p for p in dst.glob("*.cu")
                  if re.search(r'#include "(tile|ckpt)_diag.cuh"',
                               p.read_text()))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    work = tmp_path_factory.mktemp("tile_host")
    sources = _host_source(work / "csrc")
    assert len(sources) == 8, [p.name for p in sources]
    jobs = [subprocess.Popen(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-w", "-I", str(HOST), "-I",
         str(work / "csrc"), "-x", "c++", "-c", str(src), "-o",
         str(work / (src.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sources]
    for job in jobs:
        out = job.communicate()[0]
        assert job.returncode == 0, out
    so = work / "libtile_host.so"
    subprocess.run([cxx, "-shared", "-o", str(so),
                    *[str(work / (s.stem + ".o")) for s in sources],
                    "-lpthread"], check=True)
    return ctypes.CDLL(str(so))


def _call(lib, name, *args):
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else ctypes.c_int(a) for a in args]
    assert getattr(lib, name)(*cargs, ctypes.c_int(0),
                              ctypes.c_void_p(None)) == 0, name


def _garbage(rng, shape):
    return torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32))


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
    junk = _garbage(rng, (n + m + 1, *slab))
    band = junk.clone()
    _call(lib, f"bialign_fill_{kind}", band, t1, t2, consts, n, m, S)
    d = torch.arange(n + m + 1)[:, None]
    i = torch.arange(n + 1)[None, :]
    live = ((i <= d) & (d - i <= m)).reshape(n + m + 1, *[1] * (len(slab) - 1),
                                             n + 1)
    assert torch.equal(band, torch.where(live, plain.ys, junk))

    # score-only on a ring of garbage: the last slab's live row
    ring = _garbage(rng, (3, *slab))
    _call(lib, f"bialign_score_{kind}", ring, t1, t2, consts, n, m, S)
    assert torch.equal(ring[(n + m) % 3][..., n], plain.ys[n + m][..., n])

    # K9 / K11 on a ring and checkpoints of garbage, against the twin on
    # the same garbage; K10 / K12 every block into a window of garbage
    fill_plain, block_plain = (
        (ckp.fill_affine_checkpoint_plain, ckp.affine_block_plain) if affine
        else (ckp.fill_nonaffine_checkpoint_plain, ckp.nonaffine_block_plain))
    blocks = (n + m) // BLOCK + 1
    ring, ckpts = _garbage(rng, (3, *slab)), _garbage(rng, (blocks, 2, *slab))
    twin = fill_plain(t1, t2, S, *params, block=BLOCK, ring=ring.clone(),
                      ckpts=ckpts.clone())
    _call(lib, f"bialign_ckpt_{kind}", ring, ckpts, t1, t2, consts, n, m, S,
          BLOCK)
    assert torch.equal(ckpts, twin.ckpts)
    assert torch.equal(ring[(n + m) % 3], twin.final)
    for b in range(blocks):
        junk = _garbage(rng, twin.window_shape)
        window = junk.clone()
        _call(lib, f"bialign_block_{kind}", window, twin.ckpts[b].contiguous(),
              t1, t2, consts, n, m, S, b * BLOCK, BLOCK)
        assert torch.equal(window, block_plain(twin, b, window=junk)), b
