"""The sequence split in the port (``parallel/seqsplit.py``) through the
plain twins on CPU shards (``engine="torch"``, ``Mesh(["cpu"] * k,
("sp",))``), against the JAX package's split on its 8-device CPU mesh
(tests/conftest.py), the port's single-device paths and the numpy oracle:
the cases of tests/test_seqsplit.py, the split checkpoints held to the JAX
package's row by row, and the twins' own edges (a shard of one row, more
devices than rows).  Scores, checkpoints, traces and lines are ints and
strings, compared for equality."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import golden as G
from bialign_tpu.aligner import BiAligner as JaxBiAligner
from bialign_tpu.ops import reference_dp
from bialign_tpu.parallel import seqsplit as JS

from bialign_tpu_torch import BiAligner
from bialign_tpu_torch.convert import checkpoint_band_from_jax, tables_to_torch
from bialign_tpu_torch.ops import checkpoint_dp as ck
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.parallel import Mesh
from bialign_tpu_torch.parallel import seqsplit as TS

CPU = dict(engine="torch", device="cpu")


def _mesh(k: int) -> Mesh:
    return Mesh(["cpu"] * k, ("sp",))


def _jax_mesh(k: int) -> JaxMesh:
    return JaxMesh(np.array(jax.devices()[:k]), ("sp",))


def _tables(mol, params):
    ba = BiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                   mol.get("strB"), **CPU, **params)
    return ba.mu1, ba.mu2, ba


def _costs(ba):
    return ((ba.beta, ba.gamma, ba.delta) if ba._affine
            else (ba.gamma, ba.delta))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_affine_rna_seqsplit(k):
    mu1, mu2, ba = _tables(G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS)
    score = TS.score_seqsplit(mu1, mu2, ba.max_shift, _costs(ba),
                              mesh=_mesh(k), affine=True, engine="torch")
    assert score == G.TOY_RNA_AFFINE_SCORE
    assert score == JS.score_seqsplit(mu1, mu2, ba.max_shift, _costs(ba),
                                      mesh=_jax_mesh(k), affine=True)


@pytest.mark.parametrize("k", [2, 8])
def test_nonaffine_rna_seqsplit(k):
    mu1, mu2, ba = _tables(G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS)
    score = TS.score_seqsplit(mu1, mu2, ba.max_shift, _costs(ba),
                              mesh=_mesh(k), affine=False, engine="torch")
    assert score == G.TOY_RNA_NONAFFINE_SCORE
    assert score == JS.score_seqsplit(mu1, mu2, ba.max_shift, _costs(ba),
                                      mesh=_jax_mesh(k), affine=False)


def test_affine_protein_seqsplit():
    mu1, mu2, ba = _tables(G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS)
    score = TS.score_seqsplit(mu1, mu2, ba.max_shift, _costs(ba),
                              mesh=_mesh(8), affine=True, engine="torch")
    assert score == G.TOY_PROTEIN_SCORE


def test_seqsplit_on_2d_mesh_axis():
    """The "sp" axis of a 2-D (data, sp) mesh: its 4 devices at data 0."""
    mesh = Mesh([["cpu"] * 4] * 2, ("data", "sp"))
    mu1, mu2, ba = _tables(G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS)
    score = TS.score_seqsplit(mu1, mu2, ba.max_shift, _costs(ba), mesh=mesh,
                              axis="sp", affine=True, engine="torch")
    assert score == G.TOY_RNA_AFFINE_SCORE
    band = TS.fill_seqsplit(mu1, mu2, ba.max_shift, _costs(ba), mesh=mesh,
                            axis="sp", engine="torch")
    assert len(band.shards) == 4 and band.final_score() == score


def test_seqsplit_random_vs_oracle():
    """Random integer tables: the split score equals the oracle's."""
    rng = np.random.default_rng(7)
    n, m, S = 11, 13, 1
    mu1 = rng.integers(-300, 300, (n + 1, m + 1)).astype(np.int64)
    mu2 = rng.integers(-300, 300, (n + 1, m + 1)).astype(np.int64)
    beta, gamma, delta = -150, -50, -150
    H = reference_dp.fill_affine(mu1, mu2, S, beta, gamma, delta)
    want = reference_dp.affine_score_from_band(H, n, m, S)
    got = TS.score_seqsplit(mu1, mu2, S, (beta, gamma, delta), mesh=_mesh(8),
                            affine=True, engine="torch")
    assert got == want


@functools.lru_cache(maxsize=None)
def _jax_split(which: str, k: int, block):
    """The JAX BiAligner on the split (engine "xla", its k-device mesh):
    (score, lines)."""
    mol = G.TOY_RNA
    params = (G.TOY_RNA_AFFINE_PARAMS if which == "affine"
              else G.TOY_RNA_NONAFFINE_PARAMS)
    ba = JaxBiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                      mol.get("strB"), engine="xla",
                      seqsplit_mesh=_jax_mesh(k), checkpoint_block=block,
                      **params)
    return ba.optimize(), list(ba.decode_trace())


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("which,params", [
    ("affine", G.TOY_RNA_AFFINE_PARAMS),
    ("nonaffine", G.TOY_RNA_NONAFFINE_PARAMS),
])
def test_seqsplit_traceback_matches_single_device(which, params, k):
    """Score and every decoded line of the split equal the JAX split's, the
    port's single-device low-memory path's and the golden's."""
    mol = G.TOY_RNA
    single = BiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                       mol.get("strB"), lowmem=True, checkpoint_block=8,
                       **CPU, **params)
    want = (single.optimize(), list(single.decode_trace()))
    sharded = BiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                        mol.get("strB"), seqsplit_mesh=_mesh(k),
                        checkpoint_block=8, **CPU, **params)
    got = (sharded.optimize(), list(sharded.decode_trace()))
    assert isinstance(sharded._band, TS.SeqsplitBand)
    assert got == want == _jax_split(which, 8, 8)
    golden = (G.TOY_RNA_AFFINE_DEFAULT_OUT if which == "affine"
              else G.TOY_RNA_NONAFFINE_DEFAULT_OUT)
    assert got[1] == golden


def test_seqsplit_traceback_protein_full_outmode():
    mol, params = G.TOY_PROTEIN, dict(G.TOY_PROTEIN_PARAMS, outmode="full")
    single = JaxBiAligner(mol["seqA"], mol["seqB"], mol["strA"], mol["strB"],
                          engine="xla", **params)
    sharded = BiAligner(mol["seqA"], mol["seqB"], mol["strA"], mol["strB"],
                        seqsplit_mesh=_mesh(8), **CPU, **params)
    assert sharded.optimize() == single.optimize() == G.TOY_PROTEIN_SCORE
    assert list(sharded.decode_trace()) == list(single.decode_trace())


def test_seqsplit_eval_trace_replay():
    """cells() on the split band: the verbose replay equals the JAX split's
    line for line, and ends at the score."""
    mol, params = G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS
    sharded = BiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                        mol.get("strB"), seqsplit_mesh=_mesh(4), **CPU,
                        **params)
    score = sharded.optimize()
    lines = list(sharded.eval_trace())
    ref = JaxBiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                       mol.get("strB"), engine="xla",
                       seqsplit_mesh=_jax_mesh(4), **params)
    ref.optimize()
    assert lines and lines[-1].endswith(str(score))
    assert lines == list(ref.eval_trace())


def _live_rows(n: int, m: int, d: int) -> slice:
    return slice(max(0, d - m), min(n, d) + 1)


def _gathered(band, b: int, x: int) -> torch.Tensor:
    """Checkpoint slab x of block b over all rows, the shards' own rows
    (slots 1..) put together."""
    return torch.cat([c[b, x][..., 1:] for c in band.ckpts], dim=-1)


@pytest.mark.parametrize("which", ["affine", "nonaffine"])
def test_split_checkpoints_equal_the_jax_split(which):
    """A JAX SeqsplitBand from fill_seqsplit on the 8-device mesh, turned
    into the port's by convert.checkpoint_band_from_jax: the port's split
    checkpoints on 8 CPU shards, gathered, equal it on every live row, and
    so do the last slab and every block's window."""
    params = (G.TOY_RNA_AFFINE_PARAMS if which == "affine"
              else G.TOY_RNA_NONAFFINE_PARAMS)
    mu1, mu2, ba = _tables(G.TOY_RNA, params)
    affine, C = which == "affine", 5
    jband = JS.fill_seqsplit(mu1, mu2, ba.max_shift, _costs(ba),
                             mesh=_jax_mesh(8), affine=affine, block=C)
    want = checkpoint_band_from_jax(jband, mu1, mu2)
    got = TS.fill_seqsplit(mu1, mu2, ba.max_shift, _costs(ba), mesh=_mesh(8),
                           affine=affine, block=C, engine="torch")
    n, m = got.n, got.m
    assert got.n_blocks == want.n_blocks and got.block == want.block == C
    for b in range(1, got.n_blocks):
        for x in (0, 1):
            rows = _live_rows(n, m, b * C - 1 - x)
            assert torch.equal(_gathered(got, b, x)[..., rows],
                               want.ckpts[b, x][..., rows]), (b, x)
    assert got.final_score() == want.final_score() == jband.final_score()
    for b in range(got.n_blocks):
        mine, theirs = got._recompute(b), want._recompute(b)
        for x in range(mine.shape[0]):
            d = b * C - 2 + x
            if 0 <= d <= n + m:
                rows = _live_rows(n, m, d)
                assert torch.equal(mine[x][..., rows],
                                   theirs[x][..., rows]), (b, x)


def _rand(n: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    mu1 = np.zeros((n + 1, m + 1), np.int32)
    mu2 = np.zeros_like(mu1)
    mu1[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    mu2[1:, 1:] = rng.integers(-4, 9, size=(n, m)) * 100
    return mu1, mu2


# (n, m, max_shift, row ranges): a shard of one row first, in the middle and
# last; a sequence of length 0
ROW_CASES = [(9, 11, 1, [(0, 0), (1, 5), (6, 9)]),
             (9, 11, 2, [(0, 4), (5, 5), (6, 9)]),
             (7, 5, 0, [(0, 6), (7, 7)]),
             (0, 6, 1, [(0, 0)]),
             (6, 0, 1, [(0, 2), (3, 6)])]


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "nonaffine"])
@pytest.mark.parametrize("n,m,S,rows", ROW_CASES)
def test_twins_on_uneven_shards_equal_one_device(n, m, S, rows, affine):
    """The split twins on shards of one row and of several: the last slab's
    score, every checkpoint and every block's window equal the single-device
    checkpointed twins' on their live rows."""
    mu1, mu2 = _rand(n, m, 10 * n + m + S)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    params = (-150, -50, -150) if affine else (-200, -250)
    C = 3
    one = (ck.fill_affine_checkpoint_plain if affine
           else ck.fill_nonaffine_checkpoint_plain)(t1, t2, S, *params,
                                                    block=C)
    shards = TS.make_shards(mu1, mu2, ["cpu"] * len(rows), rows=rows)
    rings = TS.seqsplit_last_slabs_plain(shards, S, params, affine)
    assert TS._score_of(shards, rings, n, m, S, affine) == one.final_score()
    rings, ckpts = TS.seqsplit_checkpoints_plain(shards, S, params, affine, C)
    band = TS.SeqsplitBand(
        ckpts=tuple(ckpts), final=tuple(r[(n + m) % 3] for r in rings),
        mu1=shards[0].mu1, mu2=shards[0].mu2, n=n, m=m, max_shift=S,
        affine=affine, params=params, block=C, shards=shards, engine="torch")
    for b in range(one.n_blocks):
        for x in (0, 1):
            live = _live_rows(n, m, b * C - 1 - x)
            if b and live.start < live.stop:
                assert torch.equal(_gathered(band, b, x)[..., live],
                                   one.ckpts[b, x][..., live])
        mine, theirs = band._recompute(b), one._recompute(b)
        for x in range(mine.shape[0]):
            d = b * C - 2 + x
            if 0 <= d <= n + m:
                live = _live_rows(n, m, d)
                assert torch.equal(mine[x][..., live], theirs[x][..., live])
    assert band.final_score() == one.final_score()
    trace = (ck.affine_traceback(band, *params)[0] if affine
             else ck.nonaffine_traceback(band, *params))
    want = (ck.affine_traceback(one, *params)[0] if affine
            else ck.nonaffine_traceback(one, *params))
    assert trace == want


def test_more_devices_than_rows_and_refusals():
    """Devices given no row hold no shard; a CPU mesh refuses the CUDA
    engine; a mesh must be a Mesh; the block functions of one device refuse
    a split band."""
    mu1, mu2 = _rand(2, 5, 1)
    params = (-150, -50, -150)
    score = TS.score_seqsplit(mu1, mu2, 1, params, mesh=_mesh(6),
                              engine="torch")
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    assert score == cuda_dp.affine_score_plain(t1, t2, 1, *params)
    band = TS.fill_seqsplit(mu1, mu2, 1, params, mesh=_mesh(6),
                            engine="torch")
    assert len(band.shards) == 3
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.score_seqsplit(mu1, mu2, 1, params, mesh=_mesh(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.fill_seqsplit(mu1, mu2, 1, params, mesh=_mesh(2))
    with pytest.raises(TypeError, match="Mesh"):
        TS.score_seqsplit(mu1, mu2, 1, params, mesh=object(), engine="torch")
    with pytest.raises(ValueError, match="axes"):
        TS.score_seqsplit(mu1, mu2, 1, params,
                          mesh=Mesh(["cpu"] * 2, ("data",)), engine="torch")
    with pytest.raises(TypeError, match="sharded"):
        ck.affine_block(band, 0)


# -- the kernels' routes -----------------------------------------------------

def _fake_shards(devices) -> tuple:
    """Shards of a 5-row pair on ``devices`` (names only: the tables stay
    on the CPU), a row each but the last."""
    mu1, mu2 = (torch.zeros(6, 4, dtype=torch.int32),) * 2
    rows = [(k, k) for k in range(len(devices) - 1)] + [(len(devices) - 1, 5)]
    return tuple(TS.Shard(torch.device(d), a, b, mu1, mu2)
                 for d, (a, b) in zip(devices, rows))


@pytest.mark.parametrize("devices,peer,want", [
    (["cpu"] * 3, None, "resident"),
    (["cuda:0"] * 4, None, "resident"),
    (["cuda:0", "cuda:1", "cuda:0"], True, "resident"),
    (["cuda:0", "cuda:1", "cuda:1"], False, "streams"),
    (["cuda:0", "cpu"], True, "streams"),
])
def test_split_route(monkeypatch, devices, peer, want):
    """"resident" where every two neighbouring shards share a device or
    reach each other's memory, else "streams"; a forced "resident" that
    cannot run raises, a forced "streams" runs anywhere."""
    asked = []

    def can(a, b):
        asked.append((a, b))
        return peer
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", can)
    shards = _fake_shards(devices)
    assert TS.split_route(shards) == want
    if peer is None:
        assert not asked           # one device: no peer question
    assert TS._route(shards, None) == want
    assert TS._route(shards, "streams") == "streams"
    if want == "resident":
        assert TS._route(shards, "resident", rows=3) == "resident"
    else:
        with pytest.raises(ValueError, match="cannot run"):
            TS._route(shards, "resident")


def test_forced_routes_and_their_refusals():
    """More shards than route "resident" takes: "streams"; a forced
    "resident" raises, through score_seqsplit too, and the twins give the
    one-device score on either route; rows= only with "resident"; an
    unknown route raises."""
    n = TS.RESIDENT_MAX_SHARDS + 3
    mu1, mu2 = _rand(n, 5, 3)
    params = (-150, -50, -150)
    t1, t2 = tables_to_torch(mu1, mu2, "cpu")
    want = cuda_dp.affine_score_plain(t1, t2, 1, *params)
    many = _mesh(TS.RESIDENT_MAX_SHARDS + 1)
    shards = TS.make_shards(mu1, mu2, many.along("sp"))
    assert TS.split_route(shards) == "streams"
    with pytest.raises(ValueError, match="cannot run"):
        TS.score_seqsplit(mu1, mu2, 1, params, mesh=many, engine="torch",
                          route="resident")
    for route in (None, "streams"):
        assert TS.score_seqsplit(mu1, mu2, 1, params, mesh=many,
                                 engine="torch", route=route) == want
    for route in ("resident", "streams"):
        assert TS.score_seqsplit(mu1, mu2, 1, params, mesh=_mesh(3),
                                 engine="torch", route=route) == want
    few = TS.make_shards(mu1, mu2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="rows"):
        TS.seqsplit_last_slabs(few, 1, params, True, route="streams", rows=8)
    with pytest.raises(ValueError, match="rows"):
        TS.seqsplit_last_slabs(few, 1, params, True, rows=0)
    with pytest.raises(ValueError, match="route must be"):
        TS.seqsplit_checkpoints(few, 1, params, True, 4, route="graphs")


@pytest.mark.parametrize("route", [None, "streams"])
def test_the_band_keeps_its_route(route):
    """BiAligner(seqsplit_route=) and fill_seqsplit(route=): the band
    records the route its blocks are refilled on; the result is the same."""
    mol = G.TOY_RNA
    ba = BiAligner(mol["seqA"], mol["seqB"], mol.get("strA"),
                   mol.get("strB"), seqsplit_mesh=_mesh(3),
                   seqsplit_route=route, **CPU, **G.TOY_RNA_AFFINE_PARAMS)
    assert ba.optimize() == G.TOY_RNA_AFFINE_SCORE
    assert ba._band.route == (route or "resident")
    assert list(ba.decode_trace()) == G.TOY_RNA_AFFINE_DEFAULT_OUT
