"""Data parallelism over a mesh (``mesh=``) in the port, through the plain
twins on CPU meshes (``engine="torch"``, ``Mesh(["cpu"] * k, ("data",))``):
the mesh cases of tests/test_batch.py equal the JAX package on its 8-device
CPU mesh (tests/conftest.py) and the port on one device; the codes
dispatches, a stream with a spool, meshes larger than a bucket, and the
refusals.  Scores, traces, flags and spool records are ints, compared for
equality."""

import functools
import json

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from bialign_tpu.parallel import batch as JB
from test_batch import SIZES, _rand_pair
from test_torch_driver import _records

from bialign_tpu_torch.parallel import Mesh
from bialign_tpu_torch.parallel import batch as TB
from bialign_tpu_torch.parallel import driver as TD
from bialign_tpu_torch.scoring.tables import _sim_lut

CPU = dict(engine="torch", device="cpu")
AFFINE, NONAFFINE = (-150, -50, -150), (-200, -250)
# the mesh cases of tests/test_batch.py: (max_shift, costs, affine, the
# JAX engine); the PreparedBatch and align_batch cases run affine at 1
SCORE_CASES = {"affine_xla": (1, AFFINE, True, "xla"),
               "affine_pallas": (1, AFFINE, True, "pallas"),
               "nonaffine_pallas": (2, NONAFFINE, False, "pallas")}
QUANTUM = 16                     # tests/test_batch.py's meshes bucket by 16
KS = [2, 3, 8]
PROTEIN = dict(type="Protein", structure_weight=800, simmatrix="BLOSUM62",
               gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
               max_shift=1)


def _mesh(k: int) -> Mesh:
    return Mesh(["cpu"] * k, ("data",))


def _jax_mesh() -> JaxMesh:
    devices = np.array(jax.devices())
    assert len(devices) == 8, "conftest should provide 8 virtual devices"
    return JaxMesh(devices, ("data",))


@functools.lru_cache(maxsize=None)
def _pairs():
    rng = np.random.default_rng(42)               # tests/test_batch.py's
    return tuple(_rand_pair(rng, n, m) for n, m in SIZES)


@functools.lru_cache(maxsize=None)
def _jax_scores(case: str):
    S, costs, affine, engine = SCORE_CASES[case]
    return JB.score_batch(list(_pairs()), S, costs, affine=affine,
                          mesh=_jax_mesh(), bucket_quantum=QUANTUM,
                          engine=engine)


@functools.lru_cache(maxsize=None)
def _jax_alignments():
    return JB.align_batch(list(_pairs()), 1, AFFINE, affine=True,
                          mesh=_jax_mesh(), bucket_quantum=QUANTUM)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", SCORE_CASES)
def test_sharded_scores_equal_jax_and_one_device(case, k):
    """tests/test_batch.py:61, :85, :111: score_batch over a mesh."""
    S, costs, affine, _engine = SCORE_CASES[case]
    pairs = list(_pairs())
    got = TB.score_batch(pairs, S, costs, affine=affine, mesh=_mesh(k),
                         bucket_quantum=QUANTUM, engine="torch")
    one = TB.score_batch(pairs, S, costs, affine=affine,
                         bucket_quantum=QUANTUM, **CPU)
    assert got.dtype == np.int64
    assert (got == one).all()
    assert (got == np.asarray(_jax_scores(case))).all()


@pytest.mark.parametrize("k", KS)
def test_prepared_batch_sharded(k):
    """tests/test_batch.py:246: a PreparedBatch resident on a mesh."""
    pairs = list(_pairs())
    prep = TB.PreparedBatch(pairs, 1, AFFINE, affine=True, mesh=_mesh(k),
                            bucket_quantum=QUANTUM, engine="torch")
    want = np.asarray(_jax_scores("affine_xla"))
    assert (prep.scores() == want).all()
    assert (TB.score_batch(prep, 1, AFFINE, affine=True, mesh=_mesh(k),
                           engine="torch") == want).all()
    # one shard a device for each bucket, no empty one
    shards = [places for *_rest, places in prep._buckets]
    assert len(shards) == sum(min(k, len(b.indices)) for b in
                              TB.make_buckets_dense(pairs, QUANTUM).values())


@pytest.mark.parametrize("k,chunk", [(2, None), (3, 1), (8, None)])
def test_align_batch_sharded_bit_exact(k, chunk):
    """tests/test_batch.py:256: traces and complete flags over a mesh, each
    device chunking its own shard."""
    pairs = list(_pairs())
    got = TB.align_batch(pairs, 1, AFFINE, affine=True, mesh=_mesh(k),
                         bucket_quantum=QUANTUM, chunk=chunk, engine="torch")
    one = TB.align_batch(pairs, 1, AFFINE, affine=True,
                         bucket_quantum=QUANTUM, **CPU)
    want = _jax_alignments()
    for a, b in ((got, one), (got, want)):
        assert (np.asarray(a[0]) == np.asarray(b[0])).all()
        assert [list(map(tuple, t)) for t in a[1]] == \
            [list(map(tuple, t)) for t in b[1]]
        assert list(a[2]) == list(b[2])


def _protein_pairs(count: int, seed: int):
    rng = np.random.default_rng(seed)
    base = "RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR"
    out = []
    for _ in range(count):
        a, b = rng.integers(5, 20, size=2)
        i, j = rng.integers(0, len(base) - 20, size=2)
        seqA, seqB = base[i:i + a], base[j:j + b]
        strA = "".join(rng.choice(list("HCE"), size=len(seqA)))
        strB = "".join(rng.choice(list("HCE"), size=len(seqB)))
        out.append((seqA, seqB, strA, strB))
    return out


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "nonaffine"])
def test_codes_dispatches_over_a_mesh(affine, k):
    """dispatch_score_batch_codes and dispatch_align_batch_codes over a
    mesh equal one device and the JAX codes path on its mesh; the table
    goes up once a device."""
    recs = _protein_pairs(12, 5 + k)
    costs = AFFINE if affine else NONAFFINE
    lut = _sim_lut("BLOSUM62")[0]
    kw = dict(affine=affine, lut=lut, structure_weight=800, bucket_quantum=8)
    pairs = [TB.encode_pair(*r) for r in recs]
    scores = TB.dispatch_score_batch_codes(pairs, 1, costs, mesh=_mesh(k),
                                           engine="torch", **kw).get()
    assert (scores == TB.dispatch_score_batch_codes(pairs, 1, costs, **kw,
                                                    **CPU).get()).all()
    jpairs = [JB.encode_pair(*r) for r in recs]
    assert (scores == np.asarray(JB.dispatch_score_batch_codes(
        jpairs, 1, costs, mesh=_jax_mesh(), **kw).get())).all()
    got = TB.dispatch_align_batch_codes(pairs, 1, costs, mesh=_mesh(k),
                                        chunk=2, engine="torch", **kw).get()
    one = TB.dispatch_align_batch_codes(pairs, 1, costs, **kw, **CPU).get()
    assert (got[0] == one[0]).all() and (got[0] == scores).all()
    assert got[1] == one[1] and got[2] == one[2]


def test_codes_table_goes_to_each_device_once():
    """A table on one device of the mesh is used there and copied to each
    other one; a table on no device of the call is refused."""
    import torch

    lut = torch.from_numpy(np.ascontiguousarray(_sim_lut("BLOSUM62")[0],
                                                np.int32))
    cpu, other = torch.device("cpu"), torch.device("meta")
    assert TB._device_lut(lut, cpu, [cpu, other]) is lut
    copy = TB._device_lut(lut, other, [cpu, other])
    assert copy.device == other and copy.shape == lut.shape
    with pytest.raises(ValueError, match="lut lies on"):
        TB._device_lut(lut, other, [other])


def test_streaming_aligner_over_a_mesh_equals_one_device(tmp_path):
    """StreamingAligner(mesh=) with a spool: the same records, yields and
    spool lines as the run without, scores and alignments, tables and
    codes."""
    for alignments in (False, True):
        for codes in (False, True):
            runs = []
            for mesh in (None, _mesh(3)):
                spool = tmp_path / f"{alignments}_{codes}_{mesh is None}.jsonl"
                sa = TD.StreamingAligner(PROTEIN, mesh=mesh, chunk_pairs=4,
                                         bucket_quantum=8,
                                         alignments=alignments, codes=codes,
                                         spool_path=str(spool), **CPU)
                out = list(sa.run(_records(TD, 9)))
                sa.spool.close()
                runs.append((out, [json.loads(ln) for ln in
                                   spool.read_text().splitlines()]))
            assert runs[0] == runs[1], (alignments, codes)
            assert len(runs[0][1]) == 9


@pytest.mark.parametrize("k", [9, 20])
def test_mesh_larger_than_a_bucket(k):
    """More devices than a bucket has pairs: the empty shards are skipped
    and every pair is scored and aligned once, in input order."""
    pairs = list(_pairs())[:5]
    one = TB.score_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=8,
                         **CPU)
    got = TB.score_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=8,
                         mesh=_mesh(k), engine="torch")
    assert (got == one).all()
    scores, traces, complete = TB.align_batch(
        pairs, 1, AFFINE, affine=True, bucket_quantum=8, mesh=_mesh(k),
        engine="torch")
    want = TB.align_batch(pairs, 1, AFFINE, affine=True, bucket_quantum=8,
                          **CPU)
    assert (scores == one).all() and traces == want[1]
    assert complete == want[2]
    assert TB.score_batch([], 1, AFFINE, affine=True, mesh=_mesh(k),
                          engine="torch").shape == (0,)


def test_prepared_batch_refuses_another_mesh():
    pairs = list(_pairs())
    prep = TB.PreparedBatch(pairs, 1, AFFINE, affine=True, mesh=_mesh(4),
                            bucket_quantum=QUANTUM, engine="torch")
    prep.check_compatible(1, AFFINE, True, _mesh(4), engine="torch")
    for mesh in (None, _mesh(2), Mesh(["cpu"] * 4, ("sp",))):
        with pytest.raises(ValueError, match="mesh"):
            TB.score_batch(prep, 1, AFFINE, affine=True, mesh=mesh,
                           engine="torch", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        prep.check_compatible(1, AFFINE, True, _mesh(4), engine="cuda")


def test_cuda_engine_on_a_cpu_mesh_raises():
    pairs = list(_pairs())[:2]
    codes = [TB.encode_pair("ACD", "AC", "HHC", "HC")]
    lut = TB.match_mismatch_lut(100, 0)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.score_batch(pairs, 1, AFFINE, affine=True, mesh=_mesh(2))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.align_batch(pairs, 1, AFFINE, affine=True, mesh=_mesh(2),
                       engine="cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.PreparedBatch(pairs, 1, AFFINE, affine=True, mesh=_mesh(2))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TB.dispatch_score_batch_codes(codes, 1, AFFINE, affine=True, lut=lut,
                                      structure_weight=800, mesh=_mesh(2))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TD.StreamingAligner(PROTEIN, mesh=_mesh(2))
    with pytest.raises(ValueError, match="axes"):
        TB.score_batch(pairs, 1, AFFINE, affine=True,
                       mesh=Mesh(["cpu"] * 2, ("sp",)), engine="torch")


def test_mesh_of_two_axes():
    """A (data, sp) mesh: the batch runs over the devices of "data" (those
    at index 0 of "sp"); the shape reads as JAX's does."""
    mesh = Mesh([["cpu"] * 4] * 2, ("data", "sp"))
    assert mesh.shape == {"data": 2, "sp": 4}
    assert len(mesh.along("data")) == 2 and len(mesh.along("sp")) == 4
    pairs = list(_pairs())
    got = TB.score_batch(pairs, 1, AFFINE, affine=True, mesh=mesh,
                         bucket_quantum=QUANTUM, engine="torch")
    assert (got == np.asarray(_jax_scores("affine_xla"))).all()
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 2, ("data", "sp"))
    with pytest.raises(ValueError):
        Mesh([[["cpu"]]], ("a", "b", "c"))
